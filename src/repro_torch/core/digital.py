"""Biased digital (TDMA + quantized) FL aggregation — Sec. II-B of the paper.

Counterpart of ``repro.core.digital`` (uplink model eq. (9)-(12)):
    chi^D_{m,t} = 1{ |h_{m,t}| >= rho_m }                         (eq. (9))
    ghat_t      = sum_m chi^D_{m,t} Q(g_{m,t}; r_m) / nu_m         (eq. (10))
with the dithered quantizer Q of ``kernels/csrc/dithered_quant.cu`` and the
TDMA round latency sum_m chi^D L_m / (B R_m),
R_m = log2(1 + E_s rho_m^2 / N0), L_m = 64 + d r_m bits.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels import ops
from .quantize import payload_bits


def outage_mask(habs: torch.Tensor, thr):
    """The threshold rule 1{ |h| >= thr }."""
    return habs >= torch.as_tensor(thr, dtype=habs.dtype, device=habs.device)


@dataclasses.dataclass(frozen=True)
class DigitalParams:
    """Offline-designed digital-FL parameters (time-invariant)."""

    rhos: np.ndarray            # (N,) participation thresholds rho_m
    nus: np.ndarray             # (N,) PS post-scalers nu_m
    r_bits: np.ndarray          # (N,) quantization bits r_m (ints >= 1)
    g_max: float
    dim: int
    energy_per_symbol: float
    noise_psd: float
    bandwidth_hz: float

    def betas(self, lambdas: np.ndarray) -> np.ndarray:
        """beta_m = exp(-rho_m^2 / Lambda_m)."""
        return np.exp(-(self.rhos ** 2) / np.asarray(lambdas))

    def participation_levels(self, lambdas: np.ndarray) -> np.ndarray:
        """p_m = beta_m / nu_m."""
        return self.betas(lambdas) / self.nus

    def rates(self) -> np.ndarray:
        """R_m = log2(1 + E_s rho_m^2/N0) [bits/s/Hz] (eq. (17c))."""
        snr = self.energy_per_symbol * self.rhos ** 2 / self.noise_psd
        return np.log2(1.0 + snr)

    def payloads(self) -> np.ndarray:
        return np.array([payload_bits(self.dim, int(r)) for r in self.r_bits],
                        dtype=np.float64)

    def expected_latency(self, lambdas: np.ndarray) -> float:
        """Expected per-round uplink latency (eq. (12)) [s]."""
        rates = np.maximum(self.rates(), 1e-12)
        return float(np.sum(self.betas(lambdas) * self.payloads()
                            / (self.bandwidth_hz * rates)))


def digital_round(params: DigitalParams, grads: torch.Tensor,
                  habs: torch.Tensor, u: torch.Tensor, *,
                  use_kernel: bool = True):
    """One digital-FL uplink round, batched over leading (trial) dimensions.

    Mirrors ``repro.core.digital.digital_round_jax``: every device's
    gradient is quantized in one launch (rows with chi = 0 carry weight 0),
    then the 1/nu-weighted sum. At d >= 2^17 with r_max <= 16 bits that is
    the fused route: pack into codes, then the packed weighted sum, the
    devices added in index order. The route follows the payload and not
    ``use_kernel``, so ``use_kernel=False`` runs the same arithmetic in
    plain PyTorch (the sequential oracle on the fused route) and gives the
    kernel run's trajectory to the bit.

    Args:
      grads: (..., N, d) local gradients.
      habs:  (..., N) fading magnitudes |h_{m,t}|.
      u:     (..., N, d) f32 dither uniforms, one row per device.

    Returns:
      (ghat (..., d), chi (..., N), latency_s (...,)).
    """
    dev = grads.device
    chi = outage_mask(habs, params.rhos).to(grads.dtype)
    rates = np.maximum(params.rates(), 1e-12)
    lat_m = torch.as_tensor(params.payloads() / (params.bandwidth_hz * rates),
                            device=dev)
    levels = torch.as_tensor(2.0 ** params.r_bits.astype(np.float64) - 1.0,
                             device=dev).expand(chi.shape)
    r_max = int(np.max(params.r_bits))
    acc = ops.quantized_weighted_sum(
        grads, levels, u, chi / torch.as_tensor(params.nus, device=dev),
        r_max=r_max, use_kernel=use_kernel,
        fused=ops.fused_route(r_max, grads.shape[-1]))
    # devices add in index order, as the reference's TDMA loop does: the
    # wall-clock a time budget compares against is then the reference's
    # to the last bit (chi is 0/1, so every product is exact)
    return acc, chi, sum_in_order(chi * lat_m)


# ------------------------------------------- selection primitives (Sec. V)
#
# The digital baselines are built from three pieces, counterparts of
# ``repro/core/digital.py:181-266``: capacity rates, top-K selection as a
# 0/1 mask, and FedTOE's greedy bit allocation (host NumPy: its inputs are
# the replayed selection draws and static rates, all host data).

#: The f64 constant ``jnp.log2`` multiplies ``log`` by (XLA lowers
#: log2(x) to log(x) * (1 / ln 2)).
INV_LN2 = 1.4426950408889634


def capacity_rate(habs: torch.Tensor, e_s: float, n0: float) -> torch.Tensor:
    """Instantaneous spectral efficiency log2(1 + E_s |h|^2 / N0) [b/s/Hz],
    computed as the reference's lowering computes it: |h|^2 as a product,
    log2 as log times 1/ln 2. The log itself may differ from XLA's in the
    last bit."""
    return torch.log(1.0 + e_s * (habs * habs) / n0) * INV_LN2


def topk_mask(score: torch.Tensor, k: int) -> torch.Tensor:
    """0/1 mask (score's dtype) of the k highest scores along the last
    axis: a stable ascending argsort reversed, as the reference's
    ``jnp.argsort(score)[::-1][:k]`` (ties go to the higher index)."""
    order = torch.argsort(score, dim=-1, stable=True).flip(-1)
    return torch.zeros_like(score).scatter(-1, order[..., :k], 1.0)


def sum_in_order(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, entries added in index order from 0, as
    XLA's CPU reduce adds up to 32 of them (ROADMAP Queue 3): a scheme's
    TDMA latency then matches the reference's bit for bit."""
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for m in range(x.shape[-1]):
        acc = acc + x[..., m]
    return acc


def greedy_bit_alloc(sel: np.ndarray, rates: np.ndarray, *, dim: int,
                     bandwidth_hz: float, t_budget_s: float, r_max: int):
    """FedTOE's greedy RB/bit allocation for one round, host NumPy f64,
    op for op as ``repro.core.digital.greedy_bit_alloc_jax``: walk the
    scheduled set in decreasing-rate order (stable) giving each device one
    bit while its minimum payload fits the round budget, then grant +1 bit
    to the device with the best variance-reduction-per-latency gain (first
    maximum) until the budget or ``r_max`` stops it. Latency sums add the
    devices in index order.

    Args:
      sel:   (k,) int device indices scheduled this round.
      rates: (N,) static per-device spectral efficiencies R_m.

    Returns:
      (bits, in_alloc): (N,) f64 bit-widths (0 outside the allocation) and
      the 0/1 allocation mask.
    """
    n = rates.shape[0]
    rates = np.asarray(rates, np.float64)
    safe_rates = np.maximum(rates, 1e-9)
    sel = np.asarray(sel, np.int64)
    sel_sorted = sel[np.argsort(-rates[sel], kind="stable")]
    t_one = (64.0 + dim) / (bandwidth_hz * safe_rates[sel_sorted])
    in_alloc = np.zeros(n)
    used = 0.0
    for m, t1 in zip(sel_sorted, t_one):
        fits = used + t1 <= t_budget_s
        used = used + (t1 if fits else 0.0)
        in_alloc[m] += float(fits)
    per_bit_s = dim / (bandwidth_hz * safe_rates)
    bits = in_alloc.copy()
    done = bool(np.sum(in_alloc) == 0)
    while not done:
        eligible = (in_alloc > 0) & (bits < r_max)
        b_safe = np.where(in_alloc > 0, bits, 1.0)
        dv = (1.0 / (2.0 ** b_safe - 1.0) ** 2
              - 1.0 / (2.0 ** (b_safe + 1.0) - 1.0) ** 2)
        gain = np.where(eligible, dv / per_bit_s, 0.0)
        best = int(np.argmax(gain))
        bits_new = bits.copy()
        bits_new[best] += 1.0
        accept = gain[best] > 0.0 and alloc_latency(
            bits_new, in_alloc, rates, dim=dim,
            bandwidth_hz=bandwidth_hz) <= t_budget_s
        if accept:
            bits = bits_new
        done = not accept
    return bits, in_alloc


def alloc_latency(bits: np.ndarray, in_alloc: np.ndarray, rates: np.ndarray,
                  *, dim: int, bandwidth_hz: float) -> float:
    """TDMA time of an allocation at static rates (host NumPy f64):
    sum_m in_alloc_m (64 + d bits_m) / (B max(R_m, 1e-9)), devices added in
    index order."""
    terms = (in_alloc * (64.0 + dim * bits)
             / (bandwidth_hz * np.maximum(rates, 1e-9)))
    total = 0.0
    for v in terms:
        total = total + v
    return total
