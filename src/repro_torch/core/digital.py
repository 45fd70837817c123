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

    def rates(self) -> np.ndarray:
        """R_m = log2(1 + E_s rho_m^2/N0) [bits/s/Hz] (eq. (17c))."""
        snr = self.energy_per_symbol * self.rhos ** 2 / self.noise_psd
        return np.log2(1.0 + snr)

    def payloads(self) -> np.ndarray:
        return np.array([payload_bits(self.dim, int(r)) for r in self.r_bits],
                        dtype=np.float64)


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
    latency = torch.zeros(chi.shape[:-1], dtype=chi.dtype, device=dev)
    for m in range(chi.shape[-1]):
        latency = latency + chi[..., m] * lat_m[m]
    return acc, chi, latency
