"""Biased over-the-air (OTA) FL aggregation — Sec. II-A of the paper.

Counterpart of ``repro.core.ota`` (uplink model eq. (3)-(6)):
    chi^A  = 1{ |h_{m,t}| >= G_max * gamma_m / sqrt(d E_s) }   (eq. (5))
    ghat_t = (sum_m chi^A gamma_m g_{m,t} + z_t) / alpha        (eq. (6))
with alpha_m(gamma_m) = gamma_m exp(-gamma_m^2 G^2 / (d Lambda_m E_s)).
The PS epilogue runs through the CUDA kernel ``kernels/csrc/ota_combine.cu``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..kernels import ops
from .channel import participation_probability


@dataclasses.dataclass(frozen=True)
class OTAParams:
    """Offline-designed OTA-FL parameters (time-invariant during training)."""

    gammas: np.ndarray          # (N,) device pre-scalers gamma_m >= 0
    alpha: float                # PS post-scaler
    g_max: float                # gradient norm bound G_max (Assumption 1)
    dim: int                    # model dimension d
    energy_per_symbol: float    # E_s
    noise_psd: float            # N0

    def thresholds(self) -> np.ndarray:
        """Participation thresholds tau_m = G_max*gamma_m/sqrt(d E_s)."""
        return self.g_max * self.gammas / np.sqrt(
            self.dim * self.energy_per_symbol)

    def alpha_m(self, lambdas: np.ndarray) -> np.ndarray:
        """alpha_m = gamma_m * exp(-gamma_m^2 G^2/(d Lambda_m E_s))."""
        ex = -(self.gammas ** 2) * self.g_max ** 2 / (
            self.dim * np.asarray(lambdas) * self.energy_per_symbol)
        return self.gammas * np.exp(ex)

    def participation_levels(self, lambdas: np.ndarray) -> np.ndarray:
        """p_m = alpha_m / alpha."""
        return self.alpha_m(lambdas) / self.alpha


def alpha_m_max(lambdas: np.ndarray, dim: int, e_s: float,
                g_max: float) -> np.ndarray:
    """max_gamma alpha_m(gamma) = sqrt(d Lambda E_s / (2 e G^2)) (Sec. IV-A)."""
    return np.sqrt(np.asarray(lambdas) * dim * e_s / (2.0 * np.e * g_max ** 2))


def gamma_m_max(lambdas: np.ndarray, dim: int, e_s: float,
                g_max: float) -> np.ndarray:
    """argmax_gamma alpha_m(gamma) = sqrt(d Lambda E_s / (2 G^2)) (Sec. IV-A)."""
    return np.sqrt(np.asarray(lambdas) * dim * e_s / (2.0 * g_max ** 2))


def lemma1_variance(params: OTAParams, lambdas: np.ndarray,
                    sigma_sq: Optional[np.ndarray] = None) -> dict:
    """Lemma 1 variance bound, decomposed into its three terms (host
    NumPy, as ``repro.core.ota.lemma1_variance``)."""
    a_m = params.alpha_m(lambdas)
    p = a_m / params.alpha
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(a_m > 0, params.gammas / a_m, 1.0)
    transmission = float(np.sum(p ** 2 * params.g_max ** 2 * (ratio - 1.0)))
    minibatch = (0.0 if sigma_sq is None
                 else float(np.sum(p ** 2 * np.asarray(sigma_sq))))
    noise = float(params.dim * params.noise_psd / params.alpha ** 2)
    return {
        "transmission": transmission,
        "minibatch": minibatch,
        "noise": noise,
        "total": transmission + minibatch + noise,
    }


def ota_round(params: OTAParams, grads: torch.Tensor, habs: torch.Tensor,
              z01: torch.Tensor, *, use_kernel: bool = True):
    """One OTA-FL uplink round, batched over leading (trial) dimensions.

    Mirrors ``repro.core.ota.ota_round_jax``. The PS compares only channel
    magnitudes, so the round takes |h| (computed once on the host).

    Args:
      grads: (..., N, d) local gradients.
      habs:  (..., N) fading magnitudes |h_{m,t}|.
      z01:   (..., d) standard-normal AWGN draws, scaled by sqrt(N0) here.

    Returns:
      (ghat (..., d), chi (..., N)): PS estimate and participation.
    """
    taus = torch.as_tensor(params.thresholds(), device=grads.device)
    chi = (habs >= taus).to(grads.dtype)
    weights = chi * torch.as_tensor(params.gammas, dtype=grads.dtype,
                                    device=grads.device)
    acc = (weights.unsqueeze(-2) @ grads).squeeze(-2)
    z = float(np.sqrt(params.noise_psd)) * z01
    ghat = ops.ota_combine_with_noise(acc, params.alpha, z,
                                      use_kernel=use_kernel)
    return ghat, chi


def geomspace(start: torch.Tensor, stop: torch.Tensor,
              num: int) -> torch.Tensor:
    """``jnp.geomspace(start, stop, num)`` for positive bounds, batched:
    (...,) -> (..., num). Built as JAX builds it: lin = a (1 - s) + b s
    with a, b = log10 of the bounds and s = j/(num - 1), the last point b
    itself, then 10 ** lin. torch's log10 and pow may differ from XLA's in
    the last bits."""
    a = torch.log10(start)[..., None]
    b = torch.log10(stop)[..., None]
    s = torch.arange(num - 1, dtype=start.dtype,
                     device=start.device) / (num - 1)
    lin = torch.cat([a * (1 - s) + b * s, b], dim=-1)
    return torch.pow(10.0, lin)


def opc_ota_comp_eta(habs: torch.Tensor, *, dim: int, g_max: float,
                     e_s: float, n0: float, n_grid: int) -> torch.Tensor:
    """[19] OPC OTA-Comp's per-round PS scale eta (``repro/fl/engine.py:
    223-241``), batched: habs (..., N) -> (...,). The MSE proxy
    G^2 sum_m (c_m - 1)^2 / N^2 + d N0 / (N^2 eta), with
    c_m = min(b_bar, sqrt(eta)/|h_m|) |h_m| / sqrt(eta), is scored on an
    n_grid-point geometric grid from (b_bar min|h|)^2 1e-4 to
    (b_bar max|h|)^2 1e4; the first minimizer wins."""
    n = habs.shape[-1]
    b_bar = float(np.sqrt(dim * e_s) / g_max)
    lo = b_bar * habs.amin(-1)
    hi = b_bar * habs.amax(-1)
    # squares as products, as XLA lowers x ** 2
    etas = geomspace(torch.clamp(lo * lo * 1e-4, min=1e-300), hi * hi * 1e4,
                     n_grid)                                # (..., n_grid)
    root = torch.sqrt(etas)[..., None]
    b = torch.clamp(root / habs[..., None, :], max=b_bar)   # (..., G, N)
    c1 = b * habs[..., None, :] / root - 1.0
    mses = (g_max ** 2 * (c1 * c1).sum(-1) / n ** 2
            + dim * n0 / (n ** 2 * etas))
    return etas.gather(-1, torch.argmin(mses, -1, keepdim=True))[..., 0]


def opc_ota_fl_round(grads: torch.Tensor, habs: torch.Tensor,
                     z01: torch.Tensor, *, dim: int, g_max: float,
                     e_s: float, n0: float, use_kernel: bool = True):
    """[20] genie-aided OPC OTA-FL round, batched over leading (trial)
    dimensions; mirrors ``repro.core.ota.opc_ota_fl_round_jax``.

    Every include-the-k-strongest candidate k = 1..N is scored at once by
    the bias/noise proxy (1 - k/N)^2 G^2 + d N0 / (k gamma_k)^2; the first
    minimizer wins (the reference's argmin). Devices are ranked by a stable
    ascending argsort, reversed, as ``jnp.argsort(habs)[::-1]``.

    Args: grads (..., N, d); habs (..., N); z01 (..., d).
    Returns: (ghat (..., d), chi (..., N)).
    """
    n = habs.shape[-1]
    order = torch.argsort(habs, dim=-1, stable=True).flip(-1)
    habs_desc = habs.gather(-1, order)
    ks = torch.arange(1, n + 1, dtype=torch.float64, device=habs.device)
    gammas = float(np.sqrt(dim * e_s)) * habs_desc / g_max
    # squares as products, as XLA lowers x ** 2
    short = 1.0 - ks / n
    kg = ks * gammas
    scores = g_max ** 2 * (short * short) + dim * n0 / (kg * kg)
    kidx = torch.argmin(scores, dim=-1, keepdim=True)    # first minimum
    k = (kidx + 1).to(torch.float64)
    gamma = gammas.gather(-1, kidx)
    ranked = (torch.arange(n, device=habs.device) <= kidx).to(grads.dtype)
    chi = torch.zeros_like(ranked).scatter(-1, order, ranked)
    acc = gamma * (chi.unsqueeze(-2) @ grads).squeeze(-2)
    ghat = ops.ota_combine_with_noise(acc, (k * gamma).squeeze(-1),
                                      float(np.sqrt(n0)) * z01,
                                      use_kernel=use_kernel)
    return ghat, chi


def bbfl_round(grads: torch.Tensor, habs: torch.Tensor, z01: torch.Tensor,
               t: int, *, dim: int, g_max: float, e_s: float, n0: float,
               gamma_odd: float, mask_odd, gamma_even: float, mask_even,
               use_kernel: bool = True):
    """[16] broadband analog aggregation round, batched over leading
    (trial) dimensions; mirrors ``repro.core.ota.bbfl_round_jax``.

    Both BB-FL variants through the global round index ``t``: odd rounds
    use (``gamma_odd``, ``mask_odd``), even ones (``gamma_even``,
    ``mask_even``). Truncated inversion inside the scheduled mask; the PS
    divides by max(|S_t|, 1) * gamma.

    Returns: (ghat (..., d), chi (..., N)).
    """
    odd = t % 2 == 1
    gamma = float(gamma_odd if odd else gamma_even)
    mask = torch.as_tensor(np.asarray(mask_odd if odd else mask_even) > 0,
                           device=habs.device)
    tau = g_max * gamma / np.sqrt(dim * e_s)
    chi = ((habs >= tau) & mask).to(grads.dtype)
    k = chi.sum(-1)
    acc = gamma * (chi.unsqueeze(-2) @ grads).squeeze(-2)
    denom = torch.clamp(k, min=1.0) * gamma
    ghat = ops.ota_combine_with_noise(acc, denom, float(np.sqrt(n0)) * z01,
                                      use_kernel=use_kernel)
    return ghat, chi


def expected_participation(params: OTAParams,
                           lambdas: np.ndarray) -> np.ndarray:
    """E[chi^A_m] = exp(-tau_m^2/Lambda_m)."""
    return participation_probability(params.thresholds(), lambdas)


def uniform_gamma_min_variance(lambdas: np.ndarray, dim: int, e_s: float,
                               g_max: float, n0: float,
                               n_grid: int = 4096) -> float:
    """Common pre-scaler minimizing the Lemma-1 variance bound over a grid
    (statistical CSI only); NumPy copy of the reference's, grid in the same
    order. LCPC OTA-Comp and both BB-FL schemes use it."""
    lambdas = np.asarray(lambdas)
    g_hi = float(np.min(gamma_m_max(lambdas, dim, e_s, g_max)))
    grid = np.linspace(1e-4 * g_hi, g_hi, n_grid)
    best, best_v = grid[0], np.inf
    for gmm in grid:
        gam = np.full(lambdas.shape, gmm)
        ex = -(gam ** 2) * g_max ** 2 / (dim * lambdas * e_s)
        a_m = gam * np.exp(ex)
        alpha = float(np.sum(a_m))
        p = a_m / alpha
        v = float(np.sum(p ** 2 * g_max ** 2 * (gam / a_m - 1.0))
                  + dim * n0 / alpha ** 2)
        if v < best_v:
            best, best_v = gmm, v
    return float(best)
