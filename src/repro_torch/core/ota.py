"""Biased over-the-air (OTA) FL aggregation — Sec. II-A of the paper.

Counterpart of ``repro.core.ota`` (uplink model eq. (3)-(6)):
    chi^A  = 1{ |h_{m,t}| >= G_max * gamma_m / sqrt(d E_s) }   (eq. (5))
    ghat_t = (sum_m chi^A gamma_m g_{m,t} + z_t) / alpha        (eq. (6))
with alpha_m(gamma_m) = gamma_m exp(-gamma_m^2 G^2 / (d Lambda_m E_s)).
The PS epilogue runs through the CUDA kernel ``kernels/csrc/ota_combine.cu``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels import ops


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


def alpha_m_max(lambdas: np.ndarray, dim: int, e_s: float,
                g_max: float) -> np.ndarray:
    """max_gamma alpha_m(gamma) = sqrt(d Lambda E_s / (2 e G^2)) (Sec. IV-A)."""
    return np.sqrt(np.asarray(lambdas) * dim * e_s / (2.0 * np.e * g_max ** 2))


def gamma_m_max(lambdas: np.ndarray, dim: int, e_s: float,
                g_max: float) -> np.ndarray:
    """argmax_gamma alpha_m(gamma) = sqrt(d Lambda E_s / (2 G^2)) (Sec. IV-A)."""
    return np.sqrt(np.asarray(lambdas) * dim * e_s / (2.0 * g_max ** 2))


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
