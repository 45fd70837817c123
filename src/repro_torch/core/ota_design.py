"""OTA-FL parameter design — the closed-form pieces of problem (15).

Counterpart of the solver-free part of ``repro.core.ota_design``: the
design spec, the gamma -> (alpha, p) coupling and the two heuristic
anchors of the authors' prior work [1]. Under the simplex constraint
(15e), gamma fully determines the design: alpha = sum_m alpha_m(gamma_m).

  * min-noise-variance:  gamma_m = gamma_{m,max}  (maximizes alpha).
  * zero-bias min-noise: alpha_m identical = min_m alpha_{m,max}
    (p = 1/N exactly; smaller root of alpha_m(gamma) = c).

The SCA / batched solvers arrive with ROADMAP Queue 1 item 7.
"""
from __future__ import annotations

import dataclasses
import numpy as np

from .bounds import ObjectiveWeights
from .ota import OTAParams, alpha_m_max, gamma_m_max


@dataclasses.dataclass(frozen=True)
class OTADesignSpec:
    """Immutable inputs of the OTA design problem."""

    lambdas: np.ndarray
    dim: int
    g_max: float
    e_s: float
    n0: float
    weights: ObjectiveWeights

    @property
    def n(self) -> int:
        return int(self.lambdas.shape[0])

    def c_m(self) -> np.ndarray:
        """c_m = G^2/(d Lambda_m E_s): alpha_m = gamma exp(-c_m gamma^2)."""
        return self.g_max ** 2 / (self.dim * self.lambdas * self.e_s)

    def gamma_max(self) -> np.ndarray:
        return gamma_m_max(self.lambdas, self.dim, self.e_s, self.g_max)

    def alpha_max(self) -> np.ndarray:
        return alpha_m_max(self.lambdas, self.dim, self.e_s, self.g_max)


def _alpha_m(spec: OTADesignSpec, gammas: np.ndarray) -> np.ndarray:
    return gammas * np.exp(-spec.c_m() * gammas ** 2)


def params_from_gamma(spec: OTADesignSpec, gammas: np.ndarray) -> OTAParams:
    a = _alpha_m(spec, gammas)
    return OTAParams(gammas=np.asarray(gammas, dtype=np.float64),
                     alpha=float(np.sum(a)), g_max=spec.g_max, dim=spec.dim,
                     energy_per_symbol=spec.e_s, noise_psd=spec.n0)


def anchor_min_noise(spec: OTADesignSpec) -> np.ndarray:
    """gamma = gamma_max: maximize alpha -> minimum noise variance [1]."""
    return spec.gamma_max().copy()


def anchor_zero_bias(spec: OTADesignSpec) -> np.ndarray:
    """Equalize alpha_m at min_m alpha_max -> p = 1/N exactly [1]."""
    c = spec.c_m()
    target = float(np.min(spec.alpha_max())) * (1.0 - 1e-9)
    # alpha_m is increasing on [0, gamma_max]; bisect the smaller root of
    # alpha_m(gamma) = target over all devices at once
    lo = np.zeros(spec.n)
    hi = spec.gamma_max().copy()
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        below = mid * np.exp(-c * mid ** 2) < target
        lo = np.where(below, mid, lo)
        hi = np.where(below, hi, mid)
    return 0.5 * (lo + hi)
