"""Design-objective pieces of Theorems 1/2 (copy of ``repro.core.bounds``).

The design objective (15a)/(17a) is  omega_var * zeta + omega_bias * bias_sum
with (Sec. IV footnote 4):
    strongly convex:  (omega_var, omega_bias) = (eta/mu,  N kappa_sc^2/mu^2)
    non-convex:       (omega_var, omega_bias) = (eta L,   N kappa_nc^2)
"""
from __future__ import annotations

import dataclasses

import numpy as np


def bias_sum(p: np.ndarray) -> float:
    """sum_m (p_m - 1/N)^2 — the structured model-bias magnitude."""
    p = np.asarray(p, dtype=np.float64)
    n = p.shape[0]
    return float(np.sum((p - 1.0 / n) ** 2))


@dataclasses.dataclass(frozen=True)
class ObjectiveWeights:
    """(omega_var, omega_bias) per Sec. IV footnote 4."""

    omega_var: float
    omega_bias: float

    @classmethod
    def strongly_convex(cls, eta: float, mu: float, kappa_sc: float, n: int):
        return cls(omega_var=eta / mu, omega_bias=n * kappa_sc ** 2 / mu ** 2)

    @classmethod
    def non_convex(cls, eta: float, smooth_l: float, kappa_nc: float, n: int):
        return cls(omega_var=eta * smooth_l, omega_bias=n * kappa_nc ** 2)
