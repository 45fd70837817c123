"""Convergence bounds of Theorems 1 and 2 and their bias/variance pieces
(copy of ``repro.core.bounds``, host NumPy code).

Both theorems share the structure
    error <= initialization + 2 * BIAS + VARWEIGHT * zeta
with
    BIAS        = N * kappa^2 * sum_m (p_m - 1/N)^2     (model-bias term)
    strongly convex (Thm 1):
        E||w_t - w*||^2 <= 2 D^2 (1-eta*mu)^{2t}
                         + 2 N kappa_sc^2/mu^2 * sum (1/N - p)^2
                         + 2 eta/mu * zeta
    non-convex (Thm 2):
        (1/T) sum E||grad F||^2 <= 4 max_m(f_m(w0)-f_m^inf)/(eta T)
                                 + 2 N kappa_nc^2 sum (p-1/N)^2
                                 + 2 eta L zeta

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


def effective_participation(p: np.ndarray, q: np.ndarray,
                            on_missing: str = "reweight",
                            pi=None) -> np.ndarray:
    """Participation levels under the fault + sampling layers.

    ``p`` are the designed participation levels (E[chi]/nu), ``q`` the
    per-device round-survival probabilities
    (``core.faults.survival_prob``), ``pi`` the optional Bernoulli
    client-sampling inclusion probabilities
    (``core.participation``, sum_m pi_m = S). The Theorem-1/2 bias term
    prices every participation shift by evaluating :func:`bias_sum` on
    the *effective* levels returned here.

    Fault degradation policy (``on_missing``):

      * ``"reweight"`` — inverse-propensity weighting restores the mean:
        the fault factor is 1 (faults add variance, not bias).
      * ``"zero"`` — missing payloads are zero-filled, shrinking device m
        by its survival rate: factor ``q`` — the priced outage bias.
      * ``"stale"`` — the last received gradient stands in, so the
        participation *level* keeps factor 1; the staleness of the
        gradient itself is a time-correlated bias outside the bound's
        model (see ``core.faults`` — the empirical comparison point).
        The buffered-async mode (``core.async_fl``) is the regime where
        staleness *is* priced: its stationary staleness distribution
        tilts the levels by a static factor, see
        :func:`async_effective_participation`.

    Sampling factor: included payloads are scaled by the uniform inverse
    propensity N/S, so device m's level tilts by ``pi_m * N / S``
    (exactly 1 under the zero-bias uniform policy pi = S/N). Faults and
    sampling are independent per round, so the factors compose
    multiplicatively — ``p * pi * q`` up to the N/S scale.
    """
    p = np.asarray(p, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    if on_missing == "zero":
        eff = p * q
    elif on_missing in ("reweight", "stale"):
        eff = p.copy()
    else:
        raise ValueError(f"unknown on_missing policy {on_missing!r}")
    if pi is not None:
        pi = np.asarray(pi, dtype=np.float64)
        eff = eff * pi * (pi.shape[0] / np.sum(pi))
    return eff


def async_effective_participation(p: np.ndarray, c: np.ndarray,
                                  weights=None) -> np.ndarray:
    """Participation levels under buffered-async delivery.

    ``p`` are the (possibly fault/sampling-tilted) participation levels,
    ``c`` the per-device async delivery weights
    ``c_m = E[delta^S ; delivered]`` (``core.async_fl.delivery_weight``)
    and ``weights`` the optional PS per-device weights v (uniform 1 when
    None). The async layer scales device m's payload by
    ``v_m * N / sum(c v)`` — expected delivered mass normalized to N —
    so the *stationary* staleness distribution shifts the levels to

        e_m = p_m * c_m * v_m * N / sum_j(c_j v_j),

    a static, structured tilt the Theorem-1/2 bias term prices via
    :func:`bias_sum` on the levels returned here, composing with the
    fault (q) and sampling (pi) factors of
    :func:`effective_participation` that already shaped ``p``.
    """
    p = np.asarray(p, dtype=np.float64)
    c = np.asarray(c, dtype=np.float64)
    n = p.shape[0]
    v = np.ones(n) if weights is None else np.asarray(weights, np.float64)
    return p * c * v * (n / float(np.sum(c * v)))


def async_bias_sum(p: np.ndarray, c: np.ndarray, weights=None) -> float:
    """:func:`bias_sum` of the async effective levels — the model-bias
    magnitude the buffered-async mode's staleness distribution induces."""
    return bias_sum(async_effective_participation(p, c, weights))


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


def design_objective(p: np.ndarray, zeta: float, w: ObjectiveWeights) -> float:
    """omega_var * zeta + omega_bias * sum (p - 1/N)^2 (eq. (15a)/(17a))."""
    return w.omega_var * zeta + w.omega_bias * bias_sum(p)


def theorem1_bound(t: int, *, eta: float, mu: float, diam: float,
                   kappa_sc: float, p: np.ndarray, zeta: float) -> dict:
    """Theorem 1 optimality-error bound after t rounds (strongly convex)."""
    n = np.asarray(p).shape[0]
    init = 2.0 * diam ** 2 * (1.0 - eta * mu) ** (2 * t)
    bias = 2.0 * n * kappa_sc ** 2 / mu ** 2 * bias_sum(p)
    var = 2.0 * eta / mu * zeta
    return {"initialization": init, "bias": bias, "variance": var,
            "total": init + bias + var}


def theorem2_bound(T: int, *, eta: float, smooth_l: float, f_gap0: float,
                   kappa_nc: float, p: np.ndarray, zeta: float) -> dict:
    """Theorem 2 average-stationarity bound after T rounds (non-convex)."""
    n = np.asarray(p).shape[0]
    init = 4.0 * f_gap0 / (eta * T)
    bias = 2.0 * n * kappa_nc ** 2 * bias_sum(p)
    var = 2.0 * eta * smooth_l * zeta
    return {"initialization": init, "bias": bias, "variance": var,
            "total": init + bias + var}


def projection_radius(grad_norms_at_zero: np.ndarray, mu: float) -> float:
    """D = 2 max_m ||grad f_m(0)||/mu — diameter of the feasible ball W."""
    return 2.0 * float(np.max(grad_norms_at_zero)) / mu
