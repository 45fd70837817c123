"""OTA-FL parameter design — problem (15) (counterpart of
``repro.core.ota_design``): the design spec, the gamma -> (alpha, p)
coupling, the true objective (15a), the two heuristic anchors of the
authors' prior work [1], and the direct solver. Under the simplex
constraint (15e), gamma fully determines the design:
alpha = sum_m alpha_m(gamma_m), p_m = alpha_m / alpha.

  * min-noise-variance:  gamma_m = gamma_{m,max}  (maximizes alpha).
  * zero-bias min-noise: alpha_m identical = min_m alpha_{m,max}
    (p = 1/N exactly; smaller root of alpha_m(gamma) = c).
  * ``design_ota_direct``: the box-constrained minimisation over gamma
    alone with L-BFGS-B from both anchors (the FL-LM launcher's design).

The spec has no mini-batch variances (the launchers pass none), so the
objective's mini-batch term is 0. The SCA and batched solvers arrive with
ROADMAP Queue 1 item 7.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from scipy import optimize

from .bounds import ObjectiveWeights, bias_sum
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


def true_objective_from_gamma(spec: OTADesignSpec,
                              gammas: np.ndarray) -> float:
    """Original objective (15a) at the physically coupled point. The
    exponent is clipped at 700 and alpha floored at 1e-150, as the
    reference does, so gammas far past gamma_max stay finite."""
    a = _alpha_m(spec, gammas)
    alpha = max(float(np.sum(a)), 1e-150)
    p = a / alpha
    ratio = np.exp(np.minimum(spec.c_m() * gammas ** 2, 700.0))  # gamma/alpha_m
    trans = float(np.sum(p ** 2 * spec.g_max ** 2 * (ratio - 1.0)))
    noise = spec.dim * spec.n0 / alpha ** 2
    return (spec.weights.omega_var * (trans + noise)
            + spec.weights.omega_bias * bias_sum(p))


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


def design_ota_direct(spec: OTADesignSpec, *,
                      anchor: Optional[np.ndarray] = None,
                      maxiter: int = 500) -> tuple[OTAParams, float]:
    """Problem (15) as a box-constrained minimisation over gamma alone,
    solved with SciPy's L-BFGS-B from both heuristic anchors (or from
    ``anchor``), keeping the best. The objective and its gradient are f64
    torch autograd on the CPU (the reference evaluates its jax objective
    in f32, so the two land within a tolerance, not bit for bit).
    Returns (params, objective)."""
    n = spec.n
    c = torch.as_tensor(spec.c_m(), dtype=torch.float64)
    gmax = spec.gamma_max()
    g2 = spec.g_max ** 2
    wv, wb = spec.weights.omega_var, spec.weights.omega_bias
    u_g = np.median(gmax)

    def f(gs64):
        gs = torch.tensor(gs64, dtype=torch.float64, requires_grad=True)
        gam = gs * u_g
        x = c * gam ** 2
        a = gam * torch.exp(-x)
        alpha = torch.sum(a)
        p = a / alpha
        trans = torch.sum(p ** 2 * g2 * (torch.exp(x) - 1.0))
        noise = spec.dim * spec.n0 / alpha ** 2
        val = wv * (trans + noise) + wb * torch.sum((p - 1.0 / n) ** 2)
        (grad,) = torch.autograd.grad(val, gs)
        return float(val.detach()), grad.numpy()

    anchors = [anchor] if anchor is not None else [
        anchor_min_noise(spec), anchor_zero_bias(spec)]
    best_g, best_f = None, np.inf
    for a0 in anchors:
        # start inside the box (heuristic anchors can graze its edges)
        x0 = np.clip(a0 / u_g, 1e-6, gmax / u_g)
        res = optimize.minimize(f, x0, jac=True, method="L-BFGS-B",
                                bounds=[(1e-6, gmax[m] / u_g)
                                        for m in range(n)],
                                options={"maxiter": maxiter})
        if res.fun < best_f:
            best_f, best_g = float(res.fun), np.clip(res.x * u_g, 0, gmax)
    return params_from_gamma(spec, best_g), best_f
