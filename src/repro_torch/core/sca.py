"""Successive convex approximation (SCA) loop — Sec. IV (copy of
``repro.core.sca``, host NumPy/SciPy code).

The paper solves problems (15) (OTA) and (17) (digital) by iteratively
solving the convex surrogates (16)/(18) obtained by linearizing the
non-convex pieces around the current iterate ("anchor"), then re-anchoring
at the solution (Marks & Wright inner approximation; converges to a
stationary point of the original problem).

The paper uses CVX; offline here we solve each (smooth, small) surrogate
with SciPy SLSQP, which handles nonlinear inequality + equality constraints
directly. Each design module supplies:
  - ``build(anchor) -> SurrogateProblem``  (objective/constraints/bounds)
  - ``true_objective(x) -> float``          (original objective (15a)/(17a))
  - ``project(x) -> x``                     (restore exact feasibility of the
                                             physical couplings, e.g. (15b))
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Optional, Sequence

import numpy as np
from scipy import optimize


@dataclasses.dataclass
class SurrogateProblem:
    """A convex surrogate in flat-vector form for SLSQP."""

    objective: Callable[[np.ndarray], float]
    grad: Optional[Callable[[np.ndarray], np.ndarray]]
    ineq_constraints: Sequence[dict]     # scipy format, fun(x) >= 0
    eq_constraints: Sequence[dict]
    bounds: Sequence[tuple]
    x0: np.ndarray


@dataclasses.dataclass
class SCAResult:
    x: np.ndarray
    objective: float
    history: list
    converged: bool
    n_iters: int


def solve_surrogate(prob: SurrogateProblem, maxiter: int = 200) -> np.ndarray:
    cons = list(prob.ineq_constraints) + list(prob.eq_constraints)
    lo = np.array([b[0] if b[0] is not None else -np.inf for b in prob.bounds])
    hi = np.array([b[1] if b[1] is not None else np.inf for b in prob.bounds])
    # Re-anchored starts can sit (marginally) outside the box — the design
    # modules' ``project()`` floors differ from the SLSQP bounds — and SLSQP
    # warns ("Values in x were outside bounds...") before clipping
    # internally. Clip the start into the box up front so the solve begins
    # feasible and the warning never fires.
    x0 = np.clip(np.asarray(prob.x0, dtype=np.float64), lo, hi)
    # Normalize the objective to O(1) at the anchor — SLSQP's line search is
    # not scale invariant and the raw design objectives span ~1e5 (the paper
    # itself flags the ill-conditioning of (15)). The scale is evaluated at
    # the *raw* anchor: SLSQP always optimized from the clipped point (it
    # clipped internally), so keeping the old scale makes the explicit clip
    # solution-preserving to the last bit.
    f0 = abs(float(prob.objective(prob.x0)))
    scale = 1.0 / max(f0, 1e-30)
    fun = lambda x: scale * prob.objective(x)
    jac = None if prob.grad is None else (lambda x: scale * prob.grad(x))
    with warnings.catch_warnings():
        # Even from an in-box start, SLSQP's Fortran line search can propose
        # trial points marginally outside the box mid-iteration; SciPy clips
        # them before evaluating (its ScalarFunction wrapper) and emits a
        # RuntimeWarning from inside the solve loop. The clipping is exactly
        # the behaviour we rely on — and we clip the returned x again below —
        # so the warning carries no signal here. Scoped to this one message;
        # every other RuntimeWarning still propagates (tier-1 runs with
        # RuntimeWarning-as-error).
        warnings.filterwarnings(
            "ignore", message="Values in x were outside bounds",
            category=RuntimeWarning)
        res = optimize.minimize(
            fun, x0, jac=jac, method="SLSQP",
            bounds=prob.bounds, constraints=cons,
            options={"maxiter": maxiter, "ftol": 1e-14})
    x = np.asarray(res.x, dtype=np.float64)
    return np.clip(x, lo, hi)


def run_sca(build: Callable[[np.ndarray], SurrogateProblem],
            true_objective: Callable[[np.ndarray], float],
            project: Callable[[np.ndarray], np.ndarray],
            x0: np.ndarray, *, n_iters: int = 15, tol: float = 1e-9,
            inner_maxiter: int = 200) -> SCAResult:
    """Run SCA from anchor ``x0``; returns the best (projected) iterate."""
    anchor = project(np.asarray(x0, dtype=np.float64))
    best_x, best_f = anchor, true_objective(anchor)
    history = [best_f]
    converged = False
    k = 0
    for k in range(n_iters):
        prob = build(anchor)
        x = solve_surrogate(prob, maxiter=inner_maxiter)
        x = project(x)
        f = true_objective(x)
        history.append(f)
        if f < best_f:
            best_x, best_f = x, f
        if abs(history[-2] - f) <= tol * max(1.0, abs(f)) and k > 0:
            converged = True
            anchor = x
            break
        anchor = x
    return SCAResult(x=best_x, objective=best_f, history=history,
                     converged=converged, n_iters=k + 1)


def simplex_projection(v: np.ndarray) -> np.ndarray:
    """Euclidean projection of v onto the probability simplex."""
    v = np.asarray(v, dtype=np.float64)
    n = v.shape[0]
    u = np.sort(v)[::-1]
    css = np.cumsum(u)
    rho = np.nonzero(u * np.arange(1, n + 1) > (css - 1.0))[0][-1]
    theta = (css[rho] - 1.0) / (rho + 1.0)
    return np.maximum(v - theta, 0.0)
