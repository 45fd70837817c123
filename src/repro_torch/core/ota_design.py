"""OTA-FL parameter design — problem (15) and its SCA surrogate (16)
(counterpart of ``repro.core.ota_design``).

Variables of the SCA surrogate (flat vector, scaled for conditioning):
    x = [gamma'(N), p(N), z'(N), alpha'(1)]
with physical values gamma = u_g * gamma', alpha = u_a * alpha',
z = u_z * z' (u_z = u_g/u_a); u_g/u_a come from the channel statistics
(gamma_max / sum alpha_max), which keeps every variable O(1).

Under the simplex constraint (15e), gamma fully determines the design:
alpha = sum_m alpha_m(gamma_m), p_m = alpha_m / alpha. Solvers:

  * ``design_ota_sca``    — paper-faithful Sec. IV-A SCA on surrogate (16)
    (SciPy SLSQP, host code; the trusted oracle).
  * ``design_ota_direct`` — the box-constrained minimisation over gamma
    alone with L-BFGS-B from both anchors (the FL-LM launcher's design).
  * ``design_ota_batch``  — a whole sweep grid solved at once in float64
    torch (``core.sca_torch``, the same gamma reduction), on the card by
    default; specs stacked via ``stack_ota_specs``.

Heuristic anchors (from the authors' prior work [1]):
  * min-noise-variance:  gamma_m = gamma_{m,max}  (maximizes alpha).
  * zero-bias min-noise: alpha_m identical = min_m alpha_{m,max}
    (p = 1/N exactly; smaller root of alpha_m(gamma) = c).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
from scipy import optimize

from . import sca_torch
from .bounds import ObjectiveWeights, bias_sum
from .ota import OTAParams, alpha_m_max, gamma_m_max
from .sca import SCAResult, SurrogateProblem, run_sca

_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class OTADesignSpec:
    """Immutable inputs of the OTA design problem."""

    lambdas: np.ndarray
    dim: int
    g_max: float
    e_s: float
    n0: float
    weights: ObjectiveWeights
    sigma_sq: Optional[np.ndarray] = None   # mini-batch variances (None -> 0)

    @property
    def n(self) -> int:
        return int(self.lambdas.shape[0])

    @property
    def sigmas2(self) -> np.ndarray:
        if self.sigma_sq is None:
            return np.zeros(self.n)
        return np.asarray(self.sigma_sq, dtype=np.float64)

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
    """Original objective (15a) at the physically coupled point, the
    mini-batch term 0 when the spec has no variances. The exponent is
    clipped at 700 and alpha floored at 1e-150, as the reference does, so
    gammas far past gamma_max stay finite."""
    a = _alpha_m(spec, gammas)
    alpha = max(float(np.sum(a)), 1e-150)
    p = a / alpha
    ratio = np.exp(np.minimum(spec.c_m() * gammas ** 2, 700.0))  # gamma/alpha_m
    trans = float(np.sum(p ** 2 * spec.g_max ** 2 * (ratio - 1.0)))
    mb = float(np.sum(p ** 2 * spec.sigmas2))
    noise = spec.dim * spec.n0 / alpha ** 2
    return (spec.weights.omega_var * (trans + mb + noise)
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


# ------------------------------------------------------------- SCA (paper)

def _pack(g, p, z, a):
    return np.concatenate([g, p, z, [a]])


def _unpack(x, n):
    return x[:n], x[n:2 * n], x[2 * n:3 * n], float(x[3 * n])


def design_ota_sca(spec: OTADesignSpec, *, n_iters: int = 12,
                   anchor: Optional[np.ndarray] = None) -> tuple[OTAParams, SCAResult]:
    """Paper-faithful SCA (Sec. IV-A): iterate convex surrogate (16)."""
    n = spec.n
    c = spec.c_m()
    gmax = spec.gamma_max()
    amax = spec.alpha_max()
    u_g = float(np.median(gmax))               # gamma scale
    u_a = float(np.sum(amax))                  # alpha scale
    u_z = u_g / u_a
    g2 = spec.g_max ** 2
    wv, wb = spec.weights.omega_var, spec.weights.omega_bias
    s2 = spec.sigmas2

    def project(x: np.ndarray) -> np.ndarray:
        """Restore exact physical coupling (15b)+(15e) from gamma alone."""
        gam = np.clip(x[:n] * u_g, _EPS * u_g, gmax)
        a_m = _alpha_m(spec, gam)
        alpha = float(np.sum(a_m))
        p = a_m / alpha
        z = p * gam / alpha
        return _pack(gam / u_g, p, z / u_z, alpha / u_a)

    def true_obj(x: np.ndarray) -> float:
        return true_objective_from_gamma(spec, np.clip(x[:n] * u_g, 0, gmax))

    def build(xbar: np.ndarray) -> SurrogateProblem:
        gb, pb, zb, ab = _unpack(xbar, n)
        gb_p, ab_p = gb * u_g, ab * u_a         # physical anchors

        def f(x):
            g, p, z, a = _unpack(x, n)
            a_p = a * u_a
            return (wv * (np.sum(g2 * z * u_z) + spec.dim * spec.n0 / a_p ** 2
                          + np.sum(p ** 2 * s2)
                          - np.sum(g2 * pb * (2 * p - pb)))
                    + wb * np.sum((p - 1.0 / n) ** 2))

        def fgrad(x):
            g, p, z, a = _unpack(x, n)
            a_p = a * u_a
            gr = np.zeros_like(x)
            gr[2 * n:3 * n] = wv * g2 * u_z
            gr[n:2 * n] = wv * (2 * p * s2 - 2 * g2 * pb) + 2 * wb * (p - 1.0 / n)
            gr[3 * n] = wv * (-2 * spec.dim * spec.n0 / a_p ** 3) * u_a
            return gr

        # (16b): ln z + ln a - ln(gb pb) - g/gb - p/pb + 2 >= 0 (physical vars)
        def c1(x):
            g, p, z, a = _unpack(x, n)
            return (np.log(np.maximum(z * u_z, 1e-300))
                    + np.log(max(a * u_a, 1e-300))
                    - np.log(gb_p * pb) - (g * u_g) / gb_p - p / pb + 2.0)

        def c1j(x):
            g, p, z, a = _unpack(x, n)
            J = np.zeros((n, 3 * n + 1))
            J[:, :n] = np.diag(-1.0 / gb)
            J[:, n:2 * n] = np.diag(-1.0 / pb)
            J[:, 2 * n:3 * n] = np.diag(1.0 / np.maximum(z, 1e-300))
            J[:, 3 * n] = 1.0 / max(a, 1e-300)
            return J

        # (16c): ln g - c g^2 - ln(ab pb) - a/ab - p/pb + 2 >= 0
        def c2(x):
            g, p, z, a = _unpack(x, n)
            gp = g * u_g
            return (np.log(np.maximum(gp, 1e-300)) - c * gp ** 2
                    - np.log(ab_p * pb) - (a * u_a) / ab_p - p / pb + 2.0)

        def c2j(x):
            g, p, z, a = _unpack(x, n)
            gp = g * u_g
            J = np.zeros((n, 3 * n + 1))
            J[:, :n] = np.diag((1.0 / np.maximum(gp, 1e-300) - 2 * c * gp) * u_g)
            J[:, n:2 * n] = np.diag(-1.0 / pb)
            J[:, 3 * n] = -1.0 / ab
            return J

        # (16d): (2 ab - a)/ab^2 - p/amax >= 0
        def c3(x):
            g, p, z, a = _unpack(x, n)
            return (2 * ab_p - a * u_a) / ab_p ** 2 - p / amax

        def c3j(x):
            J = np.zeros((n, 3 * n + 1))
            J[:, n:2 * n] = np.diag(-1.0 / amax)
            J[:, 3 * n] = -u_a / ab_p ** 2
            return J

        def eq(x):
            return np.array([np.sum(x[n:2 * n]) - 1.0])

        def eqj(x):
            J = np.zeros((1, 3 * n + 1))
            J[0, n:2 * n] = 1.0
            return J

        bnds = ([(1e-6, gmax[m] / u_g) for m in range(n)]
                + [(1e-8, 1.0)] * n
                + [(1e-12, 1e6)] * n
                + [(1e-6, 2.0)])
        return SurrogateProblem(
            objective=f, grad=fgrad,
            ineq_constraints=[
                {"type": "ineq", "fun": c1, "jac": c1j},
                {"type": "ineq", "fun": c2, "jac": c2j},
                {"type": "ineq", "fun": c3, "jac": c3j},
            ],
            eq_constraints=[{"type": "eq", "fun": eq, "jac": eqj}],
            bounds=bnds, x0=xbar.copy())

    anchors = [anchor] if anchor is not None else [
        anchor_min_noise(spec), anchor_zero_bias(spec)]
    best_res = None
    for a0 in anchors:
        a_m0 = _alpha_m(spec, a0)
        x0 = _pack(a0 / u_g, a_m0 / np.sum(a_m0),
                   (a_m0 / np.sum(a_m0)) * a0 / np.sum(a_m0) / u_z,
                   np.sum(a_m0) / u_a)
        res = run_sca(build, true_obj, project, x0, n_iters=n_iters)
        if best_res is None or res.objective < best_res.objective:
            best_res = res
    gam = np.clip(best_res.x[:n] * u_g, 0.0, gmax)
    return params_from_gamma(spec, gam), best_res


def design_ota_direct(spec: OTADesignSpec, *,
                      anchor: Optional[np.ndarray] = None,
                      maxiter: int = 500) -> tuple[OTAParams, float]:
    """Problem (15) as a box-constrained minimisation over gamma alone,
    solved with SciPy's L-BFGS-B from both heuristic anchors (or from
    ``anchor``), keeping the best. The objective (15a), its mini-batch
    term included, and its gradient are f64 torch autograd on the CPU (the
    reference evaluates its jax objective in f32, so the two land within a
    tolerance, not bit for bit). Returns (params, objective)."""
    n = spec.n
    c = torch.as_tensor(spec.c_m(), dtype=torch.float64)
    s2 = torch.as_tensor(spec.sigmas2, dtype=torch.float64)
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
        mb = torch.sum(p ** 2 * s2)
        noise = spec.dim * spec.n0 / alpha ** 2
        val = wv * (trans + mb + noise) + wb * torch.sum((p - 1.0 / n) ** 2)
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


# ----------------------------------------------------- batched (torch)

def default_anchors(spec: OTADesignSpec) -> np.ndarray:
    """(A, N) heuristic gamma anchors: min-noise + zero-bias (Sec. IV-A)."""
    return np.stack([anchor_min_noise(spec), anchor_zero_bias(spec)])


def stack_ota_specs(specs: Sequence[OTADesignSpec]) -> dict:
    """Stack B design specs along a leading axis for the batched solver.

    All specs must share the device count N; everything else (channel
    gains, dimension, energy, noise, objective weights) may vary per point
    — they enter the solve as per-point tensors, so one solve covers the
    sweep.
    """
    n = specs[0].n
    if any(s.n != n for s in specs):
        raise ValueError("all specs in a batch must share the device count")
    return {
        "lambdas": np.stack([np.asarray(s.lambdas, np.float64)
                             for s in specs]),
        "dim": np.array([float(s.dim) for s in specs]),
        "g_max": np.array([s.g_max for s in specs]),
        "e_s": np.array([s.e_s for s in specs]),
        "n0": np.array([s.n0 for s in specs]),
        "omega_var": np.array([s.weights.omega_var for s in specs]),
        "omega_bias": np.array([s.weights.omega_bias for s in specs]),
        "sigma_sq": np.stack([s.sigmas2 for s in specs]),
    }


def design_ota_batch(specs: Sequence[OTADesignSpec],
                     anchors: Optional[np.ndarray] = None, *, device=None
                     ) -> tuple[list[OTAParams], np.ndarray]:
    """Solve a grid of OTA design problems (15) at once, on the card
    unless ``device`` says otherwise.

    The batched counterpart of calling ``design_ota_sca`` per point: same
    heuristic anchors, same true objective (15a), the whole batch one
    float64 torch solve (``core.sca_torch``). The SciPy SCA path remains
    the trusted oracle.

    Returns (params, objectives): per-point ``OTAParams`` and the (B,)
    true objectives at the returned designs.
    """
    if anchors is None:
        anchors = np.stack([default_anchors(s) for s in specs])
    stk = stack_ota_specs(specs)
    gammas, objs = sca_torch.solve_ota_gamma_batch(
        stk["lambdas"], stk["dim"], stk["g_max"], stk["e_s"], stk["n0"],
        stk["omega_var"], stk["omega_bias"], stk["sigma_sq"], anchors,
        device=device)
    params = [params_from_gamma(s, np.clip(g, 0.0, s.gamma_max()))
              for s, g in zip(specs, gammas)]
    return params, objs


def design_ota_participation(spec: OTADesignSpec, params: OTAParams,
                             clients: int, *, survival=None, device=None
                             ) -> tuple[np.ndarray, float]:
    """Co-designed Bernoulli inclusion probabilities pi for OTA schemes.

    Given a solved OTA design (its effective participation levels
    ``p_m = alpha_m/alpha``) and an expected cohort size S, solves the
    bound-shaped sampling problem (``core.sca_torch.
    solve_participation_batch``) under the cell's bias/variance weights;
    ``survival`` are the fault-layer survival probabilities q_m (ones
    when faults are off), so outage and sampling bias are priced jointly
    (effective levels ~ p * pi * q).

    Returns (pi, objective): the (N,) probabilities on the capped simplex
    {sum pi = S, pi <= 1} and the sampling objective value.
    """
    p = np.asarray(params.participation_levels(spec.lambdas), np.float64)
    q = (np.ones_like(p) if survival is None
         else np.asarray(survival, np.float64))
    pi, obj = sca_torch.solve_participation_batch(
        p[None], q[None], [clients],
        [spec.weights.omega_var], [spec.weights.omega_bias], device=device)
    return pi[0], float(obj[0])
