"""Digital-FL parameter design — problem (17) and its SCA surrogate (18)
(counterpart of ``repro.core.digital_design``).

Variables (flat): x = [p(N), nu(N), r'(N), R(N), z(N), varpi(N), t(N)].

Physical couplings used by the projection step (restoring exact
feasibility of (17c)-(17d) after each inner solve):
    beta = p * nu  (clipped to (0,1)),   rho = sqrt(-Lambda ln beta),
    R = log2(1 + E_s rho^2/N0),          nu = beta / p,
    t = (64 + d(r'+1)) beta / (B R),     z = p/nu,
    varpi = p / (nu (2*2^{r'} - 1)^2).
If the projected point violates the latency budget (17b), thresholds are
raised (rho^2 *= kappa, bisected) — this lowers beta and raises R, both of
which shrink latency, while p (and hence the designed bias) is unchanged
since nu re-compensates.

Solvers:
  * ``design_digital_sca``    — paper-faithful Sec. IV-B SCA on (18).
  * ``design_digital_direct`` — beyond-paper: SLSQP on the original (17)
    over the reduced variables (p, beta, r) (nu, R, t are pinned by the
    couplings), relaxing r to a continuum.
  * ``design_digital_batch``  — a whole sweep grid of (17) instances
    solved at once in float64 torch (``core.sca_torch`` penalty solver
    over the same reduced variables), on the card by default; specs
    stacked via ``stack_digital_specs``. The SciPy paths (host code) stay
    the trusted oracle.
All finalize r_m = floor(r') + 1 (paper's rule) and re-verify latency.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
from scipy import optimize

from . import sca_torch
from .bounds import ObjectiveWeights, bias_sum
from .digital import DigitalParams
from .sca import SCAResult, SurrogateProblem, run_sca, simplex_projection

_LN2 = float(np.log(2.0))


@dataclasses.dataclass(frozen=True)
class DigitalDesignSpec:
    lambdas: np.ndarray
    dim: int
    g_max: float
    e_s: float
    n0: float
    bandwidth_hz: float
    t_max_s: float
    weights: ObjectiveWeights
    r_max: int = 16
    sigma_sq: Optional[np.ndarray] = None

    @property
    def n(self) -> int:
        return int(self.lambdas.shape[0])

    @property
    def sigmas2(self) -> np.ndarray:
        if self.sigma_sq is None:
            return np.zeros(self.n)
        return np.asarray(self.sigma_sq, dtype=np.float64)

    @property
    def snr_gain(self) -> np.ndarray:
        """Lambda_m * E_s / N0 — SNR at |h|^2 = Lambda."""
        return np.asarray(self.lambdas) * self.e_s / self.n0


# ------------------------------------------------------------ primitives

def _rate_from_beta(spec: DigitalDesignSpec, beta: np.ndarray) -> np.ndarray:
    """R = log2(1 + E_s rho^2/N0) with rho^2 = -Lambda ln beta."""
    snr = -spec.snr_gain * np.log(np.clip(beta, 1e-300, 1.0))
    return np.log2(1.0 + np.maximum(snr, 0.0))


def _latency(spec: DigitalDesignSpec, beta: np.ndarray,
             r_cont: np.ndarray) -> float:
    """Expected round latency (12) with continuous bits r'=r-1."""
    payload = 64.0 + spec.dim * (r_cont + 1.0)
    rate = np.maximum(_rate_from_beta(spec, beta), 1e-9)
    return float(np.sum(beta * payload / (spec.bandwidth_hz * rate)))


def true_objective(spec: DigitalDesignSpec, p: np.ndarray, beta: np.ndarray,
                   r_cont: np.ndarray) -> float:
    """Original objective (17a) at integer-relaxed bits r = r'+1."""
    g2 = spec.g_max ** 2
    s = (2.0 ** (r_cont + 1.0) - 1.0) ** 2
    zeta = np.sum(p ** 2 * g2 * (1.0 / beta - 1.0 + spec.dim / (beta * s)))
    zeta += np.sum(p ** 2 * spec.sigmas2)
    return spec.weights.omega_var * float(zeta) + spec.weights.omega_bias * bias_sum(p)


def _fit_latency(spec: DigitalDesignSpec, beta: np.ndarray,
                 r_cont: np.ndarray) -> np.ndarray:
    """Raise thresholds (scale rho^2) until the latency budget (17b) holds."""
    if _latency(spec, beta, r_cont) <= spec.t_max_s:
        return beta
    lo, hi = 1.0, 1.0
    while _latency(spec, beta ** hi, r_cont) > spec.t_max_s and hi < 1e6:
        hi *= 2.0
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        if _latency(spec, beta ** mid, r_cont) > spec.t_max_s:
            lo = mid
        else:
            hi = mid
    return beta ** hi


def params_from(spec: DigitalDesignSpec, p: np.ndarray, beta: np.ndarray,
                r_bits: np.ndarray) -> DigitalParams:
    beta = np.clip(beta, 1e-12, 1.0 - 1e-12)
    rhos = np.sqrt(-np.asarray(spec.lambdas) * np.log(beta))
    nus = beta / p
    return DigitalParams(rhos=rhos, nus=nus,
                         r_bits=np.asarray(r_bits, dtype=np.int64),
                         g_max=spec.g_max, dim=spec.dim,
                         energy_per_symbol=spec.e_s, noise_psd=spec.n0,
                         bandwidth_hz=spec.bandwidth_hz)


def finalize(spec: DigitalDesignSpec, p: np.ndarray, beta: np.ndarray,
             r_cont: np.ndarray) -> DigitalParams:
    """Paper's integer rule r = floor(r')+1, then re-fit latency."""
    r_bits = np.clip(np.floor(r_cont).astype(np.int64) + 1, 1, spec.r_max)
    beta = _fit_latency(spec, np.clip(beta, 1e-12, 1 - 1e-12),
                        r_bits.astype(np.float64) - 1.0)
    return params_from(spec, p, beta, r_bits)


# ---------------------------------------------------------------- anchors

def anchor_uniform(spec: DigitalDesignSpec, beta0: float = 0.8
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """p = 1/N, common beta, max bits fitting 0.9*Tmax."""
    n = spec.n
    p = np.full(n, 1.0 / n)
    beta = np.full(n, beta0)
    r_cont = np.full(n, 0.5)
    for r in range(spec.r_max - 1, 0, -1):
        cand = np.full(n, float(r) - 0.5)
        if _latency(spec, beta, cand) <= 0.9 * spec.t_max_s:
            r_cont = cand
            break
    beta = _fit_latency(spec, beta, r_cont)
    return p, beta, r_cont


def anchor_channel_weighted(spec: DigitalDesignSpec, expo: float = 0.3
                            ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Bias participation toward strong channels: p ∝ Lambda^expo."""
    p = np.asarray(spec.lambdas) ** expo
    p = p / np.sum(p)
    _, beta, r_cont = anchor_uniform(spec)
    return p, beta, r_cont


# ------------------------------------------------------------- SCA (paper)

def _pack(p, nu, r, R, z, w, t):
    return np.concatenate([p, nu, r, R, z, w, t])


def _unpack(x, n):
    return (x[:n], x[n:2 * n], x[2 * n:3 * n], x[3 * n:4 * n],
            x[4 * n:5 * n], x[5 * n:6 * n], x[6 * n:7 * n])


def design_digital_sca(spec: DigitalDesignSpec, *, n_iters: int = 12,
                       anchor: Optional[tuple] = None
                       ) -> tuple[DigitalParams, SCAResult]:
    n = spec.n
    g2 = spec.g_max ** 2
    wv, wb = spec.weights.omega_var, spec.weights.omega_bias
    s2 = spec.sigmas2
    d = float(spec.dim)
    B = spec.bandwidth_hz
    snr_gain = spec.snr_gain

    def project(x: np.ndarray) -> np.ndarray:
        p, nu, r, R, z, w, t = _unpack(x, n)
        p = simplex_projection(np.clip(p, 1e-8, 1.0))
        p = np.clip(p, 1e-10, 1.0)
        p = p / np.sum(p)
        r = np.clip(r, 0.5, spec.r_max - 1.0)
        beta = np.clip(p * np.clip(nu, 1e-9, None), 1e-9, 1.0 - 1e-9)
        beta = _fit_latency(spec, beta, r)
        nu = beta / p
        R = np.maximum(_rate_from_beta(spec, beta), 1e-6)
        t = (64.0 + d * (r + 1.0)) * beta / (B * R)
        z = p / nu
        w = p / (nu * (2.0 * 2.0 ** r - 1.0) ** 2)
        return _pack(p, nu, r, R, z, w, t)

    def true_obj(x: np.ndarray) -> float:
        p, nu, r, _R, _z, _w, _t = _unpack(x, n)
        beta = np.clip(p * nu, 1e-12, 1.0 - 1e-12)
        return true_objective(spec, p, beta, r)

    def build(xbar: np.ndarray) -> SurrogateProblem:
        pb, nub, rb, Rb, zb, wbar, tb = _unpack(xbar, n)
        payload_b = 64.0 + d + d * rb

        def f(x):
            p, nu, r, R, z, w, t = _unpack(x, n)
            return (wv * (np.sum(g2 * (z + d * w)) + np.sum(p ** 2 * s2)
                          - np.sum(g2 * pb * (2 * p - pb)))
                    + wb * np.sum((p - 1.0 / n) ** 2))

        def fgrad(x):
            p, nu, r, R, z, w, t = _unpack(x, n)
            gr = np.zeros_like(x)
            gr[:n] = wv * (2 * p * s2 - 2 * g2 * pb) + 2 * wb * (p - 1.0 / n)
            gr[4 * n:5 * n] = wv * g2
            gr[5 * n:6 * n] = wv * g2 * d
            return gr

        def cb(x):   # (18b)
            p, nu, r, R, z, w, t = _unpack(x, n)
            return np.log(z) + np.log(nu) - np.log(pb) - (p - pb) / pb

        def cbj(x):
            p, nu, r, R, z, w, t = _unpack(x, n)
            J = np.zeros((n, 7 * n))
            J[:, :n] = np.diag(-1.0 / pb)
            J[:, n:2 * n] = np.diag(1.0 / nu)
            J[:, 4 * n:5 * n] = np.diag(1.0 / z)
            return J

        def cc(x):   # (18c)
            p, nu, r, R, z, w, t = _unpack(x, n)
            u = 2.0 * 2.0 ** r - 1.0
            return (np.log(w) + np.log(nu) + 2.0 * np.log(u)
                    - np.log(pb) - (p - pb) / pb)

        def ccj(x):
            p, nu, r, R, z, w, t = _unpack(x, n)
            u = 2.0 * 2.0 ** r - 1.0
            J = np.zeros((n, 7 * n))
            J[:, :n] = np.diag(-1.0 / pb)
            J[:, n:2 * n] = np.diag(1.0 / nu)
            J[:, 2 * n:3 * n] = np.diag(2.0 * (2.0 * 2.0 ** r * _LN2) / u)
            J[:, 5 * n:6 * n] = np.diag(1.0 / w)
            return J

        def cd(x):   # (18d) latency per-device epigraph
            p, nu, r, R, z, w, t = _unpack(x, n)
            lhs = (np.log(nub) + np.log(payload_b) + np.log(pb)
                   + (nu - nub) / nub + d * (r - rb) / payload_b
                   + (p - pb) / pb)
            return np.log(t) + np.log(R * B) - lhs

        def cdj(x):
            p, nu, r, R, z, w, t = _unpack(x, n)
            J = np.zeros((n, 7 * n))
            J[:, :n] = np.diag(-1.0 / pb)
            J[:, n:2 * n] = np.diag(-1.0 / nub)
            J[:, 2 * n:3 * n] = np.diag(-d / payload_b)
            J[:, 3 * n:4 * n] = np.diag(1.0 / R)
            J[:, 6 * n:7 * n] = np.diag(1.0 / t)
            return J

        def ce(x):   # (18e) rate-SNR coupling
            p, nu, r, R, z, w, t = _unpack(x, n)
            lin = np.log(nub) + nu / nub + np.log(pb) + p / pb - 2.0
            return 1.0 - snr_gain * lin - 2.0 ** R

        def cej(x):
            p, nu, r, R, z, w, t = _unpack(x, n)
            J = np.zeros((n, 7 * n))
            J[:, :n] = np.diag(-snr_gain / pb)
            J[:, n:2 * n] = np.diag(-snr_gain / nub)
            J[:, 3 * n:4 * n] = np.diag(-(2.0 ** R) * _LN2)
            return J

        def cf(x):   # (18f)
            return np.array([spec.t_max_s - np.sum(_unpack(x, n)[6])])

        def cfj(x):
            J = np.zeros((1, 7 * n))
            J[0, 6 * n:7 * n] = -1.0
            return J

        def cg(x):   # (18g) nu <= (2 pb - p)/pb^2
            p, nu, r, R, z, w, t = _unpack(x, n)
            return (2.0 * pb - p) / pb ** 2 - nu

        def cgj(x):
            J = np.zeros((n, 7 * n))
            J[:, :n] = np.diag(-1.0 / pb ** 2)
            J[:, n:2 * n] = -np.eye(n)
            return J

        def eq(x):
            return np.array([np.sum(x[:n]) - 1.0])

        def eqj(x):
            J = np.zeros((1, 7 * n))
            J[0, :n] = 1.0
            return J

        bnds = ([(1e-8, 1.0)] * n                       # p
                + [(1e-6, 4.0 * n)] * n                 # nu
                + [(0.5, spec.r_max - 1.0)] * n         # r'
                + [(1e-3, 40.0)] * n                    # R
                + [(1e-12, 2.0)] * n                    # z
                + [(1e-16, 2.0)] * n                    # varpi
                + [(1e-9, spec.t_max_s)] * n)           # t
        return SurrogateProblem(
            objective=f, grad=fgrad,
            ineq_constraints=[
                {"type": "ineq", "fun": cb, "jac": cbj},
                {"type": "ineq", "fun": cc, "jac": ccj},
                {"type": "ineq", "fun": cd, "jac": cdj},
                {"type": "ineq", "fun": ce, "jac": cej},
                {"type": "ineq", "fun": cf, "jac": cfj},
                {"type": "ineq", "fun": cg, "jac": cgj},
            ],
            eq_constraints=[{"type": "eq", "fun": eq, "jac": eqj}],
            bounds=bnds, x0=xbar.copy())

    if anchor is None:
        anchor = anchor_uniform(spec)
    p0, beta0, r0 = anchor
    nu0 = beta0 / p0
    R0 = np.maximum(_rate_from_beta(spec, beta0), 1e-6) * (1.0 - 1e-9)
    t0 = (64.0 + d * (r0 + 1.0)) * beta0 / (B * R0)
    z0 = p0 / nu0
    w0 = p0 / (nu0 * (2.0 * 2.0 ** r0 - 1.0) ** 2)
    x0 = _pack(p0, nu0, r0, R0, z0, w0, t0)
    res = run_sca(build, true_obj, project, x0, n_iters=n_iters)
    p, nu, r, _, _, _, _ = _unpack(res.x, n)
    beta = np.clip(p * nu, 1e-12, 1 - 1e-12)
    return finalize(spec, p, beta, r), res


# -------------------------------------------------------- direct (beyond)

def design_digital_direct(spec: DigitalDesignSpec, *, maxiter: int = 400
                          ) -> tuple[DigitalParams, float]:
    """Beyond-paper: SLSQP on the original (17) over (p, beta, r')."""
    n = spec.n
    d = float(spec.dim)
    B = spec.bandwidth_hz

    def split(x):
        return x[:n], np.clip(x[n:2 * n], 1e-9, 1 - 1e-9), x[2 * n:3 * n]

    def f(x):
        p, beta, r = split(x)
        return true_objective(spec, p, beta, r)

    def lat(x):
        p, beta, r = split(x)
        return np.array([spec.t_max_s - _latency(spec, beta, r)])

    def eq(x):
        return np.array([np.sum(x[:n]) - 1.0])

    def solve_from(p0, b0, r0):
        x0 = np.concatenate([p0, b0, r0])
        scale = 1.0 / max(abs(f(x0)), 1e-30)
        # anchor betas from _fit_latency can undershoot the box (SLSQP
        # would clip internally, warning); the scale above is evaluated at
        # the raw anchor so the explicit clip is solution-preserving
        lo = np.array([1e-8] * n + [1e-6] * n + [0.5] * n)
        hi = np.array([1.0] * n + [1 - 1e-9] * n + [spec.r_max - 1.0] * n)
        x0 = np.clip(x0, lo, hi)
        res = optimize.minimize(
            lambda x: scale * f(x), x0, method="SLSQP",
            bounds=([(1e-8, 1.0)] * n + [(1e-6, 1 - 1e-9)] * n
                    + [(0.5, spec.r_max - 1.0)] * n),
            constraints=[{"type": "ineq", "fun": lat},
                         {"type": "eq", "fun": eq}],
            options={"maxiter": maxiter, "ftol": 1e-14})
        return res.fun / scale, res.x

    # anchors: uniform, channel-weighted, and a few bit-widths with fitted
    # thresholds — the reduced problem is still non-convex and SLSQP is local
    anchors = [anchor_uniform(spec), anchor_channel_weighted(spec)]
    for r_try in (4.5, 7.5, 10.5):
        b0 = _fit_latency(spec, np.full(n, 0.5), np.full(n, r_try))
        anchors.append((np.full(n, 1.0 / n), b0, np.full(n, r_try)))
    best_x, best_f = None, np.inf
    for p0, b0, r0 in anchors:
        fv, xv = solve_from(p0, b0, r0)
        if fv < best_f and np.all(np.isfinite(xv)):
            best_f, best_x = float(fv), xv
    p, beta, r = split(best_x)
    p = simplex_projection(p)
    p = np.clip(p, 1e-10, 1)
    p /= p.sum()
    return finalize(spec, p, beta, r), best_f


# ----------------------------------------------------- batched (torch)

def default_anchors(spec: DigitalDesignSpec) -> np.ndarray:
    """(A, 3N) packed (p, beta, r') anchors: the direct solver's set."""
    n = spec.n
    anchors = [anchor_uniform(spec), anchor_channel_weighted(spec)]
    for r_try in (4.5, 7.5, 10.5):
        b0 = _fit_latency(spec, np.full(n, 0.5), np.full(n, r_try))
        anchors.append((np.full(n, 1.0 / n), b0, np.full(n, r_try)))
    return np.stack([np.concatenate(a) for a in anchors])


def stack_digital_specs(specs: Sequence[DigitalDesignSpec]) -> dict:
    """Stack B design specs along a leading axis for the batched solver."""
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
        "bandwidth_hz": np.array([s.bandwidth_hz for s in specs]),
        "t_max_s": np.array([s.t_max_s for s in specs]),
        "r_max": np.array([float(s.r_max) for s in specs]),
        "omega_var": np.array([s.weights.omega_var for s in specs]),
        "omega_bias": np.array([s.weights.omega_bias for s in specs]),
        "sigma_sq": np.stack([s.sigmas2 for s in specs]),
    }


def design_digital_batch(specs: Sequence[DigitalDesignSpec],
                         anchors: Optional[np.ndarray] = None, *,
                         device=None
                         ) -> tuple[list[DigitalParams], np.ndarray]:
    """Solve a grid of digital design problems (17) at once, on the card
    unless ``device`` says otherwise.

    The batched counterpart of calling ``design_digital_sca`` per point:
    penalty/projection Adam on the reduced variables (p, beta, r') with
    the latency budget (17b) restored exactly after every stage
    (``core.sca_torch``). Per-point params go through the same
    ``finalize`` integer-bits rule as the SciPy solvers.

    Returns (params, objectives): per-point ``DigitalParams`` and the (B,)
    continuous-relaxed true objectives (17a) — the same convention as
    ``design_digital_sca``'s ``SCAResult.objective``.
    """
    if anchors is None:
        anchors = np.stack([default_anchors(s) for s in specs])
    stk = stack_digital_specs(specs)
    xs, objs = sca_torch.solve_digital_batch(
        stk["lambdas"], stk["dim"], stk["g_max"], stk["e_s"], stk["n0"],
        stk["bandwidth_hz"], stk["t_max_s"], stk["r_max"],
        stk["omega_var"], stk["omega_bias"], stk["sigma_sq"], anchors,
        device=device)
    n = specs[0].n
    params = []
    for s, x in zip(specs, xs):
        p, beta, r = x[:n], x[n:2 * n], x[2 * n:]
        params.append(finalize(s, p, np.clip(beta, 1e-12, 1 - 1e-12), r))
    return params, objs


def design_digital_participation(spec: DigitalDesignSpec,
                                 params: DigitalParams, clients: int, *,
                                 survival=None, device=None
                                 ) -> tuple[np.ndarray, float]:
    """Co-designed Bernoulli inclusion probabilities pi, digital family.

    Same sampling problem as ``ota_design.design_ota_participation`` but
    with the digital scheme's effective levels ``p_m = beta_m/nu_m``
    (``DigitalParams.participation_levels``). Returns (pi, objective).
    """
    p = np.asarray(params.participation_levels(spec.lambdas), np.float64)
    q = (np.ones_like(p) if survival is None
         else np.asarray(survival, np.float64))
    pi, obj = sca_torch.solve_participation_batch(
        p[None], q[None], [clients],
        [spec.weights.omega_var], [spec.weights.omega_bias], device=device)
    return pi[0], float(obj[0])
