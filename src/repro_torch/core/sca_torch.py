"""Batched Sec.-IV design solver in float64 torch — counterpart of
``repro.core.sca_jax``.

The reference solves a whole sweep grid in one ``jit(vmap(...))``. Here
every problem of the grid and every anchor of each problem is a slice of
one float64 tensor: per-point inputs carry a leading batch dimension B,
iterates are (B, A, K) with A anchors, and per-problem values (objectives,
bisection brackets) are kept as (B, A, 1). ``lax.scan`` becomes a Python
loop, ``lax.while_loop`` under ``vmap`` a masked loop that runs until the
last lane is done, and ``jax.value_and_grad`` is ``torch.autograd.grad``
of the summed objective: the (B, A) problems are independent, so the
sum's gradient is each problem's own.

  * OTA (15): projected Adam on the gamma-only reduction of
    ``ota_design.design_ota_direct``, in SCA-style stages of decreasing
    step size, each re-anchored at the best iterate.
  * Digital (17): projected Adam on (p, beta, r') with the latency
    budget (17b) as a hinge penalty whose weight grows stage by stage;
    after each stage the iterate is projected to exact feasibility
    (simplex p, thresholds raised by bisection until (17b) holds) and the
    true objective (17a) of the feasible point is tracked.
  * Participation and buffered-async co-design: projected Adam on the
    capped simplex.

What JAX does and torch does not, reproduced here: ``jnp.median`` of an
even count is the mean of the two middle values (``torch.median`` takes
the lower one), and ``jnp.clip`` is ``minimum(maximum(x, lo), hi)``,
whose gradient splits a tie in half (``torch.clamp`` passes all of it);
every clip inside a differentiated objective goes through :func:`clip`.

Each ``solve_*`` takes ``device=None`` (the card; ``"cpu"`` for the
plain CPU run) and returns NumPy arrays, as the reference does. The
tensors are tiny ((B, A, N) with N in the tens), so on the card the
solver is bound by its launches, not by the device's arithmetic.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .digital import INV_LN2

# Inner-solver schedule (verbatim from the reference): SCA-style outer
# stages (re-anchor at the best iterate, shrink the step) x Adam steps
# per stage. The variables are pre-scaled to O(1), so the rates are
# problem-independent.
_OTA_LRS = (0.1, 0.03, 0.01, 0.003)
_OTA_STEPS = 300
# Digital: penalty escalation mu_k with matching step-size decay.
_DIG_MUS = (1.0, 10.0, 100.0, 1e3, 1e4)
_DIG_LRS = (0.05, 0.02, 0.01, 0.005, 0.002)
_DIG_STEPS = 400
# Participation co-design: projected Adam on the capped simplex.
_PART_LRS = (0.1, 0.03, 0.01)
_PART_STEPS = 300
_PART_PI_MIN = 1e-6

_B1, _B2, _ADAM_EPS = 0.9, 0.999, 1e-12

f64 = torch.float64


def clip(x: torch.Tensor, lo: torch.Tensor,
         hi: torch.Tensor) -> torch.Tensor:
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``. At a tie with an
    edge the gradient is half of x's, as JAX's is (``torch.maximum`` and
    ``torch.minimum`` split ties as JAX does; ``torch.clamp`` does not)."""
    return torch.minimum(torch.maximum(x, lo), hi)


def median(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` over the last axis, kept: (lo + hi) * 0.5 of the two
    middle values of the sorted row (the same value twice for odd n)."""
    n = x.shape[-1]
    u = torch.sort(x, dim=-1).values
    return (u[..., (n - 1) // 2:(n - 1) // 2 + 1]
            + u[..., n // 2:n // 2 + 1]) * 0.5


def simplex_projection(v: torch.Tensor) -> torch.Tensor:
    """Euclidean projection onto the probability simplex over the last
    axis (``sca_jax.simplex_projection_jax``): sort descending, rho the
    last index where u * (k + 1) > cumsum(u) - 1 holds."""
    n = v.shape[-1]
    u = torch.sort(v, dim=-1, descending=True).values
    css = torch.cumsum(u, dim=-1)
    k = torch.arange(n, device=v.device)
    cond = u * (k + 1).to(v.dtype) > (css - 1.0)
    rho = torch.where(cond, k, -1).amax(dim=-1, keepdim=True)
    theta = (torch.gather(css, -1, rho) - 1.0) / (rho + 1).to(v.dtype)
    return torch.clamp_min(v - theta, 0.0)


def capped_simplex_projection(v: torch.Tensor, s, lo=_PART_PI_MIN,
                              hi=1.0) -> torch.Tensor:
    """Euclidean projection onto {sum x = s, lo <= x <= hi} over the last
    axis (``sca_jax.capped_simplex_projection_jax``): 100 halvings of the
    dual shift tau in ``x = clip(v - tau, lo, hi)``, bracketed by
    [min(v) - hi, max(v) - lo]. ``s`` broadcasts against v[..., :1]."""
    lo_t = v.amin(dim=-1, keepdim=True) - hi
    hi_t = v.amax(dim=-1, keepdim=True) - lo
    for _ in range(100):
        mid = 0.5 * (lo_t + hi_t)
        over = torch.clamp(v - mid, lo, hi).sum(dim=-1, keepdim=True) > s
        lo_t, hi_t = torch.where(over, mid, lo_t), torch.where(over, hi_t,
                                                                mid)
    return torch.clamp(v - hi_t, lo, hi)


def value_and_grad(obj):
    """``jax.value_and_grad`` over a batch of independent problems:
    ``obj`` maps (..., K) iterates to (..., 1) values; the gradient is
    that of their sum."""
    def vg(x):
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            f = obj(x)
            (g,) = torch.autograd.grad(f.sum(), x)
        return f.detach(), g
    return vg


def _bias_corrections(n_steps: int, device) -> tuple:
    """1 - B1^(i+1) and 1 - B2^(i+1) for i < n_steps, formed in f64 on
    the device as the reference's traced pow is."""
    i1 = torch.arange(1, n_steps + 1, dtype=f64, device=device)
    return (1.0 - torch.pow(torch.tensor(_B1, dtype=f64, device=device), i1),
            1.0 - torch.pow(torch.tensor(_B2, dtype=f64, device=device), i1))


def _adam_descent(vg, x0, project, *, lr, n_steps, track_best):
    """``n_steps`` of Adam on ``vg`` (a :func:`value_and_grad`) from fresh
    moments, each iterate projected:
    onto a box by clipping (OTA, digital: ``sca_jax._adam_descent``) or
    onto the capped simplex (the co-design solvers' inlined loop).

    ``track_best=True`` also keeps the best objective seen at the
    (already projected) iterates, starting from x0's; otherwise the
    returned best is (x0, None) and x0 is not evaluated.
    """
    c1, c2 = _bias_corrections(n_steps, x0.device)
    x, m, v = x0, torch.zeros_like(x0), torch.zeros_like(x0)
    bx, bf = x0, (vg(x0)[0] if track_best else None)
    for i in range(n_steps):
        f, g = vg(x)
        if track_best:
            bx = torch.where(f < bf, x, bx)
            bf = torch.minimum(f, bf)
        m = _B1 * m + (1.0 - _B1) * g
        v = _B2 * v + (1.0 - _B2) * g * g
        mhat = m / c1[i]
        vhat = v / c2[i]
        x = project(x - lr * mhat / (torch.sqrt(vhat) + _ADAM_EPS))
    return x, bx, bf


def _box(lo: torch.Tensor, hi: torch.Tensor):
    return lambda x: torch.clamp(x, lo, hi)


def _pick(bx: torch.Tensor, bf: torch.Tensor):
    """The best anchor of each point: (B, A, K), (B, A, 1) -> (B, K), (B,)
    (the first minimum, as ``jnp.argmin``)."""
    i = torch.argmin(bf[..., 0], dim=-1)
    b = torch.arange(bx.shape[0], device=bx.device)
    return bx[b, i], bf[b, i, 0]


def _inputs(device, *arrays):
    dev = resolve_device(device)
    return [torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev)
            for a in arrays]


def _point(x: torch.Tensor) -> torch.Tensor:
    """(B,) per-point scalars -> (B, 1, 1); (B, N) -> (B, 1, N)."""
    return x.reshape(x.shape[0], 1, -1)


# -------------------------------------------- participation co-design

def _solve_capped(obj, proj, anchors):
    """Projected Adam stages from every anchor at once, each stage from
    fresh moments and re-anchored at the best; the best anchor wins."""
    vg = value_and_grad(obj)
    scale = 1.0 / torch.clamp_min(torch.abs(obj(anchors[:, :1])), 1e-30)

    def scaled_vg(x):
        f, g = vg(x)
        return f, g * scale

    x, bx, bf = anchors, anchors, obj(anchors)
    for lr in _PART_LRS:
        x, _, _ = _adam_descent(scaled_vg, x, proj, lr=lr,
                                n_steps=_PART_STEPS, track_best=False)
        f = obj(x)
        bx = torch.where(f < bf, x, bx)
        bf = torch.minimum(f, bf)
        x = bx                                   # re-anchor at the best
    return _pick(bx, bf)


def solve_participation_batch(p, q, clients, omega_var, omega_bias, *,
                              device=None):
    """Participation co-design on a batch (``sca_jax.
    solve_participation_batch``): Bernoulli inclusion probabilities pi on
    the capped simplex {sum pi = S, pi_min <= pi <= 1} minimising

        omega_bias * sum (e - 1/N)^2 + omega_var / (sum e)^2,
        e = p * pi * q * (N / S),

    from three anchors (uniform, proportional to p*q, to sqrt(p*q)).

    Args (leading batch axis B; N devices): p, q (B, N); clients,
    omega_var, omega_bias (B,).

    Returns:
      (pi (B, N), objectives (B,)) as float64 NumPy arrays.
    """
    p, q, s, wv, wb = _inputs(device, p, q, clients, omega_var,
                              omega_bias)
    n = p.shape[-1]
    p, q, s, wv, wb = map(_point, (p, q, s, wv, wb))
    w = torch.clamp_min(p * q, 1e-30)

    def obj(pi):
        e = (n / s) * w * pi
        return (wb * torch.sum((e - 1.0 / n) ** 2, -1, keepdim=True)
                + wv / torch.sum(e, -1, keepdim=True) ** 2)

    proj = lambda x: capped_simplex_projection(x, s)      # noqa: E731
    sw = torch.sqrt(w)
    anchors = torch.cat([
        (s / n).expand_as(w),
        proj(w * (s / torch.sum(w, -1, keepdim=True))),
        proj(sw * (s / torch.sum(sw, -1, keepdim=True)))], dim=1)
    pi, f = _solve_capped(obj, proj, anchors)
    return pi.cpu().numpy(), f.cpu().numpy()


def solve_async_batch(p, c, sbar, omega_var, omega_bias, *, device=None):
    """Buffered-async weight co-design on a batch (``sca_jax.
    solve_async_batch``): PS per-device weights v on {sum v = N,
    v_min <= v <= N} minimising

        omega_bias * sum (e - 1/N)^2
        + omega_var * (1/(sum e)^2 + sum e^2 * sbar),
        e = p * c * v * (N / sum(c v)),

    from three anchors (uniform, inverse delivery weight, inverse
    expected staleness).

    Args (leading batch axis B; N devices): p, c, sbar (B, N);
    omega_var, omega_bias (B,).

    Returns:
      (v (B, N), objectives (B,)) as float64 NumPy arrays.
    """
    p, c, sbar, wv, wb = _inputs(device, p, c, sbar, omega_var,
                                 omega_bias)
    n = p.shape[-1]
    p, c, sbar, wv, wb = map(_point, (p, c, sbar, wv, wb))
    cw = torch.clamp_min(c, 1e-30)

    def obj(v):
        e = p * cw * v * (n / torch.sum(cw * v, -1, keepdim=True))
        return (wb * torch.sum((e - 1.0 / n) ** 2, -1, keepdim=True)
                + wv * (1.0 / torch.sum(e, -1, keepdim=True) ** 2
                        + torch.sum(e ** 2 * sbar, -1, keepdim=True)))

    proj = lambda x: capped_simplex_projection(      # noqa: E731
        x, 1.0 * n, hi=1.0 * n)
    inv_c = 1.0 / cw
    inv_s = 1.0 / (1.0 + sbar)
    anchors = torch.cat([
        torch.ones_like(cw),
        proj(inv_c * (n / torch.sum(inv_c, -1, keepdim=True))),
        proj(inv_s * (n / torch.sum(inv_s, -1, keepdim=True)))], dim=1)
    v, f = _solve_capped(obj, proj, anchors)
    return v.cpu().numpy(), f.cpu().numpy()


# ------------------------------------------------------------- OTA (15)

class OTAProblem:
    """A batch of OTA design points (15) as tensors, per-point values
    (B, 1, 1), per-device (B, 1, N): the gamma-reduced objective (15a) on
    scaled iterates gs = gamma / u_g, its box [lo, hi] and u_g."""

    def __init__(self, lam, dim, g_max, e_s, n0, wv, wb, s2):
        self.n = lam.shape[-1]
        self.dim, self.n0, self.wv, self.wb, self.s2 = dim, n0, wv, wb, s2
        self.c = g_max ** 2 / (dim * lam * e_s)
        gmax = torch.sqrt(lam * dim * e_s / (2.0 * g_max ** 2))
        self.u_g = median(gmax)                  # O(1) scaling, as the oracle
        self.g2 = g_max ** 2
        self.lo = torch.tensor(1e-6, dtype=f64, device=lam.device)
        self.hi = gmax / self.u_g
        self.cap = torch.tensor(700.0, dtype=f64, device=lam.device)

    def obj(self, gs: torch.Tensor) -> torch.Tensor:
        """(15a) at gamma = gs * u_g: (B, A, N) -> (B, A, 1)."""
        gam = gs * self.u_g
        x = self.c * gam ** 2
        a = gam * torch.exp(-x)
        alpha = torch.sum(a, -1, keepdim=True)
        p = a / alpha
        # exp clip mirrors true_objective_from_gamma's overflow guard
        trans = torch.sum(p ** 2 * self.g2 * (torch.exp(torch.minimum(
            x, self.cap)) - 1.0), -1, keepdim=True)
        noise = self.dim * self.n0 / alpha ** 2
        return (self.wv * (trans + torch.sum(p ** 2 * self.s2, -1,
                                             keepdim=True) + noise)
                + self.wb * torch.sum((p - 1.0 / self.n) ** 2, -1,
                                      keepdim=True))


def solve_ota_gamma_batch(lambdas, dim, g_max, e_s, n0, omega_var,
                          omega_bias, sigma_sq, anchors, *, device=None):
    """Solve a batch of OTA design problems (15) (``sca_jax.
    solve_ota_gamma_batch``).

    Args (leading batch axis B everywhere; N devices, A anchors):
      lambdas (B, N), dim/g_max/e_s/n0/omega_var/omega_bias (B,),
      sigma_sq (B, N), anchors (B, A, N) gamma starting points.

    Returns:
      (gammas (B, N), objectives (B,)): the designed pre-scalers and the
      true objectives (15a) at the physically coupled points, float64
      NumPy arrays.
    """
    *point, anchors = _inputs(device, lambdas, dim, g_max, e_s, n0,
                              omega_var, omega_bias, sigma_sq, anchors)
    prob = OTAProblem(*map(_point, point))
    box = _box(prob.lo, prob.hi)
    vg = value_and_grad(prob.obj)
    scale = 1.0 / torch.clamp_min(torch.abs(prob.obj(box(
        anchors[:, :1] / prob.u_g))), 1e-30)

    def scaled_vg(x):
        f, g = vg(x)
        return f, g * scale                      # scale-free Adam steps

    x = box(anchors / prob.u_g)
    bx, bf = x, prob.obj(x)
    for lr in _OTA_LRS:
        _, sbx, sbf = _adam_descent(scaled_vg, x, box, lr=lr,
                                    n_steps=_OTA_STEPS, track_best=True)
        bx = torch.where(sbf < bf, sbx, bx)
        bf = torch.minimum(sbf, bf)
        x = bx                                   # re-anchor at the best
    gam, f = _pick(bx, bf)
    return (gam * prob.u_g[:, 0]).cpu().numpy(), f.cpu().numpy()


# --------------------------------------------------------- digital (17)

class DigitalProblem:
    """A batch of digital design points (17) as tensors, per-point values
    (B, 1, 1), per-device (B, 1, N): the latency model (12), its
    threshold re-fit, the true objective (17a), the feasibility
    projection and the penalised objective on packed (p, beta, r')
    iterates, and their Adam box [lo, hi]."""

    def __init__(self, lam, dim, g_max, e_s, n0, bw, t_max, r_max, wv, wb,
                 s2):
        self.n = lam.shape[-1]
        self.dim, self.bw, self.t_max, self.r_max = dim, bw, t_max, r_max
        self.wv, self.wb, self.s2 = wv, wb, s2
        self.g2 = g_max ** 2
        self.snr_gain = lam * e_s / n0
        const = lambda v: torch.tensor(v, dtype=f64,      # noqa: E731
                                       device=lam.device)
        self.rate_floor, self.zero = const(1e-9), const(0.0)
        self.beta_lo, self.beta_hi = const(1e-9), const(1.0 - 1e-9)
        ones = torch.ones_like(lam)
        self.lo = torch.cat([ones * 1e-8, ones * 1e-6, ones * 0.5], dim=-1)
        self.hi = torch.cat([ones, ones * (1.0 - 1e-9), ones * (r_max - 1.0)],
                            dim=-1)

    def latency(self, nlb_s, r):
        """Expected latency (12) from nlb_s = -ln(beta_s) (rho^2/Lambda)."""
        rate = torch.maximum(
            torch.log(1.0 + self.snr_gain * nlb_s) * INV_LN2, self.rate_floor)
        payload = 64.0 + self.dim * (r + 1.0)
        return torch.sum(torch.exp(-nlb_s) * payload / (self.bw * rate), -1,
                         keepdim=True)

    def fit_latency(self, beta, r):
        """Raise thresholds (beta -> beta**s) until (17b) holds: the
        reference's bisection on s in [1, 1e6] on the log scale, each lane
        frozen once its own bracket closes ((hi - lo) <= 1e-12 hi), as a
        batched ``lax.while_loop`` leaves a finished lane's carry alone."""
        nlb = -torch.log(torch.clamp(beta, 1e-300, 1.0))
        feasible = self.latency(nlb, r) <= self.t_max
        lo_s = torch.ones_like(feasible, dtype=f64)
        hi_s = torch.full_like(lo_s, 1e6)
        active = (hi_s - lo_s) > 1e-12 * hi_s
        while bool(active.any()):
            mid = 0.5 * (lo_s + hi_s)
            bad = self.latency(mid * nlb, r) > self.t_max
            lo_s = torch.where(active & bad, mid, lo_s)
            hi_s = torch.where(active & ~bad, mid, hi_s)
            active = (hi_s - lo_s) > 1e-12 * hi_s
        s = torch.where(feasible, 1.0, hi_s)     # oracle keeps the hi end
        return torch.exp(-s * nlb)

    def true_obj(self, p, beta, r):
        """(17a) at integer-relaxed bits r = r'+1 (= oracle convention)."""
        s = (2.0 ** (r + 1.0) - 1.0) ** 2
        zeta = (torch.sum(p ** 2 * self.g2 * (1.0 / beta - 1.0
                                              + self.dim / (beta * s)), -1,
                          keepdim=True)
                + torch.sum(p ** 2 * self.s2, -1, keepdim=True))
        return self.wv * zeta + self.wb * torch.sum(
            (p - 1.0 / self.n) ** 2, -1, keepdim=True)

    def split(self, x):
        n = self.n
        return x[..., :n], x[..., n:2 * n], x[..., 2 * n:]

    def project(self, x):
        """Exact feasibility: simplex p, latency-fitted beta, boxed r."""
        p, beta, r = self.split(x)
        p = simplex_projection(torch.clamp(p, 1e-8, 1.0))
        p = torch.clamp(p, 1e-10, 1.0)
        p = p / torch.sum(p, -1, keepdim=True)
        r = torch.minimum(torch.clamp_min(r, 0.5), self.r_max - 1.0)
        beta = self.fit_latency(torch.clamp(beta, 1e-9, 1.0 - 1e-9), r)
        return torch.cat([p, beta, r], dim=-1)

    def pen_obj(self, x, mu, scale):
        """scale * (17a) + mu * (latency hinge^2 + (sum p - 1)^2)."""
        p, beta, r = self.split(x)
        beta = clip(beta, self.beta_lo, self.beta_hi)
        hinge = torch.maximum(
            self.latency(-torch.log(beta), r) / self.t_max - 1.0, self.zero)
        psum = torch.sum(p, -1, keepdim=True) - 1.0
        return (scale * self.true_obj(p, beta, r)
                + mu * (hinge ** 2 + psum ** 2))


def solve_digital_batch(lambdas, dim, g_max, e_s, n0, bandwidth_hz,
                        t_max_s, r_max, omega_var, omega_bias, sigma_sq,
                        anchors, *, device=None):
    """Solve a batch of digital design problems (17) (``sca_jax.
    solve_digital_batch``).

    Args (leading batch axis B; N devices, A anchors): lambdas (B, N),
    scalars (B,), sigma_sq (B, N), anchors (B, A, 3N) packed
    (p, beta, r').

    Returns:
      (x (B, 3N), objectives (B,)): feasible packed solutions and the
      true objectives (17a) at the continuous (integer-relaxed) points,
      float64 NumPy arrays.
    """
    *point, anchors = _inputs(device, lambdas, dim, g_max, e_s, n0,
                              bandwidth_hz, t_max_s, r_max, omega_var,
                              omega_bias, sigma_sq, anchors)
    prob = DigitalProblem(*map(_point, point))
    box = _box(prob.lo, prob.hi)
    x = prob.project(box(anchors))
    bx, bf = x, prob.true_obj(*prob.split(x))
    scale = 1.0 / torch.clamp_min(torch.abs(bf), 1e-30)
    for mu, lr in zip(_DIG_MUS, _DIG_LRS):
        vg = value_and_grad(lambda y, mu=mu: prob.pen_obj(y, mu, scale))
        x, _, _ = _adam_descent(vg, x, box, lr=lr, n_steps=_DIG_STEPS,
                                track_best=False)
        x = prob.project(x)
        f = prob.true_obj(*prob.split(x))
        bx = torch.where(f < bf, x, bx)
        bf = torch.minimum(f, bf)
    xb, f = _pick(bx, bf)
    return xb.cpu().numpy(), f.cpu().numpy()
