"""The batched design solver's pieces (``repro_torch.core.sca_torch``)
against the reference's (``repro.core.sca_jax``), on the CPU.

Projections: the simplex one bit-equal, the capped one within 1 ulp of
its bracket's scale (XLA and torch add its sums in another order). One Adam
stage of the OTA solve within 1e-12 relative. The even-N median, the
clip's half gradient at an edge, and the batched latency bisection (each
lane frozen on its own step) as JAX computes them.
"""
import numpy as np
import pytest
import torch

from _torch_reference import one_thread, ref  # noqa: F401  (fixtures)
from repro_torch.core import digital_design, ota_design, sca_torch
from repro_torch.core.bounds import ObjectiveWeights
from repro_torch.core.channel import WirelessConfig, make_deployment

pytestmark = pytest.mark.usefixtures("one_thread")

f64 = torch.float64


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


def _simplex_inputs():
    rng = np.random.default_rng(0)
    yield rng.normal(size=(16, 10))                    # random batch
    yield rng.normal(size=(4, 50)) * 10
    yield np.array([[0.3, 0.3, 0.3, 0.3], [1.0, 1.0, 0.0, 0.0],
                    [0.25, 0.25, 0.25, 0.25]])          # ties
    yield -np.abs(rng.normal(size=(5, 7))) - 0.1       # all negative
    yield rng.normal(size=(6, 1))                      # N = 1


@pytest.mark.parametrize("v", list(_simplex_inputs()),
                         ids=["random10", "random50", "ties", "negative",
                              "n1"])
def test_simplex_projection_matches_reference(ref, v):
    jnp = ref.jax.numpy
    with ref.jax.enable_x64(True):
        want = np.asarray(ref.jax.vmap(ref.sca_jax.simplex_projection_jax)(
            jnp.asarray(v)))
    got = sca_torch.simplex_projection(_t(v)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-12)
    assert np.all(got >= 0)


def _capped_inputs():
    rng = np.random.default_rng(1)
    yield rng.uniform(0, 1, (8, 10)), np.full(8, 3.0), 1.0
    yield rng.normal(size=(4, 20)), np.array([1.0, 5.0, 10.0, 19.5]), 1.0
    # sums that hit the caps: s = N (every entry at hi) and s = N lo
    yield rng.normal(size=(2, 6)), np.array([6.0, 6 * 1e-6]), 1.0
    yield rng.uniform(0, 3, (3, 10)), np.full(3, 10.0), 10.0   # async's cap
    yield np.full((2, 5), 0.4), np.array([2.0, 1.0]), 1.0     # ties


@pytest.mark.parametrize("v,s,hi", list(_capped_inputs()),
                         ids=["random", "wide", "caps", "async", "ties"])
def test_capped_simplex_projection_matches_reference(ref, v, s, hi):
    jnp = ref.jax.numpy
    proj = lambda x, t: ref.sca_jax.capped_simplex_projection_jax(  # noqa
        x, t, hi=hi)
    with ref.jax.enable_x64(True):
        want = np.asarray(ref.jax.vmap(proj)(jnp.asarray(v),
                                             jnp.asarray(s)))
    got = sca_torch.capped_simplex_projection(_t(v), _t(s)[:, None],
                                              hi=hi).numpy()
    # each halving compares a sum of clipped entries with s, and XLA and
    # torch add that sum in another order: a comparison near the root can
    # go the other way, moving tau by the bracket's last width, so entries
    # lie within 1 ulp of max(|v|, hi) (the bracket's scale)
    tol = np.spacing(np.maximum(np.abs(v).max(-1, keepdims=True), hi))
    assert np.all(np.abs(got - want) <= tol)
    np.testing.assert_allclose(got.sum(-1), s, rtol=1e-9)
    assert np.all(got >= 1e-6) and np.all(got <= hi)


@pytest.fixture(scope="module")
def fig2_ota(ref):
    """Fig. 2's OTA spec at N = 10 (seed 1) in both packages."""
    dep = make_deployment(WirelessConfig(n_devices=10, seed=1))
    cfg = dep.cfg
    w = ObjectiveWeights.strongly_convex(eta=0.5 / (0.01 + 2.01), mu=0.01,
                                         kappa_sc=3.0, n=10)
    return ota_design.OTADesignSpec(
        lambdas=dep.lambdas, dim=7850, g_max=20.0, e_s=cfg.energy_per_symbol,
        n0=cfg.noise_power, weights=w)


def test_median_of_an_even_count_is_the_midpoint(ref, fig2_ota):
    gmax = fig2_ota.gamma_max()
    assert gmax.shape == (10,)
    got = float(sca_torch.median(_t(gmax)[None])[0, 0])
    with ref.jax.enable_x64(True):
        want = float(ref.jax.numpy.median(ref.jax.numpy.asarray(gmax)))
    assert got == want == float(np.median(gmax))
    assert got == pytest.approx(1.29359e-10, rel=1e-5)
    # torch's own median takes the lower middle value
    assert float(torch.median(_t(gmax))) == pytest.approx(1.22612e-10,
                                                          rel=1e-5)
    rng = np.random.default_rng(2)
    for n in (1, 2, 7, 50):
        x = rng.normal(size=(3, n))
        with ref.jax.enable_x64(True):
            want = np.asarray(ref.jax.numpy.median(
                ref.jax.numpy.asarray(x), axis=-1))
        np.testing.assert_array_equal(sca_torch.median(_t(x))[:, 0], want)


def test_clip_gradient_at_the_edge_is_half(ref):
    hi = 1.0 - 1e-9
    jnp = ref.jax.numpy
    with ref.jax.enable_x64(True):
        want = float(ref.jax.grad(
            lambda x: jnp.clip(x, 1e-9, hi) ** 2)(jnp.float64(hi)))
    lo_t, hi_t = torch.tensor(1e-9, dtype=f64), torch.tensor(hi, dtype=f64)
    x = torch.tensor(hi, dtype=f64, requires_grad=True)
    (g,) = torch.autograd.grad(sca_torch.clip(x, lo_t, hi_t) ** 2, x)
    assert float(g) == want == pytest.approx(hi)
    # torch.clamp passes the whole gradient: the reason for clip
    (g_clamp,) = torch.autograd.grad(torch.clamp(x, 1e-9, hi) ** 2, x)
    assert float(g_clamp) == pytest.approx(2 * hi)
    # the low edge and the interior
    for x0, want_g in ((1e-9, 1e-9), (0.5, 1.0)):
        x = torch.tensor(x0, dtype=f64, requires_grad=True)
        (g,) = torch.autograd.grad(sca_torch.clip(x, lo_t, hi_t) ** 2, x)
        assert float(g) == pytest.approx(want_g, rel=1e-12)


def _jax_ota_obj(jnp, spec):
    """The reference's OTA objective (``sca_jax._solve_ota_one``'s
    ``obj``), for its ``_adam_descent``."""
    n, dim = spec.n, float(spec.dim)
    lam = jnp.asarray(spec.lambdas)
    c = spec.g_max ** 2 / (dim * lam * spec.e_s)
    gmax = jnp.sqrt(lam * dim * spec.e_s / (2.0 * spec.g_max ** 2))
    u_g = jnp.median(gmax)
    wv, wb = spec.weights.omega_var, spec.weights.omega_bias

    def obj(gs):
        gam = gs * u_g
        x = c * gam ** 2
        a = gam * jnp.exp(-x)
        alpha = jnp.sum(a)
        p = a / alpha
        trans = jnp.sum(p ** 2 * spec.g_max ** 2
                        * (jnp.exp(jnp.minimum(x, 700.0)) - 1.0))
        noise = dim * spec.n0 / alpha ** 2
        return (wv * (trans + jnp.sum(p ** 2 * 0.0) + noise)
                + wb * jnp.sum((p - 1.0 / n) ** 2))
    return obj, u_g, gmax / u_g


def test_adam_stage_matches_reference(ref, fig2_ota):
    spec = fig2_ota
    jnp = ref.jax.numpy
    a0 = ota_design.anchor_min_noise(spec)
    with ref.jax.enable_x64(True):
        obj, u_g, hi = _jax_ota_obj(jnp, spec)
        x0 = jnp.clip(jnp.asarray(a0) / u_g, 1e-6, hi)
        scale = 1.0 / jnp.maximum(jnp.abs(obj(x0)), 1e-30)
        vg = ref.jax.value_and_grad(obj)

        def scaled(x):
            f, g = vg(x)
            return f, g * scale
        x_r, bx_r, bf_r = (np.asarray(t) for t in ref.sca_jax._adam_descent(
            scaled, x0, 1e-6, hi, lr=0.1, n_steps=300, track_best=True))
    prob = sca_torch.OTAProblem(*(
        _t(v).reshape(1, 1, -1) for v in (
            spec.lambdas, spec.dim, spec.g_max, spec.e_s, spec.n0,
            spec.weights.omega_var, spec.weights.omega_bias, spec.sigmas2)))
    x0_p = torch.clamp(_t(a0).reshape(1, 1, -1) / prob.u_g, prob.lo,
                       prob.hi)
    np.testing.assert_allclose(x0_p[0, 0].numpy(), np.asarray(x0),
                               rtol=1e-15)
    vg_p = sca_torch.value_and_grad(prob.obj)
    scale_p = 1.0 / torch.clamp_min(torch.abs(prob.obj(x0_p)), 1e-30)

    def scaled_p(x):
        f, g = vg_p(x)
        return f, g * scale_p
    x_p, bx_p, bf_p = sca_torch._adam_descent(
        scaled_p, x0_p, lambda x: torch.clamp(x, prob.lo, prob.hi), lr=0.1,
        n_steps=300, track_best=True)
    np.testing.assert_allclose(x_p[0, 0].numpy(), x_r, rtol=1e-12)
    np.testing.assert_allclose(bx_p[0, 0].numpy(), bx_r, rtol=1e-12)
    np.testing.assert_allclose(float(bf_p), float(bf_r), rtol=1e-12)
    assert float(bf_p) < float(prob.obj(x0_p))        # the stage descends


# --------------------------------------------- the latency bisection

def _jax_fit_latency(ref, dim, e_s, n0, bw, t_max):
    """The reference's ``fit_latency`` (``sca_jax._solve_digital_one``),
    one lane: (lambdas, beta, r) -> beta."""
    jax, jnp = ref.jax, ref.jax.numpy

    def fit(lam, beta, r):
        snr_gain = lam * e_s / n0

        def latency(nlb_s):
            rate = jnp.maximum(jnp.log2(1.0 + snr_gain * nlb_s), 1e-9)
            payload = 64.0 + dim * (r + 1.0)
            return jnp.sum(jnp.exp(-nlb_s) * payload / (bw * rate))

        nlb = -jnp.log(jnp.clip(beta, 1e-300, 1.0))
        feasible = latency(nlb) <= t_max

        def cond(carry):
            lo_s, hi_s = carry
            return (hi_s - lo_s) > 1e-12 * hi_s

        def body(carry):
            lo_s, hi_s = carry
            mid = 0.5 * (lo_s + hi_s)
            bad = latency(mid * nlb) > t_max
            return jnp.where(bad, mid, lo_s), jnp.where(bad, hi_s, mid)

        _, hi_s = jax.lax.while_loop(cond, body, (1.0, 1e6))
        s = jnp.where(feasible, 1.0, hi_s)
        return jnp.exp(-s * nlb)
    return fit


@pytest.fixture(scope="module")
def latency_lanes():
    """Lanes of one N = 10 deployment whose brackets close at different
    steps: feasible as they are, barely over budget, far over it, at few
    and at many bits. Lane 4 (beta = 1 - 1e-9 at 3.5 bits) needs s past
    both brackets' ends."""
    dep = make_deployment(WirelessConfig(n_devices=10, seed=1))
    cfg = dep.cfg
    spec = digital_design.DigitalDesignSpec(
        lambdas=dep.lambdas, dim=7850, g_max=20.0, e_s=cfg.energy_per_symbol,
        n0=cfg.noise_power, bandwidth_hz=cfg.bandwidth_hz, t_max_s=0.2,
        weights=ObjectiveWeights(1.0, 1.0))
    rng = np.random.default_rng(3)
    betas = np.stack([np.full(10, 0.01), np.full(10, 0.5),
                      np.full(10, 0.99), rng.uniform(0.05, 0.95, 10),
                      np.full(10, 1.0 - 1e-9), rng.uniform(0.3, 0.6, 10)])
    rs = np.stack([np.full(10, 0.5), np.full(10, 7.5), np.full(10, 14.5),
                   rng.uniform(0.5, 15, 10), np.full(10, 3.5),
                   np.full(10, 6.5)])
    return spec, betas, rs


def _problem(spec, lanes):
    vals = [np.broadcast_to(np.asarray(v, np.float64), (lanes,) + np.shape(v))
            for v in (spec.lambdas, spec.dim, spec.g_max, spec.e_s, spec.n0,
                      spec.bandwidth_hz, spec.t_max_s, spec.r_max,
                      spec.weights.omega_var, spec.weights.omega_bias,
                      spec.sigmas2)]
    return sca_torch.DigitalProblem(*(_t(v).reshape(lanes, 1, -1)
                                      for v in vals))


def test_batched_fit_latency(ref, latency_lanes):
    spec, betas, rs = latency_lanes
    lanes = len(betas)
    prob = _problem(spec, lanes)
    got = prob.fit_latency(_t(betas)[:, None], _t(rs)[:, None])[:, 0]
    got = got.numpy()
    # the reference's loop, vmapped over the lanes
    fit = _jax_fit_latency(ref, float(spec.dim), spec.e_s, spec.n0,
                           spec.bandwidth_hz, spec.t_max_s)
    with ref.jax.enable_x64(True):
        want = np.asarray(ref.jax.vmap(fit, in_axes=(None, 0, 0))(
            ref.jax.numpy.asarray(spec.lambdas), betas, rs))
    np.testing.assert_allclose(got, want, rtol=1e-12)
    # the host bisection (doubling, then 100 halvings): the same root
    # where it lies below s = 1e6; past it, each stops at its own end
    # (1e6 here, 2^20 on the host) and neither is feasible
    for lane in range(lanes):
        host = digital_design._fit_latency(spec, betas[lane], rs[lane])
        if lane == 4:
            nlb = -np.log(betas[lane])
            np.testing.assert_allclose(got[lane], np.exp(-1e6 * nlb),
                                       rtol=1e-15)
            np.testing.assert_array_equal(host, betas[lane] ** 2.0 ** 20)
            assert digital_design._latency(spec, host, rs[lane]) \
                > spec.t_max_s
            continue
        np.testing.assert_allclose(got[lane], host, rtol=1e-9)
        assert digital_design._latency(spec, got[lane], rs[lane]) \
            <= spec.t_max_s * (1 + 1e-12)
    # each lane runs alone exactly as in the batch, and the lanes close
    # their brackets at different steps: a finished lane stays frozen
    steps = []
    for lane in range(lanes):
        one = _problem(spec, 1)
        calls = []
        latency = one.latency
        one.latency = lambda *a: calls.append(1) or latency(*a)
        alone = one.fit_latency(_t(betas[lane:lane + 1])[:, None],
                                _t(rs[lane:lane + 1])[:, None])[0, 0]
        np.testing.assert_array_equal(alone.numpy(), got[lane])
        steps.append(len(calls) - 1)
    assert len(set(steps)) > 1, steps
