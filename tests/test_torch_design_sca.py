"""The port's host design code against the reference's, bit for bit: the
SciPy SCA solvers (``design_ota_sca``, ``design_digital_sca``), the
direct digital solver (``design_digital_direct``), the digital true
objective and anchors, and the ``bounds`` helpers. Both packages run the
same NumPy/SciPy code on the same inputs, so every float must agree to
the bit.
"""
import numpy as np
import pytest

from _torch_reference import one_thread, ref  # noqa: F401  (fixtures)
from repro_torch import interop
from repro_torch.core import bounds, digital_design, ota_design

# as in the reference's design tests: the oracle must run clean
pytestmark = [pytest.mark.filterwarnings(
    "error:Values in x were outside bounds:RuntimeWarning"),
    pytest.mark.usefixtures("one_thread")]


@pytest.fixture(scope="module")
def specs(ref):
    """A Fig. 2-style point at N = 10 (seed 1) in the reference's types,
    with and without mini-batch variances."""
    dep = ref.channel.make_deployment(ref.channel.WirelessConfig(
        n_devices=10, seed=1))
    cfg = dep.cfg
    w = ref.bounds.ObjectiveWeights.strongly_convex(
        eta=0.5 / (0.01 + 2.01), mu=0.01, kappa_sc=3.0, n=10)
    s2 = np.linspace(1.0, 30.0, 10)
    ota = [ref.ota_design.OTADesignSpec(
        lambdas=dep.lambdas, dim=7850, g_max=20.0, e_s=cfg.energy_per_symbol,
        n0=cfg.noise_power, weights=w, sigma_sq=s) for s in (None, s2)]
    dig = [ref.digital_design.DigitalDesignSpec(
        lambdas=dep.lambdas, dim=7850, g_max=20.0, e_s=cfg.energy_per_symbol,
        n0=cfg.noise_power, bandwidth_hz=cfg.bandwidth_hz, t_max_s=0.2,
        weights=w, sigma_sq=s) for s in (None, s2)]
    return ota, dig


def _same_result(res_p, res_r):
    np.testing.assert_array_equal(res_p.x, res_r.x)
    assert res_p.objective == res_r.objective
    assert res_p.history == res_r.history
    assert (res_p.converged, res_p.n_iters) == (res_r.converged,
                                                res_r.n_iters)


def _same_fields(a, b):
    for name, v in vars(b).items():
        np.testing.assert_array_equal(getattr(a, name), v, err_msg=name)


@pytest.mark.parametrize("which", [0, 1], ids=["no_variance", "variance"])
def test_design_ota_sca_bit_equal(ref, specs, which):
    spec_r = specs[0][which]
    params_r, res_r = ref.ota_design.design_ota_sca(spec_r, n_iters=4)
    params_p, res_p = ota_design.design_ota_sca(
        interop.ota_design_spec(spec_r), n_iters=4)
    _same_result(res_p, res_r)
    _same_fields(params_p, params_r)


@pytest.mark.parametrize("which", [0, 1], ids=["no_variance", "variance"])
def test_design_digital_sca_bit_equal(ref, specs, which):
    spec_r = specs[1][which]
    params_r, res_r = ref.digital_design.design_digital_sca(spec_r,
                                                            n_iters=3)
    params_p, res_p = digital_design.design_digital_sca(
        interop.digital_design_spec(spec_r), n_iters=3)
    _same_result(res_p, res_r)
    _same_fields(params_p, params_r)


def test_design_digital_direct_bit_equal(ref, specs):
    spec_r = specs[1][1]
    params_r, f_r = ref.digital_design.design_digital_direct(spec_r,
                                                             maxiter=100)
    params_p, f_p = digital_design.design_digital_direct(
        interop.digital_design_spec(spec_r), maxiter=100)
    assert f_p == f_r
    _same_fields(params_p, params_r)


def test_digital_objective_and_anchors_bit_equal(ref, specs):
    spec_r = specs[1][1]
    spec_p = interop.digital_design_spec(spec_r)
    for a_p, a_r in (
            (digital_design.anchor_channel_weighted(spec_p),
             ref.digital_design.anchor_channel_weighted(spec_r)),
            (digital_design.anchor_channel_weighted(spec_p, expo=0.7),
             ref.digital_design.anchor_channel_weighted(spec_r, expo=0.7))):
        for x_p, x_r in zip(a_p, a_r):
            np.testing.assert_array_equal(x_p, x_r)
    np.testing.assert_array_equal(digital_design.default_anchors(spec_p),
                                  ref.digital_design.default_anchors(spec_r))
    ospec_r = specs[0][1]
    ospec_p = interop.ota_design_spec(ospec_r)
    rng = np.random.default_rng(4)
    for _ in range(3):
        p = rng.dirichlet(np.ones(10))
        beta = rng.uniform(0.05, 0.95, 10)
        r = rng.uniform(0.5, 15.0, 10)
        assert digital_design.true_objective(spec_p, p, beta, r) == \
            ref.digital_design.true_objective(spec_r, p, beta, r)
        gam = rng.uniform(0.2, 1.0, 10) * ospec_p.gamma_max()
        assert ota_design.true_objective_from_gamma(ospec_p, gam) == \
            ref.ota_design.true_objective_from_gamma(ospec_r, gam)
    np.testing.assert_array_equal(ota_design.default_anchors(ospec_p),
                                  ref.ota_design.default_anchors(ospec_r))


def test_bounds_helpers_bit_equal(ref):
    rng = np.random.default_rng(5)
    n = 12
    p = rng.dirichlet(np.ones(n))
    q = rng.uniform(0.4, 1.0, n)
    pi = rng.uniform(0.1, 1.0, n)
    c = rng.uniform(0.2, 1.0, n)
    v = rng.uniform(0.5, 2.0, n)
    for policy in ("reweight", "zero", "stale"):
        for pi_ in (None, pi):
            np.testing.assert_array_equal(
                bounds.effective_participation(p, q, policy, pi_),
                ref.bounds.effective_participation(p, q, policy, pi_))
    with pytest.raises(ValueError, match="on_missing"):
        bounds.effective_participation(p, q, "drop")
    for w in (None, v):
        np.testing.assert_array_equal(
            bounds.async_effective_participation(p, c, w),
            ref.bounds.async_effective_participation(p, c, w))
        assert bounds.async_bias_sum(p, c, w) == \
            ref.bounds.async_bias_sum(p, c, w)
    assert bounds.bias_sum(p) == ref.bounds.bias_sum(p)
    for kind, args in (("strongly_convex", (0.1, 0.01, 3.0, n)),
                       ("non_convex", (0.08, 10.0, 3.0, n))):
        w_p = getattr(bounds.ObjectiveWeights, kind)(*args)
        w_r = getattr(ref.bounds.ObjectiveWeights, kind)(*args)
        assert (w_p.omega_var, w_p.omega_bias) == (w_r.omega_var,
                                                   w_r.omega_bias)
        assert bounds.design_objective(p, 17.5, w_p) == \
            ref.bounds.design_objective(p, 17.5, w_r)
    kw1 = dict(eta=0.1, mu=0.01, diam=3.0, kappa_sc=2.0, p=p, zeta=40.0)
    assert bounds.theorem1_bound(50, **kw1) == \
        ref.bounds.theorem1_bound(50, **kw1)
    kw2 = dict(eta=0.08, smooth_l=10.0, f_gap0=2.3, kappa_nc=3.0, p=p,
               zeta=40.0)
    assert bounds.theorem2_bound(400, **kw2) == \
        ref.bounds.theorem2_bound(400, **kw2)
    g0 = rng.uniform(0.0, 5.0, n)
    assert bounds.projection_radius(g0, 0.01) == \
        ref.bounds.projection_radius(g0, 0.01)
