"""The port's batched design solver (``design_ota_batch`` /
``design_digital_batch`` over ``repro_torch.core.sca_torch``) against the
reference's (``repro.core.sca_jax``) and the port's own SciPy SCA
oracle, on the CPU; then the Fig. 2 chain from designed parameters.

Mirrors ``tests/test_design_batch.py`` on its 2 x 2 weight grid (N = 10,
seed 1), plus Fig. 2's N = 50 OTA point:
  * objectives within 1e-6 relative of the reference's, and the
    reference's finalized r_bits;
  * each objective <= the SCA oracle's x (1 + 1e-3) (the design bench's
    PARITY_RTOL);
  * a batch equal to its points solved one by one (rtol 1e-12);
  * valid parameters, mismatched N refused;
  * the participation and async co-design solvers within 1e-6 relative
    of the reference's on random (B = 3, N = 10) problems;
  * ``sigma_sq=None`` leaving (15a) and the direct OTA solver as they
    were, bit for bit.
The slice test runs design, scheme and ``FLTrainer.run`` at d = 7850 and
holds the trajectories to the reference trainer fed the same parameters:
OTA within 1e-5, digital within 4 combined Monte-Carlo standard errors
(and the port's digital 1e-3).
"""
import numpy as np
import pytest

from _torch_reference import one_thread, ref  # noqa: F401  (fixtures)
from repro_torch import interop
from repro_torch.core import baselines as B
from repro_torch.core import digital_design, ota_design, sca_torch
from repro_torch.core.bounds import ObjectiveWeights
from repro_torch.core.channel import WirelessConfig, make_deployment

PARITY_RTOL = 1e-3
REF_RTOL = 1e-6

# the SciPy SCA oracle must run clean, as in the reference's test
pytestmark = [pytest.mark.filterwarnings(
    "error:Values in x were outside bounds:RuntimeWarning"),
    pytest.mark.usefixtures("one_thread")]


def _weight_grid(n, scales=(0.3, 3.0)):
    base = ObjectiveWeights.strongly_convex(eta=0.5, mu=0.01, kappa_sc=3.0,
                                            n=n)
    return [ObjectiveWeights(omega_var=base.omega_var * a,
                             omega_bias=base.omega_bias * b)
            for a in scales for b in scales]


@pytest.fixture(scope="module")
def deployment():
    return make_deployment(WirelessConfig(n_devices=10, seed=1))


def _ota_spec(dep, w, **kw):
    cfg = dep.cfg
    return ota_design.OTADesignSpec(
        lambdas=dep.lambdas, dim=7850, g_max=20.0, e_s=cfg.energy_per_symbol,
        n0=cfg.noise_power, weights=w, **kw)


def _dig_spec(dep, w, **kw):
    cfg = dep.cfg
    return digital_design.DigitalDesignSpec(
        lambdas=dep.lambdas, dim=7850, g_max=20.0, e_s=cfg.energy_per_symbol,
        n0=cfg.noise_power, bandwidth_hz=cfg.bandwidth_hz, t_max_s=0.2,
        weights=w, **kw)


def _ref_ota(ref, spec):
    return ref.ota_design.OTADesignSpec(
        lambdas=spec.lambdas, dim=spec.dim, g_max=spec.g_max, e_s=spec.e_s,
        n0=spec.n0, weights=ref.bounds.ObjectiveWeights(
            spec.weights.omega_var, spec.weights.omega_bias),
        sigma_sq=spec.sigma_sq)


def _ref_dig(ref, spec):
    return ref.digital_design.DigitalDesignSpec(
        lambdas=spec.lambdas, dim=spec.dim, g_max=spec.g_max, e_s=spec.e_s,
        n0=spec.n0, bandwidth_hz=spec.bandwidth_hz, t_max_s=spec.t_max_s,
        weights=ref.bounds.ObjectiveWeights(spec.weights.omega_var,
                                            spec.weights.omega_bias),
        r_max=spec.r_max, sigma_sq=spec.sigma_sq)


@pytest.fixture(scope="module")
def ota_grid(ref, deployment):
    specs = [_ota_spec(deployment, w) for w in _weight_grid(10)]
    ref_specs = [_ref_ota(ref, s) for s in specs]
    ref_params, ref_objs = ref.ota_design.design_ota_batch(ref_specs)
    params, objs = ota_design.design_ota_batch(specs, device="cpu")
    return specs, params, objs, ref_params, ref_objs


@pytest.fixture(scope="module")
def dig_grid(ref, deployment):
    specs = [_dig_spec(deployment, w) for w in _weight_grid(10)]
    ref_specs = [_ref_dig(ref, s) for s in specs]
    ref_params, ref_objs = ref.digital_design.design_digital_batch(ref_specs)
    params, objs = digital_design.design_digital_batch(specs, device="cpu")
    return specs, params, objs, ref_params, ref_objs


class TestOTABatch:
    def test_objectives_match_reference(self, ota_grid):
        specs, params, objs, ref_params, ref_objs = ota_grid
        np.testing.assert_allclose(objs, ref_objs, rtol=REF_RTOL)
        for p, rp in zip(params, ref_params):
            np.testing.assert_allclose(p.gammas, rp.gammas, rtol=1e-5)

    def test_parity_with_sca_oracle_on_grid(self, ota_grid):
        specs, params, objs, _, _ = ota_grid
        for spec, p, f in zip(specs, params, objs):
            _, res = ota_design.design_ota_sca(spec, n_iters=6)
            assert f <= res.objective * (1.0 + PARITY_RTOL), (
                f, res.objective)
            # the returned objective is the true one at the returned design
            f_check = ota_design.true_objective_from_gamma(spec, p.gammas)
            np.testing.assert_allclose(f, f_check, rtol=1e-9)

    def test_batch_params_valid(self, ota_grid, deployment):
        specs, params, _, _, _ = ota_grid
        for spec, p in zip(specs, params):
            pl = p.participation_levels(deployment.lambdas)
            assert np.all(pl >= 0) and np.all(pl <= 1)
            np.testing.assert_allclose(pl.sum(), 1.0, rtol=1e-9)
            assert np.all(p.gammas <= spec.gamma_max() * (1 + 1e-12))

    def test_batch_matches_per_point_solve(self, deployment):
        """The batch must not mix points: batch == batch of one per spec,
        the specs differing in every per-point field."""
        cfg = deployment.cfg
        specs = [ota_design.OTADesignSpec(
            lambdas=deployment.lambdas, dim=d, g_max=g,
            e_s=cfg.energy_per_symbol * se, n0=cfg.noise_power * sn,
            weights=wi, sigma_sq=s2)
            for wi, d, g, se, sn, s2 in zip(
                _weight_grid(10)[:3], (7850, 3000, 500), (20.0, 10.0, 49.0),
                (1.0, 2.0, 0.5), (1.0, 0.5, 2.0),
                (None, np.full(10, 3.0), np.linspace(0, 50, 10)))]
        _, objs = ota_design.design_ota_batch(specs, device="cpu")
        for spec, f in zip(specs, objs):
            _, f_single = ota_design.design_ota_batch([spec], device="cpu")
            np.testing.assert_allclose(f, f_single[0], rtol=1e-12)

    def test_stack_rejects_mismatched_device_count(self, deployment):
        w = _weight_grid(10)[0]
        cfg = deployment.cfg
        other = ota_design.OTADesignSpec(
            lambdas=deployment.lambdas[:5], dim=7850, g_max=20.0,
            e_s=cfg.energy_per_symbol, n0=cfg.noise_power, weights=w)
        with pytest.raises(ValueError, match="device count"):
            ota_design.stack_ota_specs([_ota_spec(deployment, w), other])

    def test_fig2_point_at_50_devices(self, ref):
        """Fig. 2's OTA design: N = 50, eta = 0.5 / (mu + L)."""
        dep = make_deployment(WirelessConfig(n_devices=50, seed=1))
        spec = _ota_spec(dep, ObjectiveWeights.strongly_convex(
            eta=0.5 / (0.01 + 2.01), mu=0.01, kappa_sc=3.0, n=50))
        _, ref_objs = ref.ota_design.design_ota_batch([_ref_ota(ref, spec)])
        params, objs = ota_design.design_ota_batch([spec], device="cpu")
        np.testing.assert_allclose(objs, ref_objs, rtol=REF_RTOL)
        assert objs[0] == pytest.approx(175.62024633, rel=1e-9)
        assert np.isfinite(params[0].alpha)

    def test_mini_batch_term_matches_reference(self, ref, deployment):
        s2 = np.linspace(0.5, 40.0, 10)
        specs = [_ota_spec(deployment, w, sigma_sq=s2)
                 for w in _weight_grid(10)[:2]]
        _, ref_objs = ref.ota_design.design_ota_batch(
            [_ref_ota(ref, s) for s in specs])
        _, objs = ota_design.design_ota_batch(specs, device="cpu")
        np.testing.assert_allclose(objs, ref_objs, rtol=REF_RTOL)


class TestDigitalBatch:
    def test_objectives_and_bits_match_reference(self, dig_grid):
        _, params, objs, ref_params, ref_objs = dig_grid
        np.testing.assert_allclose(objs, ref_objs, rtol=REF_RTOL)
        for p, rp in zip(params, ref_params):
            np.testing.assert_array_equal(p.r_bits, rp.r_bits)
            np.testing.assert_allclose(p.rhos, rp.rhos, rtol=1e-5)
            np.testing.assert_allclose(p.nus, rp.nus, rtol=1e-5)

    def test_parity_with_sca_oracle_on_grid(self, dig_grid):
        specs, _, objs, _, _ = dig_grid
        for spec, f in zip(specs, objs):
            _, res = digital_design.design_digital_sca(spec, n_iters=4)
            assert f <= res.objective * (1.0 + PARITY_RTOL), (
                f, res.objective)

    def test_batch_params_valid(self, dig_grid, deployment):
        specs, params, _, _, _ = dig_grid
        for spec, p in zip(specs, params):
            pl = p.participation_levels(deployment.lambdas)
            np.testing.assert_allclose(pl.sum(), 1.0, rtol=1e-6)
            assert np.all(p.r_bits >= 1)
            assert np.all(p.r_bits <= spec.r_max)
            lat = p.expected_latency(deployment.lambdas)
            assert lat <= spec.t_max_s * 1.02, lat

    def test_batch_matches_per_point_solve(self, deployment):
        cfg = deployment.cfg
        specs = [digital_design.DigitalDesignSpec(
            lambdas=deployment.lambdas, dim=d, g_max=20.0,
            e_s=cfg.energy_per_symbol, n0=cfg.noise_power,
            bandwidth_hz=cfg.bandwidth_hz * bw, t_max_s=t, weights=wi,
            r_max=rm)
            for wi, d, bw, t, rm in zip(
                _weight_grid(10)[1:], (7850, 3000, 20000), (1.0, 2.0, 0.5),
                (0.2, 0.1, 1.0), (16, 12, 16))]
        _, objs = digital_design.design_digital_batch(specs, device="cpu")
        for spec, f in zip(specs, objs):
            _, f_single = digital_design.design_digital_batch(
                [spec], device="cpu")
            np.testing.assert_allclose(f, f_single[0], rtol=1e-12)

    def test_stack_rejects_mismatched_device_count(self, deployment):
        w = _weight_grid(10)[0]
        cfg = deployment.cfg
        other = digital_design.DigitalDesignSpec(
            lambdas=deployment.lambdas[:5], dim=7850, g_max=20.0,
            e_s=cfg.energy_per_symbol, n0=cfg.noise_power,
            bandwidth_hz=cfg.bandwidth_hz, t_max_s=0.2, weights=w)
        with pytest.raises(ValueError, match="device count"):
            digital_design.stack_digital_specs([_dig_spec(deployment, w),
                                                other])

    def test_fig2_point(self, ref, deployment):
        """Fig. 2's digital design: N = 10, T_max = 0.2 s: 8 bits each."""
        spec = _dig_spec(deployment, ObjectiveWeights.strongly_convex(
            eta=0.5 / (0.01 + 2.01), mu=0.01, kappa_sc=3.0, n=10))
        ref_params, ref_objs = ref.digital_design.design_digital_batch(
            [_ref_dig(ref, spec)])
        params, objs = digital_design.design_digital_batch([spec],
                                                           device="cpu")
        np.testing.assert_allclose(objs, ref_objs, rtol=REF_RTOL)
        assert objs[0] == pytest.approx(4359.72625992, rel=1e-9)
        np.testing.assert_array_equal(params[0].r_bits, ref_params[0].r_bits)
        np.testing.assert_array_equal(params[0].r_bits, 8)


def _co_design_inputs():
    rng = np.random.default_rng(0)
    b, n = 3, 10
    p = rng.dirichlet(np.ones(n), size=b)
    wv, wb = rng.uniform(0.1, 10, b), rng.uniform(0.1, 1000, b)
    return rng, p, wv, wb


def test_participation_solver_matches_reference(ref):
    rng, p, wv, wb = _co_design_inputs()
    q = rng.uniform(0.5, 1.0, p.shape)
    s = np.array([3.0, 5.0, 7.0])
    pi_r, f_r = ref.sca_jax.solve_participation_batch(p, q, s, wv, wb)
    pi, f = sca_torch.solve_participation_batch(p, q, s, wv, wb,
                                                device="cpu")
    np.testing.assert_allclose(f, f_r, rtol=REF_RTOL)
    np.testing.assert_allclose(pi, pi_r, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(pi.sum(-1), s, rtol=1e-9)
    assert np.all(pi >= 1e-6) and np.all(pi <= 1.0)


def test_async_solver_matches_reference(ref):
    rng, p, wv, wb = _co_design_inputs()
    c = rng.uniform(0.2, 1.0, p.shape)
    sbar = rng.uniform(0.0, 3.0, p.shape)
    v_r, f_r = ref.sca_jax.solve_async_batch(p, c, sbar, wv, wb)
    v, f = sca_torch.solve_async_batch(p, c, sbar, wv, wb, device="cpu")
    np.testing.assert_allclose(f, f_r, rtol=REF_RTOL)
    np.testing.assert_allclose(v, v_r, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(v.sum(-1), 10.0, rtol=1e-9)


def test_participation_wrappers_match_reference(ref, ota_grid, dig_grid):
    """``design_*_participation`` on a solved design of each family."""
    for grid, mod, ref_mod in ((ota_grid, ota_design, ref.ota_design),
                               (dig_grid, digital_design,
                                ref.digital_design)):
        spec, params, _, ref_params, _ = (x[0] for x in grid)
        to_ref = _ref_ota if mod is ota_design else _ref_dig
        q = np.linspace(0.6, 1.0, spec.n)
        name = ("design_ota_participation" if mod is ota_design
                else "design_digital_participation")
        pi_r, f_r = getattr(ref_mod, name)(to_ref(ref, spec), ref_params, 4,
                                           survival=q)
        port_params = (interop.ota_params(ref_params) if mod is ota_design
                       else interop.digital_params(ref_params))
        pi, f = getattr(mod, name)(spec, port_params, 4, survival=q,
                                   device="cpu")
        assert f == pytest.approx(f_r, rel=REF_RTOL)
        np.testing.assert_allclose(pi, pi_r, rtol=1e-6, atol=1e-9)


def test_no_variances_leave_the_ota_objective_unchanged(deployment):
    """``sigma_sq=None`` adds an exact 0.0: (15a) and the direct solver
    give what they gave before the mini-batch term, bit for bit."""
    w = _weight_grid(10)[0]
    none, zeros = (_ota_spec(deployment, w, sigma_sq=s)
                   for s in (None, np.zeros(10)))
    gam = none.gamma_max() * np.linspace(0.2, 1.0, 10)

    def before(spec, gammas):               # (15a) without the term
        a = gammas * np.exp(-spec.c_m() * gammas ** 2)
        alpha = max(float(np.sum(a)), 1e-150)
        p = a / alpha
        ratio = np.exp(np.minimum(spec.c_m() * gammas ** 2, 700.0))
        trans = float(np.sum(p ** 2 * spec.g_max ** 2 * (ratio - 1.0)))
        noise = spec.dim * spec.n0 / alpha ** 2
        return (spec.weights.omega_var * (trans + noise)
                + spec.weights.omega_bias * float(np.sum((p - 0.1) ** 2)))

    f_none = ota_design.true_objective_from_gamma(none, gam)
    assert f_none == before(none, gam)
    assert f_none == ota_design.true_objective_from_gamma(zeros, gam)
    p_none, f_none = ota_design.design_ota_direct(none)
    p_zeros, f_zeros = ota_design.design_ota_direct(zeros)
    assert f_none == f_zeros
    np.testing.assert_array_equal(p_none.gammas, p_zeros.gammas)
    # and a variance moves both
    s2 = _ota_spec(deployment, w, sigma_sq=np.full(10, 100.0))
    assert ota_design.true_objective_from_gamma(s2, gam) > f_none + 1.0


def test_interop_carries_design_specs(ref, deployment):
    w = _weight_grid(10)[1]
    for spec, to_ref, conv in (
            (_ota_spec(deployment, w, sigma_sq=np.arange(10.0)), _ref_ota,
             interop.ota_design_spec),
            (_dig_spec(deployment, w), _ref_dig,
             interop.digital_design_spec)):
        back = conv(to_ref(ref, spec))
        assert type(back) is type(spec)
        for field in ("dim", "g_max", "e_s", "n0", "weights"):
            assert getattr(back, field) == getattr(spec, field)
        np.testing.assert_array_equal(back.lambdas, spec.lambdas)
        np.testing.assert_array_equal(back.sigmas2, spec.sigmas2)


# ----------------------------------------------------- the Fig. 2 slice

SLICE_RUN = dict(rounds=10, trials=2, eval_every=5, seed=3)


@pytest.fixture(scope="module")
def fig2_chain(ref):
    """Fig. 2 at d = 7850 and N = 10 in both packages: the same data,
    deployment and step, the port's designed parameters."""
    from repro_torch.fl import FLTrainer, SoftmaxRegressionTask
    spec_d = ref.synthetic.SyntheticSpec(n_train_per_class=100,
                                         n_test_per_class=50,
                                         noise_sigma=1.5, seed=0)
    x_tr, y_tr, x_te, y_te = ref.synthetic.make_classification_dataset(
        spec_d)
    ds = ref.loader.FLDataset.from_shards(
        ref.partition.partition_by_class(x_tr, y_tr, 10, 1, 100, seed=3),
        x_te, y_te)
    task = ref.tasks.SoftmaxRegressionTask(n_features=784, mu=0.01,
                                           g_max=20.0)
    dep = ref.channel.make_deployment(ref.channel.WirelessConfig(
        n_devices=10, seed=1))
    eta = 0.5 / (task.mu + task.smooth_l)
    w = ObjectiveWeights.strongly_convex(eta=eta, mu=task.mu, kappa_sc=3.0,
                                         n=10)
    port_dep = interop.deployment(dep)
    ota_params, _ = ota_design.design_ota_batch(
        [_ota_spec(port_dep, w)], device="cpu")
    dig_params, _ = digital_design.design_digital_batch(
        [_dig_spec(port_dep, w)], device="cpu")
    port_task = SoftmaxRegressionTask(n_features=784, mu=0.01, g_max=20.0)
    return dict(
        ota=ota_params[0], digital=dig_params[0], n_test=len(y_te),
        ref_trainer=ref.trainer.FLTrainer(task, ds, dep, eta=eta),
        port_trainer=FLTrainer(port_task, interop.dataset(ds), port_dep,
                               eta, device="cpu"))


def _ref_params(ref, params):
    """A port parameter set as the reference's, by its fields."""
    if isinstance(params, ota_design.OTAParams):
        return ref.ota.OTAParams(**{k: getattr(params, k) for k in (
            "gammas", "alpha", "g_max", "dim", "energy_per_symbol",
            "noise_psd")})
    return ref.digital.DigitalParams(**{k: getattr(params, k) for k in (
        "rhos", "nus", "r_bits", "g_max", "dim", "energy_per_symbol",
        "noise_psd", "bandwidth_hz")})


def test_fig2_slice_ota_on_designed_parameters(ref, fig2_chain):
    params = fig2_chain["ota"]
    agg_r = ref.baselines.ProposedOTA(_ref_params(ref, params))
    # the reference's scheme carried back gives the port's parameters
    agg_p = interop.scheme(agg_r)
    np.testing.assert_array_equal(agg_p.params.gammas, params.gammas)
    log_r = fig2_chain["ref_trainer"].run(agg_r, backend="jax", **SLICE_RUN)
    log_p = fig2_chain["port_trainer"].run(B.ProposedOTA(params),
                                           **SLICE_RUN)
    assert log_p.scheme == log_r.scheme
    np.testing.assert_array_equal(log_p.wall_time_s, log_r.wall_time_s)
    np.testing.assert_allclose(log_p.global_loss, log_r.global_loss,
                               rtol=1e-5, atol=0)
    assert np.all(np.isfinite(log_p.global_loss))
    assert log_p.global_loss[:, -1].mean() < log_p.global_loss[:, 0].mean()


def test_fig2_slice_digital_on_designed_parameters(ref, fig2_chain):
    params = fig2_chain["digital"]
    np.testing.assert_array_equal(params.r_bits, 8)
    agg_r = ref.baselines.ProposedDigital(_ref_params(ref, params))
    log_r = fig2_chain["ref_trainer"].run(agg_r, backend="jax", **SLICE_RUN)
    log_p = fig2_chain["port_trainer"].run(B.ProposedDigital(params),
                                           **SLICE_RUN)
    assert log_p.scheme == log_r.scheme
    lr, lp = log_r.global_loss, log_p.global_loss
    stderr = np.sqrt(lr.var(axis=0, ddof=1) / lr.shape[0]
                     + lp.var(axis=0, ddof=1) / lp.shape[0])
    gap = np.abs(lr.mean(axis=0) - lp.mean(axis=0))
    # every trial starts from w = 0, so round 0 has no spread: there the
    # floor is the f32 loss's rounding (XLA and torch add the test loss
    # in another order), 2 ulps of it
    floor = np.maximum(1e-7, 2 * np.spacing(np.float32(lr.mean(axis=0))))
    assert np.all(gap <= 4.0 * stderr + floor), (gap, stderr)
    # and the port's digital trajectory check (tests/test_torch_trainer.py)
    np.testing.assert_allclose(lp, lr, rtol=1e-3, atol=0)
    assert np.all(np.isfinite(lp))
    assert lp[:, -1].mean() < lp[:, 0].mean()
