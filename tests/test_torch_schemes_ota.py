"""The port's OTA baselines of Sec. V (OPC OTA-Comp, LCPC OTA-Comp,
OPC OTA-FL, BB-FL Interior and BB-FL Alternative) against the reference.

Three levels, each on the reference's own inputs:
  * constructors: every attribute the port builds from a deployment
    (LCPC's ``OTAParams``, BB-FL's interior mask and gammas) bit-equal;
  * one round, with reference-made f64 gradients, fading and AWGN, the
    port's engine round function against the reference engine's (its
    Pallas epilogue in interpret mode, f64 under x64): participation
    masks equal; ghat within 1e-12 relative, the round tests' contract
    (the gamma-weighted sums add the devices in another order);
    OPC OTA-Comp's eta per round: the same grid point, within a stated
    number of ulps (the grid comes from log10 and pow, whose last bits
    differ between torch and XLA);
  * trajectories: ``FLTrainer.run`` on the CPU against the reference's
    ``FLTrainer.run(backend="jax")`` on the ``test_torch_trainer.py``
    setup (d = 650, N = 6): loss within 1e-5 relative, accuracy within
    1/n_test, wall-clock equal.
"""
import numpy as np
import pytest
import torch

from _torch_reference import one_thread, ref  # noqa: F401  (fixtures)
from repro_torch import interop
from repro_torch.core import baselines as B
from repro_torch.core.ota import (bbfl_round, opc_ota_comp_eta,
                                  opc_ota_fl_round,
                                  uniform_gamma_min_variance)
from repro_torch.fl import FLTrainer, SoftmaxRegressionTask
from repro_torch.fl.engine import scheme_port

pytestmark = pytest.mark.usefixtures("one_thread")

N, TRIALS, ROUNDS = 6, 2, 12
RUN = dict(rounds=20, trials=2, eval_every=10, seed=5)
SCHEMES = ("opc_ota_fl", "opc_ota_comp", "lcpc_ota_comp", "bbfl_interior",
           "bbfl_alternative")


@pytest.fixture(scope="module")
def case(ref):
    """The trainer tests' deployment and data; reference-made gradients,
    fading and AWGN for ROUNDS rounds of TRIALS trials."""
    spec = ref.synthetic.SyntheticSpec(image_shape=(8, 8, 1),
                                       n_train_per_class=200,
                                       n_test_per_class=50, noise_sigma=1.5)
    x_tr, y_tr, x_te, y_te = ref.synthetic.make_classification_dataset(spec)
    shards = ref.partition.partition_by_class(x_tr, y_tr, N, 1, 200, seed=3)
    ds = ref.loader.FLDataset.from_shards(shards, x_te, y_te)
    task = ref.tasks.SoftmaxRegressionTask(n_features=64, mu=0.01,
                                           g_max=20.0)
    dep = ref.channel.make_deployment(ref.channel.WirelessConfig(n_devices=N,
                                                                 seed=1))
    cfg = dep.cfg
    consts = (task.dim, task.g_max, cfg.energy_per_symbol, cfg.noise_power)
    schemes = {
        "opc_ota_fl": ref.baselines.OPCOTAFL(*consts),
        "opc_ota_comp": ref.baselines.OPCOTAComp(*consts),
        "lcpc_ota_comp": ref.baselines.LCPCOTAComp(dep, *consts),
        "bbfl_interior": ref.baselines.BBFLInterior(dep, *consts),
        "bbfl_alternative": ref.baselines.BBFLAlternative(dep, *consts),
    }
    xs = np.stack([d.x for d in ds.devices])
    ys = np.stack([d.y for d in ds.devices])
    rng = np.random.default_rng(0)
    grads = np.stack([task.device_grads(rng.normal(size=task.dim) * 0.1,
                                        xs, ys) for _ in range(TRIALS)])
    h = np.stack([ref.channel.sample_fading_batch(dep.lambdas, 5000 + tr,
                                                  ROUNDS)
                  for tr in range(TRIALS)])                   # (K, T, N)
    z01 = np.stack([ref.rngstream.trial_rng(5, tr).standard_normal(
        (ROUNDS, task.dim)) for tr in range(TRIALS)])         # (K, T, d)
    eta = 0.5 / (task.mu + task.smooth_l)
    return dict(task=task, ds=ds, dep=dep, consts=consts, schemes=schemes,
                grads=grads, h=h, z01=z01, eta=eta)


def _assert_rel(got, want, rel=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= rel * np.max(np.abs(want))


# ------------------------------------------------------------ constructors

def test_lcpc_params_bit_equal(case):
    agg_r = case["schemes"]["lcpc_ota_comp"]
    agg_p = B.LCPCOTAComp(interop.deployment(case["dep"]), *case["consts"])
    for f in ("gammas", "alpha", "g_max", "dim", "energy_per_symbol",
              "noise_psd"):
        np.testing.assert_array_equal(getattr(agg_p.params, f),
                                      getattr(agg_r.params, f))


def test_bbfl_constructors_bit_equal(case):
    dep_p = interop.deployment(case["dep"])
    inner_r = case["schemes"]["bbfl_interior"]
    inner_p = B.BBFLInterior(dep_p, *case["consts"])
    np.testing.assert_array_equal(inner_p.interior, inner_r.interior)
    assert 0 < inner_p.interior.sum() < N          # both policies differ
    assert inner_p.gamma == inner_r.gamma
    alt_r = case["schemes"]["bbfl_alternative"]
    alt_p = B.BBFLAlternative(dep_p, *case["consts"])
    np.testing.assert_array_equal(alt_p.all_mask, alt_r.all_mask)
    np.testing.assert_array_equal(alt_p.interior_agg.interior,
                                  alt_r.interior_agg.interior)
    assert alt_p.gamma_all == alt_r.gamma_all
    assert alt_p.interior_agg.gamma == alt_r.interior_agg.gamma


def test_uniform_gamma_min_variance_bit_equal(ref, case):
    lam = case["dep"].lambdas
    for args in ((case["task"].dim, 20.0, 1e-6, 5e-21),
                 case["consts"]):
        assert uniform_gamma_min_variance(lam, *args) == \
            ref.ota.uniform_gamma_min_variance(lam, *args)


@pytest.mark.parametrize("name", SCHEMES)
def test_interop_scheme_round_trips(case, name):
    agg_r = case["schemes"][name]
    agg_p = interop.scheme(agg_r)
    assert type(agg_p).__name__ == type(agg_r).__name__
    assert agg_p.name == agg_r.name


# ------------------------------------------------------------------ rounds

def _ref_round(ref, agg, g, h, z01, t):
    jnp = ref.jax.numpy
    with ref.jax.enable_x64():
        fn = ref.engine.as_functional(agg, use_kernel=True).round_fn
        ghat, lat = fn(jnp.asarray(g), jnp.asarray(h), jnp.asarray(z01),
                       jnp.zeros((N, 1), jnp.float32), jnp.zeros(1), t)
        return np.asarray(ghat), lat


@pytest.mark.parametrize("name", SCHEMES)
def test_round_matches_reference_engine(ref, case, name):
    agg_r = case["schemes"][name]
    port = scheme_port(interop.scheme(agg_r))
    g = torch.from_numpy(case["grads"])
    for t in range(4):        # odd and even rounds (BB-FL Alternative)
        habs = torch.from_numpy(np.abs(case["h"][:, t]))
        ghat, lat = port.round_fn(g, habs, torch.from_numpy(
            case["z01"][:, t]), None, None, t)
        for tr in range(TRIALS):
            want_g, want_lat = _ref_round(ref, agg_r, case["grads"][tr],
                                          case["h"][tr, t],
                                          case["z01"][tr, t], t)
            _assert_rel(ghat[tr].numpy(), want_g)
            assert lat == want_lat


def test_opc_ota_fl_mask_matches_reference(ref, case):
    dim, g_max, e_s, n0 = case["consts"]
    jnp = ref.jax.numpy
    g = torch.from_numpy(case["grads"])
    sizes = set()
    for t in range(ROUNDS):
        habs = np.abs(case["h"][:, t])
        _, chi = opc_ota_fl_round(g, torch.from_numpy(habs),
                                  torch.from_numpy(case["z01"][:, t]),
                                  dim=dim, g_max=g_max, e_s=e_s, n0=n0)
        with ref.jax.enable_x64():
            for tr in range(TRIALS):
                _, want = ref.ota.opc_ota_fl_round_jax(
                    jnp.asarray(case["grads"][tr]),
                    jnp.asarray(case["h"][tr, t]),
                    jnp.asarray(case["z01"][tr, t]), dim=dim, g_max=g_max,
                    e_s=e_s, n0=n0)
                np.testing.assert_array_equal(chi[tr].numpy(),
                                              np.asarray(want))
                sizes.add(int(chi[tr].sum()))
    assert len(sizes) > 1          # the chosen k moves from round to round


@pytest.mark.parametrize("variant", ["bbfl_interior", "bbfl_alternative"])
def test_bbfl_mask_follows_round_parity(ref, case, variant):
    agg = case["schemes"][variant]
    inner = getattr(agg, "interior_agg", agg)
    even = ((agg.gamma_all, agg.all_mask) if inner is not agg
            else (inner.gamma, inner.interior))
    kw = dict(zip(("dim", "g_max", "e_s", "n0"), case["consts"]),
              gamma_odd=inner.gamma, mask_odd=inner.interior.astype(float),
              gamma_even=even[0], mask_even=np.asarray(even[1], float))
    jnp = ref.jax.numpy
    g = torch.from_numpy(case["grads"])
    for t in range(4):
        _, chi = bbfl_round(g, torch.from_numpy(np.abs(case["h"][:, t])),
                            torch.from_numpy(case["z01"][:, t]), t, **kw)
        with ref.jax.enable_x64():
            for tr in range(TRIALS):
                _, want = ref.ota.bbfl_round_jax(
                    jnp.asarray(case["grads"][tr]),
                    jnp.asarray(case["h"][tr, t]),
                    jnp.asarray(case["z01"][tr, t]), t, **kw)
                np.testing.assert_array_equal(chi[tr].numpy(),
                                              np.asarray(want))
        # interior devices only in odd rounds (and in every round of
        # BB-FL Interior)
        if t % 2 == 1 or variant == "bbfl_interior":
            assert not chi[:, ~inner.interior].any()


def _ref_eta(ref, habs, dim, g_max, e_s, n0, n_grid):
    """The reference's eta: ``repro/fl/engine.py:229-237`` verbatim."""
    jnp = ref.jax.numpy
    b_bar = np.sqrt(dim * e_s) / g_max
    n = habs.shape[0]
    with ref.jax.enable_x64():
        habs = jnp.asarray(habs)
        lo = jnp.maximum((b_bar * jnp.min(habs)) ** 2 * 1e-4, 1e-300)
        hi = (b_bar * jnp.max(habs)) ** 2 * 1e4
        etas = jnp.geomspace(lo, hi, n_grid)
        b = jnp.minimum(b_bar, jnp.sqrt(etas)[:, None] / habs)
        c = b * habs / jnp.sqrt(etas)[:, None]
        mses = (g_max ** 2 * jnp.sum((c - 1.0) ** 2, axis=1) / n ** 2
                + dim * n0 / (n ** 2 * etas))
        i = int(jnp.argmin(mses))
        return i, float(etas[i]), np.asarray(etas)


def test_opc_ota_comp_eta_matches_reference(ref, case):
    """The same grid point every round, eta within the gap of 10 ** lin
    when lin = log10(eta) is 2 ulps off and pow adds 2 ulps:
    |d eta| <= eta (2 ln(10) ulp(lin) + 2 eps). The grid is JAX's
    geomspace rebuilt in torch; torch and XLA round log10, pow and (after
    XLA's rewrites) lin in other last bits. Measured on these inputs:
    55 ulps of eta at worst (lin near -20, where one ulp of lin is ~37
    ulps of eta)."""
    dim, g_max, e_s, n0 = case["consts"]
    agg = case["schemes"]["opc_ota_comp"]
    habs = np.abs(case["h"])                                  # (K, T, N)
    got = opc_ota_comp_eta(torch.from_numpy(habs), dim=dim, g_max=g_max,
                           e_s=e_s, n0=n0, n_grid=agg.n_grid).numpy()
    worst = 0.0
    eps = np.finfo(np.float64).eps
    for tr in range(TRIALS):
        for t in range(ROUNDS):
            i, want, etas = _ref_eta(ref, habs[tr, t], dim, g_max, e_s, n0,
                                     agg.n_grid)
            assert np.argmin(np.abs(etas - got[tr, t])) == i, (tr, t)
            tol = want * (2 * np.log(10) * np.spacing(abs(np.log10(want)))
                          + 2 * eps)
            assert abs(got[tr, t] - want) <= tol, (tr, t)
            worst = max(worst, abs(got[tr, t] - want) / np.spacing(want))
    print(f"OPC OTA-Comp eta: worst gap {worst} ulps")


# ------------------------------------------------------------ trajectories

@pytest.fixture(scope="module")
def trainers(ref, case):
    task_p = SoftmaxRegressionTask(n_features=64, mu=0.01, g_max=20.0)
    return (ref.trainer.FLTrainer(case["task"], case["ds"], case["dep"],
                                  eta=case["eta"]),
            FLTrainer(task_p, interop.dataset(case["ds"]),
                      interop.deployment(case["dep"]), case["eta"],
                      device="cpu"))


@pytest.mark.parametrize("name", SCHEMES)
def test_trajectory_matches_reference(case, trainers, name):
    agg = case["schemes"][name]
    trainer_r, trainer_p = trainers
    log_r = trainer_r.run(agg, backend="jax", **RUN)
    log_p = trainer_p.run(interop.scheme(agg), **RUN)
    assert log_p.scheme == log_r.scheme
    np.testing.assert_array_equal(log_p.rounds, log_r.rounds)
    np.testing.assert_array_equal(log_p.wall_time_s, log_r.wall_time_s)
    np.testing.assert_allclose(log_p.global_loss, log_r.global_loss,
                               rtol=1e-5, atol=0)
    assert np.all(np.isfinite(log_p.global_loss))
    assert np.max(np.abs(log_p.accuracy - log_r.accuracy)) \
        <= 1 / len(case["ds"].y_test) + 1e-6
