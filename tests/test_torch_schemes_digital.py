"""The port's digital baselines of Sec. V (Best Channel, Best Channel-Norm,
Proportional Fairness, UQOS, QML and FedTOE) against the reference.

Four levels, each on the reference's own inputs:
  * constructors and host pieces: UQOS's p_succ and capped pi, FedTOE's
    rates and thresholds, QML's static bit-width, the replayed selection
    draws, and FedTOE's greedy bit allocation, all bit-equal; top-K masks
    equal; capacity rates within 2 ulps (the port computes log2 as XLA
    lowers it, log(x) * (1/ln 2); the two logs differ in the last bit on
    some inputs);
  * one round, with reference-made f64 gradients, fading, dither and
    selection draws, each port round function against the reference
    engine's (Pallas kernels in interpret mode, f64 under x64), both
    spied where they hand the aggregate to ``quantized_weighted_sum``:
    selection masks, bits, weights and latency equal; ghat within 4 ulps of
    S = sum_i |w_i| 2 m_i, the size of the terms the two sums round
    (|v_i| <= m_i). The reference makes its levels with ``jnp.exp2``,
    which XLA lowers to exp(r ln 2): 2^6 - 1 comes out as
    62.99999999999998, 1.5 ulps short (ROADMAP Queue 3); the port's are
    exact integers, so the quantized values differ by an ulp or two of m;
  * the fused route: a Best Channel round at d = 131,073;
  * trajectories: ``FLTrainer.run`` on the CPU against the reference's
    ``FLTrainer.run(backend="jax")`` on the ``test_torch_trainer.py``
    setup (d = 650, N = 6, so K = 4 and K' = 6 fit): loss within 1e-3
    relative, accuracy within 2/n_test, wall-clock within 8 ulps; under a
    time budget that bites, the run freezes on the reference's round.
"""
import numpy as np
import pytest
import torch

from _torch_reference import one_thread, ref  # noqa: F401  (fixtures)
from repro_torch import interop
from repro_torch.core import baselines as B
from repro_torch.core import rngstream
from repro_torch.core.digital import (capacity_rate, greedy_bit_alloc,
                                      topk_mask)
from repro_torch.fl import FLTrainer, SoftmaxRegressionTask
from repro_torch.fl.engine import scheme_port
from repro_torch.kernels import ops

pytestmark = pytest.mark.usefixtures("one_thread")

N, TRIALS, ROUNDS, SEED = 6, 2, 6, 5
RUN = dict(rounds=20, trials=2, eval_every=10, seed=SEED)
SCHEMES = ("best_channel", "best_channel_norm", "prop_fairness", "uqos",
           "qml", "fedtoe")
CAPACITY = ("best_channel", "best_channel_norm", "prop_fairness", "qml")


def _schemes(ref, dep, consts):
    b = ref.baselines
    return {"best_channel": b.BestChannel(dep, *consts),
            "best_channel_norm": b.BestChannelNorm(dep, *consts),
            "prop_fairness": b.PropFairness(dep, *consts),
            "uqos": b.UQOS(dep, *consts), "qml": b.QML(dep, *consts),
            "fedtoe": b.FedTOE(dep, *consts)}


@pytest.fixture(scope="module")
def case(ref):
    """The trainer tests' deployment and data; reference-made gradients,
    fading and dither for ROUNDS rounds of TRIALS trials."""
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
    consts = (task.dim, task.g_max, cfg.energy_per_symbol, cfg.noise_power,
              cfg.bandwidth_hz)
    xs = np.stack([d.x for d in ds.devices])
    ys = np.stack([d.y for d in ds.devices])
    rng = np.random.default_rng(0)
    grads = np.stack([task.device_grads(rng.normal(size=task.dim) * 0.1,
                                        xs, ys) for _ in range(TRIALS)])
    h = np.stack([ref.channel.sample_fading_batch(dep.lambdas,
                                                  SEED * 1000 + tr, ROUNDS)
                  for tr in range(TRIALS)])                   # (K, T, N)
    u = np.stack([np.stack([np.array(ref.rngstream.dither_block(
        ref.rngstream.dither_base_key(SEED, tr), t, N, task.dim))
        for t in range(ROUNDS)]) for tr in range(TRIALS)])   # (K, T, N, d)
    eta = 0.5 / (task.mu + task.smooth_l)
    return dict(task=task, ds=ds, dep=dep, consts=consts, grads=grads, h=h,
                u=u, eta=eta, schemes=_schemes(ref, dep, consts))


# ----------------------------------------------- constructors, host pieces

def test_constructors_bit_equal(case):
    dep_p = interop.deployment(case["dep"])
    port = {k: interop.scheme(v) for k, v in case["schemes"].items()}
    built = _port_schemes(dep_p, case["consts"])
    for name, agg_r in case["schemes"].items():
        for agg_p in (port[name], built[name]):
            assert type(agg_p).__name__ == type(agg_r).__name__
            assert agg_p.name == agg_r.name
            for attr in ("k", "r", "kp", "r_total", "rate", "var_cap",
                         "r_max", "p_out", "t_budget", "p_succ", "pi",
                         "rates", "thr", "dim", "g_max", "e_s", "n0", "B"):
                if hasattr(agg_r, attr):
                    np.testing.assert_array_equal(getattr(agg_p, attr),
                                                  getattr(agg_r, attr))
            np.testing.assert_array_equal(agg_p.dep.lambdas,
                                          agg_r.dep.lambdas)
    uqos = built["uqos"]
    assert np.isclose(uqos.pi.sum(), uqos.k) and uqos.pi.max() <= 1.0


def _port_schemes(dep, consts):
    return {"best_channel": B.BestChannel(dep, *consts),
            "best_channel_norm": B.BestChannelNorm(dep, *consts),
            "prop_fairness": B.PropFairness(dep, *consts),
            "uqos": B.UQOS(dep, *consts), "qml": B.QML(dep, *consts),
            "fedtoe": B.FedTOE(dep, *consts)}


@pytest.mark.parametrize("dim", [650, 7850])
def test_qml_static_bits_match_the_reference_round(ref, case, dim):
    """The port's static r is the one the reference's NumPy QML round
    computes (and its engine, ``repro/fl/engine.py:441-444``)."""
    consts = (dim,) + case["consts"][1:]
    agg_r = ref.baselines.QML(case["dep"], *consts)
    res = agg_r.round([np.ones(dim)] * N, case["h"][0, 0], 0,
                      np.random.default_rng(0),
                      dither=np.zeros((N, dim), np.float32))
    assert B.QML(interop.deployment(case["dep"]), *consts).r == \
        res.info["r"]


@pytest.mark.parametrize("name", ["uqos", "qml", "fedtoe"])
def test_selection_stream_bit_equal(ref, case, name):
    agg_r = case["schemes"][name]
    want = ref.engine.as_functional(agg_r).sel_stream_np(SEED, 1, 9)
    got = scheme_port(interop.scheme(agg_r)).sel_stream_np(SEED, 1, 9)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float64 and got.shape[0] == 9


@pytest.mark.parametrize("t_budget", [0.02, 0.08, 0.22, 10.0])
def test_greedy_bit_alloc_bit_equal(ref, case, t_budget):
    """Against ``greedy_bit_alloc_jax`` on 40 replayed draws, from a budget
    that defers devices to one that lets every device reach r_max."""
    agg = case["schemes"]["fedtoe"]
    dim, bw = case["task"].dim, case["consts"][-1]
    rng = np.random.default_rng(int(t_budget * 1000))
    jnp = ref.jax.numpy
    with ref.jax.enable_x64():
        alloc = ref.jax.jit(lambda sel: ref.digital.greedy_bit_alloc_jax(
            sel, jnp.asarray(agg.rates), dim=dim, bandwidth_hz=bw,
            t_budget_s=t_budget, r_max=16))
        seen = set()
        for _ in range(40):
            sel = rng.choice(N, size=4, replace=False)
            bits, in_alloc = greedy_bit_alloc(sel, agg.rates, dim=dim,
                                              bandwidth_hz=bw,
                                              t_budget_s=t_budget, r_max=16)
            want_b, want_a = alloc(jnp.asarray(sel))
            np.testing.assert_array_equal(bits, np.asarray(want_b))
            np.testing.assert_array_equal(in_alloc, np.asarray(want_a))
            seen.add((int(in_alloc.sum()), int(bits.max())))
    if t_budget < 10:
        assert len(seen) > 1
    else:                    # every scheduled device reaches r_max
        assert seen == {(4, 16)}


def test_capacity_rate_within_2ulp(ref, case):
    """Against ``capacity_rate_jnp`` run op by op, as the round tests run
    the reference: the arguments of the log agree, the logs differ in the
    last bit on ~0.6% of entries, which the product with 1/ln 2 makes at
    most 2 ulps of the rate. (Under ``jit`` XLA folds E_s/N0 into one
    constant, which moves the argument of the log by an ulp of 1: near
    rate 0 that is hundreds of ulps of the rate, ROADMAP Queue 3; the
    trajectory tests below bound what reaches the wall-clock.)"""
    cfg = case["dep"].cfg
    lam = np.repeat(case["dep"].lambdas, 500)
    h = np.abs(ref.channel.sample_fading_batch(lam, 3, 4))    # (4, 3000)
    got = capacity_rate(torch.from_numpy(h), cfg.energy_per_symbol,
                        cfg.noise_power).numpy()
    with ref.jax.enable_x64():
        want = np.asarray(ref.digital.capacity_rate_jnp(
            ref.jax.numpy.asarray(h), cfg.energy_per_symbol,
            cfg.noise_power))
    ulps = np.abs(got - want) / np.spacing(want)
    assert ulps.max() <= 2.0
    print(f"capacity rate: {np.mean(got != want):.4%} of entries off, "
          f"{ulps.max()} ulp at most")


def test_topk_mask_breaks_ties_as_the_reference(ref):
    jnp = ref.jax.numpy
    rng = np.random.default_rng(1)
    for score in (rng.integers(0, 3, size=(20, 7)).astype(np.float64),
                  rng.normal(size=(20, 7))):
        got = topk_mask(torch.from_numpy(score), 3).numpy()
        for row, g in zip(score, got):
            np.testing.assert_array_equal(
                g, np.asarray(ref.digital.topk_mask(jnp.asarray(row), 3)))


# ------------------------------------------------------------------ rounds

def _spy(monkeypatch, module):
    """Record the (levels, weights) each ``quantized_weighted_sum`` call
    of ``module`` gets."""
    seen, real = [], module.quantized_weighted_sum

    def spy(gs, levels, dither, weights, **kw):
        seen.append((np.asarray(levels), np.asarray(weights)))
        return real(gs, levels, dither, weights, **kw)

    monkeypatch.setattr(module, "quantized_weighted_sum", spy)
    return seen


def _bits(levels):
    return np.round(np.log2(levels + 1.0))


def _check_round(ref, monkeypatch, agg_r, grads, h, u, sel, t):
    """One round of the port (all trials batched) against the reference
    engine's per trial; returns the largest ghat and latency gaps in ulps
    and the number of devices sent."""
    jnp = ref.jax.numpy
    port = scheme_port(interop.scheme(agg_r))
    seen_p = _spy(monkeypatch, ops)
    ghat, lat = port.round_fn(
        torch.from_numpy(grads), torch.from_numpy(np.abs(h)), None,
        torch.from_numpy(u), None if sel is None else torch.from_numpy(
            port.sel_plan(sel[:, None])[:, 0] if port.sel_plan else sel), t)
    (levels_p, w_p), = seen_p
    seen_r = _spy(monkeypatch, ref.ops)
    worst = [0.0, 0.0, 0]
    for tr in range(grads.shape[0]):
        with ref.jax.enable_x64():
            fn = ref.engine.as_functional(agg_r, use_kernel=True).round_fn
            want_g, want_lat = fn(
                jnp.asarray(grads[tr]), jnp.asarray(h[tr]), jnp.zeros(1),
                jnp.asarray(u[tr]),
                jnp.zeros(1) if sel is None else jnp.asarray(sel[tr]), t)
        levels_r, w_r = seen_r[-1]
        chi = w_r != 0
        np.testing.assert_array_equal(w_p[tr] != 0, chi)
        np.testing.assert_array_equal(w_p[tr], w_r)
        np.testing.assert_array_equal(_bits(levels_p[tr]), _bits(levels_r))
        assert np.all(levels_p[tr] == np.round(levels_p[tr]))   # integers
        want_lat = float(want_lat)
        gap = abs(float(lat[tr]) - want_lat) / np.spacing(want_lat)
        assert float(lat[tr]) == want_lat, gap
        m = np.abs(grads[tr]).max(axis=1)
        scale = np.sum(np.abs(w_r) * 2 * m)
        diff = np.abs(ghat[tr].numpy() - np.asarray(want_g))
        assert np.all(diff <= 4 * np.spacing(scale)), \
            diff.max() / np.spacing(scale)
        assert chi.sum() <= 4
        worst = [max(worst[0], diff.max() / np.spacing(scale)),
                 max(worst[1], gap), worst[2] + int(chi.sum())]
    return worst


@pytest.mark.parametrize("name", SCHEMES)
def test_round_matches_reference_engine(ref, case, monkeypatch, name):
    agg_r = case["schemes"][name]
    sels = None
    sel_np = ref.engine.as_functional(agg_r).sel_stream_np
    if sel_np is not None:
        sels = np.stack([sel_np(SEED, tr, ROUNDS) for tr in range(TRIALS)])
    worst, sent = [0.0, 0.0], 0
    for t in range(ROUNDS):
        *w, n_sent = _check_round(ref, monkeypatch, agg_r, case["grads"],
                                  case["h"][:, t], case["u"][:, t],
                                  None if sels is None else sels[:, t], t)
        worst = [max(a, b) for a, b in zip(worst, w)]
        sent += n_sent
    assert sent > 0
    print(f"{name}: ghat within {worst[0]} ulp of S, latency within "
          f"{worst[1]} ulp, {sent} uploads")


def test_best_channel_norm_scores_through_the_row_reduction(case,
                                                            monkeypatch):
    calls = []
    real = ops.row_maxabs_sumsq
    monkeypatch.setattr(ops, "row_maxabs_sumsq",
                        lambda gs, **kw: calls.append(gs.shape)
                        or real(gs, **kw))
    port = scheme_port(interop.scheme(case["schemes"]["best_channel_norm"]))
    port.round_fn(torch.from_numpy(case["grads"]),
                  torch.from_numpy(np.abs(case["h"][:, 0])), None,
                  torch.from_numpy(case["u"][:, 0]), None, 0)
    assert calls == [case["grads"].shape]


def test_best_channel_round_on_the_fused_route(ref, case, monkeypatch):
    """d = 131,073 >= 2^17 with r = 6: both sides pack 8-bit codes. Masks
    and latency as above; ghat within 4 ulps of S, except where the
    reference's packer truncates its non-integer top level
    62.99999999999998 to code 62 (the port codes 63): there the two
    differ by exactly one step w * 2m/levels of the devices concerned."""
    d, n = 131073, 4
    rng = np.random.default_rng(3)
    grads = rng.normal(size=(1, n, d)) * rng.uniform(0.1, 3, size=(1, n, 1))
    lam = case["dep"].lambdas[:n]
    h = ref.channel.sample_fading_batch(lam, 11, 1)[None, 0]   # (1, n)
    u = np.array(ref.rngstream.dither_block(
        ref.rngstream.dither_base_key(SEED, 0), 0, n, d))[None]
    dep = ref.channel.Deployment(distances_m=case["dep"].distances_m[:n],
                                 lambdas=lam, cfg=case["dep"].cfg)
    agg_r = ref.baselines.BestChannel(dep, d, *case["consts"][1:], k=2)
    fused = []
    real = ops.packed_weighted_sum
    monkeypatch.setattr(ops, "packed_weighted_sum",
                        lambda pk, w: fused.append(pk.code_bits)
                        or real(pk, w))
    port = scheme_port(interop.scheme(agg_r))
    seen_p = _spy(monkeypatch, ops)
    ghat, lat = port.round_fn(torch.from_numpy(grads),
                              torch.from_numpy(np.abs(h)), None,
                              torch.from_numpy(u), None, 0)
    assert fused == [8]
    (levels_p, w_p), = seen_p
    seen_r = _spy(monkeypatch, ref.ops)
    jnp = ref.jax.numpy
    with ref.jax.enable_x64():
        fn = ref.engine.as_functional(agg_r, use_kernel=True).round_fn
        want_g, want_lat = fn(jnp.asarray(grads[0]), jnp.asarray(h[0]),
                              jnp.zeros(1), jnp.asarray(u[0]), jnp.zeros(1),
                              0)
    (levels_r, w_r), = seen_r
    np.testing.assert_array_equal(w_p[0], w_r)
    np.testing.assert_array_equal(_bits(levels_p[0]), _bits(levels_r))
    assert float(lat[0]) == float(want_lat)
    m = np.abs(grads[0]).max(axis=1)
    steps = w_r * 2 * m / 63.0
    diff = np.asarray(want_g) - ghat[0].numpy()
    tol = 4 * np.spacing(np.sum(np.abs(w_r) * 2 * m))
    # each entry: 0 or a sum of whole steps of the selected devices
    sel = np.flatnonzero(w_r)
    combos = np.array([0.0] + [steps[i] for i in sel]
                      + [steps[sel].sum()])
    near = np.min(np.abs(-diff[:, None] - combos[None]), axis=1)
    assert np.all(near <= tol)
    truncated = int(np.sum(np.abs(diff) > tol))
    assert truncated >= 1            # at least each device's max entry
    print(f"fused Best Channel: {truncated} of {d} entries one step apart")


# ------------------------------------------------------------ trajectories

@pytest.fixture(scope="module")
def trainers(ref, case):
    task_p = SoftmaxRegressionTask(n_features=64, mu=0.01, g_max=20.0)
    return (ref.trainer.FLTrainer(case["task"], case["ds"], case["dep"],
                                  eta=case["eta"]),
            FLTrainer(task_p, interop.dataset(case["ds"]),
                      interop.deployment(case["dep"]), case["eta"],
                      device="cpu"))


def _compare(log_p, log_r, n_test):
    assert log_p.scheme == log_r.scheme
    np.testing.assert_array_equal(log_p.rounds, log_r.rounds)
    wall = np.abs(log_p.wall_time_s - log_r.wall_time_s)
    assert np.all(wall <= 8 * np.spacing(log_r.wall_time_s)), \
        (wall / np.spacing(log_r.wall_time_s)).max()
    np.testing.assert_allclose(log_p.global_loss, log_r.global_loss,
                               rtol=1e-3, atol=0)
    assert np.max(np.abs(log_p.accuracy - log_r.accuracy)) \
        <= 2 / n_test + 1e-6


@pytest.mark.parametrize("name", SCHEMES)
def test_trajectory_matches_reference(case, trainers, name):
    agg = case["schemes"][name]
    trainer_r, trainer_p = trainers
    log_r = trainer_r.run(agg, backend="jax", **RUN)
    log_p = trainer_p.run(interop.scheme(agg), **RUN)
    _compare(log_p, log_r, len(case["ds"].y_test))
    # every digital baseline learns at this size
    assert log_p.global_loss[:, -1].max() < log_p.global_loss[:, 0].min()


@pytest.mark.parametrize("name", CAPACITY + ("fedtoe",))
def test_time_budget_freezes_on_the_same_round(case, trainers, name):
    agg = case["schemes"][name]
    trainer_r, trainer_p = trainers
    run = dict(rounds=20, trials=2, eval_every=2, seed=SEED)
    full = trainer_r.run(agg, backend="jax", **run).wall_time_s
    # a budget between two eval points' wall-clocks: the run must stop
    # inside that segment
    budget = 0.5 * (full[4] + full[5])
    log_r = trainer_r.run(agg, backend="jax", time_budget_s=budget, **run)
    log_p = trainer_p.run(interop.scheme(agg), time_budget_s=budget, **run)
    assert log_r.wall_time_s[-1] == log_r.wall_time_s[-2] >= budget
    _compare(log_p, log_r, len(case["ds"].y_test))
    frozen = lambda log: int(np.argmax(log.wall_time_s  # noqa: E731
                                       == log.wall_time_s[-1]))
    assert frozen(log_p) == frozen(log_r)
    np.testing.assert_array_equal(
        np.diff(log_p.global_loss, axis=1) == 0,
        np.diff(log_r.global_loss, axis=1) == 0)


@pytest.mark.parametrize("name", ["uqos", "qml", "fedtoe"])
def test_fast_rng_raises_for_the_selection_schemes(ref, case, trainers,
                                                   monkeypatch, name):
    """``rng="fast"`` runs the selection schemes: their rounds on the
    reference's fast inputs (selection rows from ``sel_stream_jax``, the
    fading from ``sample_fading_jax``) and reference-made gradients give
    the reference engine's masks, bits, weights and latency, the rows
    the port draws are those, and a fast run is finite."""
    agg_r = case["schemes"][name]
    fn = ref.engine.as_functional(agg_r).sel_stream_jax
    jax, jnp = ref.jax, ref.jax.numpy
    with jax.enable_x64():
        sels = np.stack([np.stack([np.asarray(fn(jax.random.fold_in(
            ref.rngstream.stream_base_key(SEED, tr, 47), t)))
            for t in range(ROUNDS)]) for tr in range(TRIALS)])
        h = np.stack([np.stack([np.asarray(ref.channel.sample_fading_jax(
            ref.rngstream.stream_base_key(SEED, tr, 43), t,
            jnp.asarray(case["dep"].lambdas))) for t in range(ROUNDS)])
            for tr in range(TRIALS)])
    port = scheme_port(interop.scheme(agg_r))
    got = port.sel_stream_fast(rngstream.round_keys(
        [rngstream.stream_base_key(SEED, tr, rngstream.SELECT_TAG)
         for tr in range(TRIALS)], ROUNDS)).numpy()
    np.testing.assert_array_equal(got, sels)
    sent = 0
    for t in range(ROUNDS):
        sent += _check_round(ref, monkeypatch, agg_r, case["grads"],
                             h[:, t], case["u"][:, t], sels[:, t], t)[2]
    assert sent > 0
    log = trainers[1].run(interop.scheme(agg_r), rounds=2, trials=1,
                          eval_every=1, rng="fast")
    assert np.all(np.isfinite(log.global_loss))
