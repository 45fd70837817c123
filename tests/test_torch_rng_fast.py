"""The port's ``rng="fast"`` streams and engine against the reference.

  * bit-equal to ``jax.random``: ``permutation`` and ``choice(replace=
    False)`` at n = 1 ... 5000 (one sort up to n = 1625, two from 1626),
    the 32-bit and 64-bit bits, the f64 uniforms, and the fast selection
    rows of UQOS, QML and FedTOE;
  * within stated ulps: XLA's f64 log1p (1 ulp), the f64 normals (3 ulp:
    XLA contracts some of erfinv's Horner steps into FMAs), the fast PS
    AWGN (f32 normals widened, 3 ulp) and the fast fading |h| (8 ulp);
  * trajectories: OTA schemes within 1e-5 relative of the reference's
    fast engine at every round, ProposedDigital and the selection
    schemes under the 4-sigma gate (``tests/test_rng_fast.py``'s);
  * the port's fast mode against its replay mode: statistically
    equivalent, and not the same stream; no host-side stream is touched.
"""
import numpy as np
import pytest
import torch

import _torch_layers as L
from _torch_reference import one_thread, ref  # noqa: F401  (fixtures)
from repro_torch import interop
from repro_torch.core import channel, rngstream
from repro_torch.fl import engine as engine_mod
from repro_torch.fl.engine import scheme_port

pytestmark = pytest.mark.usefixtures("one_thread")

NORMAL64_ULPS = 3
NOISE_ULPS = 3
FADING_ULPS = 8
FAST = dict(L.RUN, rng="fast")


def _ulps(got, want):
    return float(np.max(np.abs(got - want)
                        / np.spacing(np.maximum(np.abs(want), 1e-300))))


def test_threefry_layout_is_the_pinned_one(ref):
    assert ref.jax.config.jax_threefry_partitionable is True


# ----------------------------------------------------------- streams

@pytest.mark.parametrize("n", [1, 2, 7, 300, 1000, 1625, 1626, 5000])
def test_permutation_and_choice_bit_equal(ref, n):
    jax = ref.jax
    assert rngstream.shuffle_rounds(n) == (1 if 1 < n <= 1625 else
                                           0 if n == 1 else 2)
    for seed in (0, 5, 2 ** 32 - 1):
        key_r = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
        key_p = rngstream.fold_in(rngstream.prng_key(seed), 3)
        np.testing.assert_array_equal(
            rngstream.permutation(key_p, n).numpy(),
            np.asarray(jax.random.permutation(key_r, n)))
        k = min(n, 16)
        np.testing.assert_array_equal(
            rngstream.choice_without_replacement(key_p, n, k).numpy(),
            np.asarray(jax.random.choice(key_r, n, (k,), replace=False)))


def test_batched_keys_draw_each_keys_row():
    """A (..., 1) batch of keys gives each key's own draw."""
    keys = [rngstream.fold_in(rngstream.prng_key(9), i) for i in range(5)]
    k0 = torch.tensor([k[0] for k in keys])[:, None]
    k1 = torch.tensor([k[1] for k in keys])[:, None]
    for fn, args in ((rngstream.permutation, (300,)),
                     (rngstream.uniform_f64, ((2, 7),)),
                     (rngstream.normal_f64, ((3,),)),
                     (rngstream.random_bits32, ((4,),))):
        rows = fn((k0, k1), *args)
        for i, key in enumerate(keys):
            np.testing.assert_array_equal(rows[i].numpy(),
                                          fn(key, *args).numpy())


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 650), (2, 70001)])
def test_bits_and_f64_uniforms_bit_equal(ref, shape):
    jax, jnp = ref.jax, ref.jax.numpy
    key_r = jax.random.fold_in(jax.random.PRNGKey(77), 2)
    key_p = rngstream.fold_in(rngstream.prng_key(77), 2)
    np.testing.assert_array_equal(
        rngstream.random_bits32(key_p, shape).numpy(),
        np.asarray(jax.random.bits(key_r, shape, jnp.uint32)))
    hi, lo = rngstream.random_bits64(key_p, shape)
    word = (hi.numpy().astype(np.uint64) << np.uint64(32)) | \
        lo.numpy().astype(np.uint64)
    with jax.enable_x64():
        want64 = np.asarray(jax.random.bits(key_r, shape, jnp.uint64))
        want_u = np.asarray(jax.random.uniform(key_r, shape, jnp.float64))
    np.testing.assert_array_equal(word, want64)
    got_u = rngstream.uniform_f64(key_p, shape).numpy()
    np.testing.assert_array_equal(got_u.view(np.int64),
                                  want_u.view(np.int64))


def test_log1p_f64_is_xlas(ref):
    jnp = ref.jax.numpy
    x = -np.random.default_rng(0).uniform(0, 1, 200000) ** 2
    with ref.jax.enable_x64():
        want = np.asarray(jnp.log1p(jnp.asarray(x)))
    got = rngstream.log1p_f64(torch.from_numpy(x)).numpy()
    ulps = _ulps(got, want)
    print(f"log1p: {ulps} ulp at most, glibc's "
          f"{_ulps(np.log1p(x), want)}")
    assert ulps <= 1


def test_normal_f64_within_3ulp(ref):
    jax = ref.jax
    key_r = jax.random.PRNGKey(7)
    with jax.enable_x64():
        want = np.asarray(jax.random.normal(key_r, (300000,),
                                            jax.numpy.float64))
    got = rngstream.normal_f64(rngstream.prng_key(7), (300000,)).numpy()
    ulps = _ulps(got, want)
    print(f"normal f64: {ulps} ulp at most, {np.mean(got != want):.3%} of "
          f"entries off, |z| up to {np.abs(want).max()}")
    assert ulps <= NORMAL64_ULPS and np.abs(want).max() > 4.5


@pytest.mark.parametrize("trial,t,d", [(0, 0, 650), (3, 41, 7850),
                                       (1, 299, 1)])
def test_noise_block_within_3ulp(ref, trial, t, d):
    key_r = ref.rngstream.stream_base_key(5, trial, 41)
    with ref.jax.enable_x64():
        want = np.asarray(ref.rngstream.noise_block(key_r, t, d))
    key = rngstream.stream_base_key(5, trial, rngstream.NOISE_TAG)
    got = rngstream.noise_block(key, t, d)
    assert got.dtype == torch.float64
    # f32 normals widened: ulps of f32
    assert np.array_equal(got.numpy().astype(np.float32), got.numpy())
    assert _ulps(got.numpy().astype(np.float32),
                 want.astype(np.float32)) <= NOISE_ULPS
    block = rngstream.noise_blocks([key], t, 2, d)
    np.testing.assert_array_equal(block[0, 0].numpy(), got.numpy())


def test_fast_fading_within_stated_ulps(ref):
    """h of 300 rounds of 50 devices against ``sample_fading_jax``; |h|
    (the engine's input) against XLA's complex abs. The threshold masks
    that |h| meets can flip where it sits within those ulps of a
    threshold: counted on ProposedOTA's thresholds and reported."""
    jnp = ref.jax.numpy
    lam = np.geomspace(1e-9, 1e-6, 50)
    key_r = ref.rngstream.stream_base_key(5, 1, 43)
    key_p = rngstream.stream_base_key(5, 1, rngstream.FADING_TAG)
    with ref.jax.enable_x64():
        h_r = np.stack([np.asarray(ref.channel.sample_fading_jax(
            key_r, t, jnp.asarray(lam))) for t in range(300)])
    h_p = np.stack([channel.sample_fading_fast(key_p, t, lam).numpy()
                    for t in range(300)])
    assert _ulps(h_p.real, h_r.real) <= FADING_ULPS
    assert _ulps(h_p.imag, h_r.imag) <= FADING_ULPS
    habs = channel.fading_abs_fast([key_p], 300, lam)[0].numpy()
    assert _ulps(habs, np.abs(h_r)) <= FADING_ULPS
    # the flips: |h| against thresholds placed at the median of each
    # device's |h|, the densest place a designed threshold can sit
    thr = np.median(np.abs(h_r), axis=0)
    flips = int(np.sum((habs >= thr) != (np.abs(h_r) >= thr)))
    print(f"fast fading: |h| within {_ulps(habs, np.abs(h_r))} ulp; "
          f"{flips} of {habs.size} threshold comparisons flip")
    assert flips == 0


@pytest.fixture(scope="module")
def digital_schemes(ref):
    case = L.make_case(ref)
    cfg = case["dep"].cfg
    consts = (case["task"].dim, case["task"].g_max, cfg.energy_per_symbol,
              cfg.noise_power, cfg.bandwidth_hz)
    b = ref.baselines
    return case, {"uqos": b.UQOS(case["dep"], *consts),
                  "qml": b.QML(case["dep"], *consts),
                  "fedtoe": b.FedTOE(case["dep"], *consts)}


@pytest.mark.parametrize("name", ["uqos", "qml", "fedtoe"])
def test_fast_selection_rows_bit_equal(ref, digital_schemes, name):
    """Rounds 0..39 of trials 0..2: the port's rows, made for every round
    at once, against ``sel_stream_jax(fold_in(key, t))``."""
    agg = digital_schemes[1][name]
    fn = ref.engine.as_functional(agg).sel_stream_jax
    port = scheme_port(interop.scheme(agg))
    keys = [rngstream.stream_base_key(5, tr, rngstream.SELECT_TAG)
            for tr in range(3)]
    got = port.sel_stream_fast(rngstream.round_keys(keys, 40)).numpy()
    with ref.jax.enable_x64():
        want = np.stack([np.stack([np.asarray(fn(ref.jax.random.fold_in(
            ref.rngstream.stream_base_key(5, tr, 47), t)))
            for t in range(40)]) for tr in range(3)])
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------- trajectories

@pytest.fixture(scope="module")
def case(ref):
    return L.make_case(ref)


@pytest.mark.parametrize("scheme", ["ota", "vanilla"])
def test_fast_ota_trajectory_matches_reference(case, scheme):
    log_p, log_r = L.run_both(case, case[scheme], run=FAST)
    L.assert_ota_close(log_p, log_r, len(case["ds"].y_test))


def test_fast_ota_minibatch_trajectory_matches_reference(case):
    log_p, log_r = L.run_both(case, case["ota"], run=FAST, batch_size=32)
    L.assert_ota_close(log_p, log_r, len(case["ds"].y_test))


@pytest.mark.parametrize("scheme", ["digital", "uqos", "qml", "fedtoe"])
def test_fast_digital_gate(digital_schemes, scheme):
    case, schemes = digital_schemes
    agg = case["digital"] if scheme == "digital" else schemes[scheme]
    run = dict(FAST, trials=4, rounds=10)
    log_p, log_r = L.run_both(case, agg, run=run)
    L.digital_gate(log_p, log_r, sum(len(d) for d in case["ds"].devices))


def _assert_statistically_equivalent(log_a, log_b):
    """Mean trajectories within 4x the combined Monte-Carlo stderr."""
    la, lb = log_a.global_loss, log_b.global_loss
    stderr = np.sqrt(la.var(0, ddof=1) / la.shape[0]
                     + lb.var(0, ddof=1) / lb.shape[0])
    gap = np.abs(la.mean(0) - lb.mean(0))
    assert np.all(gap <= 4.0 * stderr + 1e-7), (gap, stderr)


@pytest.fixture(scope="module")
def gate_cell():
    """The reference's own fast-mode gate cell (``tests/test_rng_fast.py``:
    28x28 images, N = 10 devices of 100 samples, d = 7850), in the
    port."""
    from repro_torch.core.channel import WirelessConfig, make_deployment
    from repro_torch.data import (FLDataset, SyntheticSpec,
                                  make_classification_dataset,
                                  partition_by_class)
    from repro_torch.fl import FLTrainer, SoftmaxRegressionTask
    x_tr, y_tr, x_te, y_te = make_classification_dataset(SyntheticSpec(
        n_train_per_class=100, n_test_per_class=30, noise_sigma=1.5))
    ds = FLDataset.from_shards(
        partition_by_class(x_tr, y_tr, 10, 1, 100, seed=3), x_te, y_te)
    task = SoftmaxRegressionTask(n_features=784, mu=0.01, g_max=20.0)
    dep = make_deployment(WirelessConfig(n_devices=10, seed=1))
    trainer = FLTrainer(task, ds, dep, 0.5 / (task.mu + task.smooth_l),
                        device="cpu")
    return task, dep, trainer


@pytest.mark.parametrize("scheme,trials,rounds", [("vanilla", 12, 30),
                                                  ("uqos", 8, 20)])
def test_port_fast_against_port_replay(gate_cell, scheme, trials, rounds):
    """Fast and replay on the reference's gate cell and runs: the same
    law (mean losses within 4 combined standard errors), not the same
    stream (the last losses differ)."""
    from repro_torch.core import baselines as B
    task, dep, trainer = gate_cell
    cfg = dep.cfg
    consts = (task.dim, task.g_max, cfg.energy_per_symbol, cfg.noise_power)
    agg = (B.VanillaOTA(*consts) if scheme == "vanilla"
           else B.UQOS(dep, *consts, cfg.bandwidth_hz))
    run = dict(rounds=rounds, trials=trials, eval_every=10, seed=5)
    replay = trainer.run(agg, **run)
    fast = trainer.run(agg, rng="fast", **run)
    _assert_statistically_equivalent(replay, fast)
    assert not np.allclose(replay.global_loss[:, -1],
                           fast.global_loss[:, -1], rtol=1e-10)


def test_fast_and_replay_selection_and_fading_laws(digital_schemes):
    """Over 2000 rounds of the d = 650 cell, UQOS's selection frequencies
    and the deployment's outage frequencies agree between the streams
    within 4 binomial standard errors. (That cell's 12-trial loss
    trajectories do not pass the 4-sigma gate, in the reference's
    engine as in the port's: ROADMAP Queue 3.)"""
    case, schemes = digital_schemes
    agg = schemes["uqos"]
    port = scheme_port(interop.scheme(agg))
    T, n = 2000, L.N
    replay = torch.from_numpy(port.sel_stream_np(L.SEED, 0, T))[None]
    fast = port.sel_stream_fast(rngstream.round_keys(
        [rngstream.stream_base_key(L.SEED, 0, rngstream.SELECT_TAG)], T))
    pi = torch.from_numpy(np.asarray(agg.pi))

    def chosen(sel):
        order = sel[..., :n].to(torch.int64)
        keys = sel[..., n:] ** (1.0 / pi[order])
        top = torch.argsort(keys, dim=-1, stable=True).flip(-1)[..., :agg.k]
        return torch.zeros(sel.shape[:-1] + (n,), dtype=torch.float64
                           ).scatter(-1, order.gather(-1, top), 1.0)[0]

    lam = case["dep"].lambdas
    thr = np.sqrt(lam)           # |h|^2 >= Lambda, probability exp(-1)
    h_fast = channel.fading_abs_fast(
        [rngstream.stream_base_key(L.SEED, 0, rngstream.FADING_TAG)], T,
        lam)[0].numpy()
    h_replay = np.abs(channel.sample_fading_batch(lam, L.SEED * 1000, T))
    for a, b in ((chosen(replay).mean(0).numpy(),
                  chosen(fast).mean(0).numpy()),
                 ((h_replay >= thr).mean(0), (h_fast >= thr).mean(0))):
        p = (a + b) / 2
        assert np.all(np.abs(a - b) <= 4 * np.sqrt(2 * p * (1 - p) / T))


def test_fast_mode_makes_no_host_stream(case, monkeypatch):
    """No ``sample_fading_batch``, no sequential trial generator, no
    replayed selection in fast mode."""
    def boom(*a, **k):
        raise AssertionError("a host stream was made in fast mode")

    monkeypatch.setattr(engine_mod, "sample_fading_batch", boom)
    monkeypatch.setattr(rngstream, "trial_rng", boom)
    monkeypatch.setattr(rngstream, "replay_rounds", boom)
    cfg = case["dep"].cfg
    agg = interop.scheme(case["ref"].baselines.QML(
        case["dep"], case["task"].dim, case["task"].g_max,
        cfg.energy_per_symbol, cfg.noise_power, cfg.bandwidth_hz))
    for a in (agg, interop.scheme(case["vanilla"])):
        log = L.port_trainer(case).run(a, rounds=4, trials=2, eval_every=2,
                                       rng="fast")
        assert np.all(np.isfinite(log.global_loss))
    with pytest.raises(ValueError, match="'replay' or 'fast'"):
        L.port_trainer(case).run(agg, rounds=2, trials=1, rng="later")


def test_a_port_without_a_fast_sampler_is_refused(case, monkeypatch):
    import dataclasses
    agg = interop.scheme(case["ref"].baselines.FedTOE(
        case["dep"], case["task"].dim, case["task"].g_max,
        case["dep"].cfg.energy_per_symbol, case["dep"].cfg.noise_power,
        case["dep"].cfg.bandwidth_hz))
    real = engine_mod.scheme_port
    monkeypatch.setattr(engine_mod, "scheme_port", lambda a, **k:
                        dataclasses.replace(real(a, **k),
                                            sel_stream_fast=None))
    with pytest.raises(ValueError, match="no fast-mode sampler"):
        L.port_trainer(case).run(agg, rounds=2, trials=1, eval_every=1,
                                 rng="fast")
