"""The port's mini-batch SGD against the reference.

  * the batch streams (``rngstream.batch_indices``, ``batch_block``,
    ``_ragged``, ``_mixed`` and the engine's ``batch_blocks``) bit-equal
    to ``repro.core.rngstream``'s, B = n_m - 1 and B = n_m among them,
    and a draw whose sort keys collide (stability decides the order);
  * ``device_grads_at`` and ``device_grads_at_weighted`` of both tasks,
    and ``SyntheticHighDimTask``'s gradients, within 1e-6 of the largest
    entry of the reference's (torch and XLA f32 reductions differ in the
    last bits); ``DeviceDataset.batch`` and ``partition_iid`` exactly;
  * trajectories: ``FLTrainer.run(batch_size=...)`` on the CPU against
    the reference's JAX engine, every round an eval point: OTA within
    1e-5 relative for equal, ragged (unequal sizes, B below all) and mixed
    (B covering some devices) batches; ProposedDigital under the 4-sigma
    gate; the counter-only scheme (IdealFedAvg) equal across rng modes.
"""
import numpy as np
import pytest
import torch

import _torch_layers as L
from _torch_reference import ref  # noqa: F401  (module-scoped fixture)
from repro_torch import interop
from repro_torch.core import rngstream
from repro_torch.data import DeviceDataset, partition_iid
from repro_torch.fl import (FLEngine, MLPTask, SoftmaxRegressionTask,
                            SyntheticHighDimTask)
from repro_torch.fl import engine as engine_mod

GRAD_TOL = 1e-6
#: device sizes of the unequal cell (N = 6)
SIZES = (200, 150, 120, 90, 200, 60)


def test_threefry_layout_is_the_pinned_one(ref):
    assert ref.jax.config.jax_threefry_partitionable is True


# ------------------------------------------------------------ streams

@pytest.mark.parametrize("n,B", [(1, 1), (2, 1), (7, 3), (300, 16),
                                 (1000, 64), (1000, 256), (1626, 64),
                                 (64, 63), (64, 64)])
def test_batch_indices_bit_equal(ref, n, B):
    for seed, trial, t, m in ((0, 0, 0, 0), (5, 1, 17, 3),
                              (2 ** 32 - 1, 2, 299, 49)):
        want = ref.rngstream.batch_indices_np(seed, trial, t, m, n, B)
        got = rngstream.batch_indices(rngstream.batch_base_key(seed, trial),
                                      t, m, n, B)
        np.testing.assert_array_equal(got.numpy(), want)


def test_colliding_sort_keys_keep_jax_order(ref):
    """Seed 0, trial 0, round 29, device 36 at n = 1000: two of the
    shuffle's 32-bit sort keys are equal, so only a stable sort gives
    JAX's permutation."""
    key = rngstream.batch_base_key(0, 0)
    k = rngstream.fold_in(rngstream.fold_in(key, 29), 36)
    _, sub = rngstream.split(k, 2)
    bits = rngstream.random_bits32(sub, (1000,))
    assert len(torch.unique(bits)) < 1000
    want = ref.rngstream.batch_indices_np(0, 0, 29, 36, 1000, 1000)
    np.testing.assert_array_equal(
        rngstream.batch_indices(key, 29, 36, 1000, 1000).numpy(), want)


@pytest.mark.parametrize("N,n,B", [(6, 200, 16), (50, 300, 64),
                                   (4, 1000, 256), (3, 40, 39)])
def test_batch_block_bit_equal(ref, N, n, B):
    for seed, trial, t in ((0, 0, 0), (5, 1, 7), (123, 3, 511)):
        want = ref.rngstream.batch_block_np(seed, trial, t, N, n, B)
        got = rngstream.batch_block(rngstream.batch_base_key(seed, trial),
                                    t, N, n, B)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("sizes,B", [(SIZES, 50), (SIZES, 59),
                                     ((40, 41, 300, 1626), 40)])
def test_batch_block_ragged_bit_equal(ref, sizes, B):
    rs = ref.rngstream
    for seed, trial, t in ((0, 0, 0), (5, 1, 13)):
        want = np.asarray(rs.batch_block_ragged(rs.batch_base_key(seed,
                                                                  trial),
                                                t, sizes, B))
        got = rngstream.batch_block_ragged(rngstream.batch_base_key(
            seed, trial), t, sizes, B)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("sizes,B", [(SIZES, 100), (SIZES, 150),
                                     (SIZES, 199), ((40, 41, 300), 41)])
def test_batch_block_mixed_bit_equal(ref, sizes, B):
    """Full rows (n_m <= B, B = n_m among them) draw nothing and gather
    ``min(arange(B), n_m - 1)``; the others are the ragged draw."""
    rs = ref.rngstream
    for seed, trial, t in ((0, 0, 0), (5, 1, 13)):
        want = np.asarray(rs.batch_block_mixed(rs.batch_base_key(seed,
                                                                 trial),
                                               t, sizes, B))
        got = rngstream.batch_block_mixed(rngstream.batch_base_key(
            seed, trial), t, sizes, B)
        np.testing.assert_array_equal(got.numpy(), want)


def test_batch_blocks_rows_are_the_single_draws():
    """The engine's (trials, rounds, N, B) block: row (k, r, m) is
    ``batch_indices`` of trial k's key in round t0 + r for device m."""
    keys = [rngstream.batch_base_key(3, tr) for tr in range(3)]
    block = rngstream.batch_blocks(keys, 5, 4, SIZES, 30)
    assert block.shape == (3, 4, 6, 30)
    for k, key in enumerate(keys):
        for r in range(4):
            for m, n_m in enumerate(SIZES):
                np.testing.assert_array_equal(
                    block[k, r, m].numpy(),
                    rngstream.batch_indices(key, 5 + r, m, n_m, 30).numpy())
    with pytest.raises(ValueError, match="without replacement"):
        rngstream.batch_blocks(keys, 0, 1, SIZES, 61)


def test_chunked_streams_equal_one_block(monkeypatch):
    """A stream made in chunks of rounds equals it made at once."""
    keys = [rngstream.batch_base_key(3, tr) for tr in range(2)]

    def make(t0, r):
        return rngstream.batch_blocks(keys, t0, r, (50,) * 4, 7)

    whole = make(0, 9)
    monkeypatch.setattr(engine_mod, "_CHUNK_ENTRIES", 2 * 4 * 50 * 2)
    chunked = engine_mod._Chunked(make, 2 * 4 * 50, 9)
    assert chunked.rounds == 2
    for t in range(9):
        np.testing.assert_array_equal(chunked[t].numpy(),
                                      whole[:, t].numpy())


# -------------------------------------------------------------- tasks

def _max_rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _task_pairs(ref, F):
    return ((ref.tasks.SoftmaxRegressionTask(F, mu=0.01, g_max=20.0),
             SoftmaxRegressionTask(F, mu=0.01, g_max=20.0)),
            (ref.tasks.MLPTask(F, hidden=9, seed=3),
             MLPTask(F, hidden=9, seed=3)),
            (ref.tasks.MLPTask(F, hidden=9, g_max=0.5, seed=1),
             MLPTask(F, hidden=9, g_max=0.5, seed=1)))


@pytest.mark.parametrize("pair", [0, 1, 2])
def test_device_grads_at_match_reference(ref, pair):
    """Mean and weighted mini-batch gradients (the last task clips every
    device) within GRAD_TOL of the largest entry; (K, N, B) indices give
    each model its own batch."""
    rng = np.random.default_rng(pair)
    N, n, F, B = 5, 40, 12, 8
    task_r, task_p = _task_pairs(ref, F)[pair]
    xs = rng.normal(size=(N, n, F)).astype(np.float32)
    ys = rng.integers(0, 10, (N, n)).astype(np.int32)
    idx = np.stack([rng.choice(n, B, replace=False) for _ in range(N)])
    wt = rng.uniform(size=(N, B)).astype(np.float32)
    ws = [(task_r.init_params() + rng.normal(size=task_r.dim) * 0.3
           ).astype(np.float32) for _ in range(2)]
    t = torch.from_numpy
    xs_t, ys_t = t(xs), t(ys.astype(np.int64))
    for w in ws:
        want = np.asarray(task_r.device_grads_at_fn(w, xs, ys,
                                                    idx.astype(np.int32)))
        got = task_p.device_grads_at(t(w), xs_t, ys_t, t(idx)).numpy()
        assert got.dtype == np.float32 and got.shape == (N, task_p.dim)
        assert _max_rel(got, want) <= GRAD_TOL
        want = np.asarray(task_r.device_grads_at_weighted_fn(
            w, xs, ys, idx.astype(np.int32), wt))
        got = task_p.device_grads_at_weighted(t(w), xs_t, ys_t, t(idx),
                                              t(wt)).numpy()
        assert _max_rel(got, want) <= GRAD_TOL
    # K models, each on its own batch
    idx2 = t(np.stack([idx, idx[:, ::-1].copy()]))
    both = task_p.device_grads_at(t(np.stack(ws)), xs_t, ys_t, idx2)
    for k in range(2):
        np.testing.assert_array_equal(
            both[k].numpy(),
            task_p.device_grads_at(t(ws[k]), xs_t, ys_t, idx2[k]).numpy())
    # a batch of every row is the full-batch gradient
    full = t(np.tile(np.arange(n), (N, 1)))
    np.testing.assert_allclose(
        task_p.device_grads_at(t(ws[0]), xs_t, ys_t, full).numpy(),
        task_p.device_grads(t(ws[0]), xs_t, ys_t).numpy(), rtol=0,
        atol=GRAD_TOL * float(np.abs(want).max()))


@pytest.mark.parametrize("dim,g_max,seed", [(300, 5.0, 4), (7001, 1e9, 0)])
def test_synthetic_high_dim_task_matches_reference(ref, dim, g_max, seed):
    task_r = ref.tasks.SyntheticHighDimTask(dim, g_max=g_max, seed=seed)
    task_p = interop.task(task_r)
    assert isinstance(task_p, SyntheticHighDimTask)
    xs, ys = task_r.device_data(6)
    xs_p, ys_p = task_p.device_data(6)
    np.testing.assert_array_equal(xs, xs_p)
    np.testing.assert_array_equal(ys, ys_p)
    rng = np.random.default_rng(dim)
    w = rng.normal(size=dim).astype(np.float32)
    want = np.asarray(task_r.device_grads_fn(w, xs, ys))
    t = torch.from_numpy
    got = task_p.device_grads(t(w), t(xs), t(ys))
    assert _max_rel(got.numpy(), want) <= GRAD_TOL
    idx = np.zeros((6, 1), np.int32)
    np.testing.assert_array_equal(
        task_p.device_grads_at(t(w), t(xs), t(ys), t(idx)).numpy(),
        got.numpy())
    want_at = np.asarray(task_r.device_grads_at_fn(w, xs, ys, idx))
    assert _max_rel(got.numpy(), want_at) <= GRAD_TOL
    x_all = xs.reshape(6, 1)
    np.testing.assert_allclose(
        float(task_p.loss(t(w), t(x_all), None)),
        task_r.global_loss(w, x_all, ys.reshape(-1)), rtol=GRAD_TOL)
    assert task_p.init_params().shape == (dim,)


# ------------------------------------------------------- data helpers

def test_device_dataset_batch_matches_reference(ref):
    rng = np.random.default_rng(0)
    x, y = rng.normal(size=(30, 4)), rng.integers(0, 3, 30)
    dr, dp = ref.loader.DeviceDataset(x, y), DeviceDataset(x, y)
    for bs in (None, 30, 31):
        for got, want in zip(dp.batch(bs), dr.batch(bs)):
            np.testing.assert_array_equal(got, want)
    idx = ref.rngstream.batch_indices_np(0, 0, 3, 0, 30, 8)
    for got, want in zip(dp.batch(8, indices=idx),
                         dr.batch(8, indices=idx)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(dp.batch(8, np.random.default_rng(4)),
                         dr.batch(8, np.random.default_rng(4))):
        np.testing.assert_array_equal(got, want)
    for args, kw, match in (((8, np.random.default_rng(0)),
                             dict(indices=idx), "not both"),
                            ((8,), {}, "counter-based indices")):
        with pytest.raises(ValueError, match=match):
            dr.batch(*args, **kw)
        with pytest.raises(ValueError, match=match):
            dp.batch(*args, **kw)
    # the third refusal: both arguments, even at full batch
    with pytest.raises(ValueError, match="not both"):
        dp.batch(None, np.random.default_rng(0), indices=idx)


def test_partition_iid_matches_reference(ref):
    rng = np.random.default_rng(1)
    x, y = rng.normal(size=(500, 3)), rng.integers(0, 10, 500)
    want = ref.partition.partition_iid(x, y, 7, 60, seed=9)
    got = partition_iid(x, y, 7, 60, seed=9)
    assert len(got) == len(want) == 7
    for (xg, yg), (xw, yw) in zip(got, want):
        np.testing.assert_array_equal(xg, xw)
        np.testing.assert_array_equal(yg, yw)


# ------------------------------------------------------- trajectories

@pytest.fixture(scope="module")
def case(ref):
    return L.make_case(ref)


@pytest.fixture(scope="module")
def unequal(ref, case):
    """The cell with devices cut to ``SIZES`` samples."""
    ds = case["ds"]
    shards = [(d.x[:s], d.y[:s]) for d, s in zip(ds.devices, SIZES)]
    ds2 = ref.loader.FLDataset.from_shards(shards, ds.x_test, ds.y_test)
    return dict(case, ds=ds2, port_ds=interop.dataset(ds2))


@pytest.mark.parametrize("cell,B,scheme", [
    ("equal", 16, "ota"), ("equal", 64, "vanilla"), ("equal", 199, "ota"),
    ("unequal", 50, "ota"), ("unequal", 59, "vanilla"),
    ("unequal", 100, "ota"), ("unequal", 150, "vanilla")])
def test_ota_minibatch_trajectory_matches_reference(case, unequal, cell, B,
                                                    scheme):
    """Equal sizes (B = 199 of 200 among them), ragged (B below every
    size) and mixed (B = 100, 150 cover some devices) within 1e-5 at
    every round."""
    c = case if cell == "equal" else unequal
    log_p, log_r = L.run_both(c, c[scheme], batch_size=B)
    L.assert_ota_close(log_p, log_r, len(c["ds"].y_test))


def test_engine_regimes(case, unequal):
    """Which regime each (sizes, B) takes, the mixed weights, and the
    global loss over the real rows only."""
    def engine(c, B):
        return FLEngine(c["port_task"], c["port_ds"], c["port_dep"],
                        c["eta"], batch_size=B, device="cpu")

    assert engine(case, 200).batch_size is None        # B >= |D|: full
    assert FLEngine.effective_batch_size(16, 200) == 16
    assert FLEngine.effective_batch_size(None, 200) is None
    ragged = engine(unequal, 50)
    assert ragged.batch_wts is None and ragged.xs.shape == (6, 200, 64)
    assert ragged.x_all.shape == (sum(SIZES), 64)
    np.testing.assert_array_equal(
        ragged.x_all.numpy(),
        np.concatenate([d.x for d in unequal["port_ds"].devices]))
    mixed = engine(unequal, 100)
    wts = mixed.batch_wts.numpy()
    assert wts.dtype == np.float32
    np.testing.assert_array_equal(wts[3, :90], np.float32(1 / 90))
    np.testing.assert_array_equal(wts[3, 90:], 0.0)
    np.testing.assert_array_equal(wts[0], np.float32(1 / 100))
    with pytest.raises(ValueError, match="needs a mini-batch size"):
        engine(unequal, None)
    with pytest.raises(NotImplementedError, match="item 10 step 6"):
        FLEngine(case["port_task"], case["port_ds"], case["port_dep"],
                 case["eta"], shard_trials=True, device="cpu")


def test_digital_minibatch_gate(case):
    """ProposedDigital on mini-batches of 32: the 4-sigma gate over 4
    trials (torch and XLA gradients flip a rare dither code)."""
    run = dict(L.RUN, trials=4, rounds=10)
    log_p, log_r = L.run_both(case, case["digital"], run=run, batch_size=32)
    L.digital_gate(log_p, log_r, sum(len(d) for d in case["ds"].devices))


def test_counter_only_scheme_equal_across_rng_modes(case):
    """IdealFedAvg on mini-batches draws only the batch stream, which is
    the same in both modes: the trajectories are equal to the bit."""
    agg = interop.scheme(case["ref"].baselines.IdealFedAvg())
    tr = L.port_trainer(case, batch_size=32)
    a = tr.run(agg, **L.RUN)
    b = tr.run(agg, rng="fast", **L.RUN)
    np.testing.assert_array_equal(a.global_loss, b.global_loss)
    np.testing.assert_array_equal(a.accuracy, b.accuracy)
