"""The port's buffered-async layer against the reference's, on the CPU,
and the layers stacked.

  * the ARRIVAL stream (tag 61): ``arrival_block`` bit-equal round by
    round, and the run-wide ``arrival_blocks``;
  * ``resolve`` (tables bit-equal, hashable) and every error message the
    reference's; ``async_round`` on reference-fed inputs, trials batched,
    bit-equal to the reference's per trial (payloads, delivery mask,
    staleness and the shifted buffer), the reference's hand-built
    realization (``tests/test_async.py``), ``stale_replace``;
  * the synchronous limit (every device delivers fresh every round,
    ``arrival_rate=1``): bit-identical to the sync run;
  * the engine under ``on_missing`` "zero" and "stale", uniform and
    designed weights, the three layers stacked (with both "stale"
    carries), and the bf16 payload cast: ProposedOTA within 1e-5
    relative of the reference's JAX engine at every round; the stack's
    payloads bit-equal on reference-made gradients and its digital
    round and trajectory as the reference's;
  * ``mode="sync"`` is bit-identical to no layer, whatever the spec.
"""
import numpy as np
import pytest
import torch

from _torch_layers import (FULL_FAULT, RUN, SEED, assert_ota_close,
                           check_layered_round, digital_gate, make_case,
                           run_both, run_port)
from _torch_reference import ref  # noqa: F401  (module-scoped fixture)
from repro_torch import interop
from repro_torch.core import async_fl as A
from repro_torch.core import rngstream

ASPEC = dict(buffer_rounds=3, arrival_rate=0.6, rate_heterogeneity=1.0,
             staleness_discount=0.8)


@pytest.fixture(scope="module")
def case(ref):
    return make_case(ref)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float64))


# ------------------------------------------------------------- the stream

@pytest.mark.parametrize("seed,trial,t,n", [(0, 0, 0, 1), (5, 1, 17, 6),
                                            (2 ** 32 - 1, 3, 999, 50)])
def test_arrival_block_bit_equal(ref, seed, trial, t, n):
    assert rngstream.ARRIVAL_TAG == ref.rngstream.ARRIVAL_TAG == 61
    key = rngstream.arrival_base_key(seed, trial)
    assert key == tuple(int(v) for v in np.asarray(
        ref.rngstream.arrival_base_key(seed, trial)))
    got = rngstream.arrival_block(key, t, n)
    assert got.shape == (2, n)
    want = ref.rngstream.arrival_block(
        ref.rngstream.arrival_base_key(seed, trial), t, n)
    np.testing.assert_array_equal(np.asarray(want).view(np.uint32),
                                  got.numpy().view(np.uint32))
    np.testing.assert_array_equal(
        ref.rngstream.arrival_block_np(seed, trial, t, n),
        got.numpy().astype(np.float64))


def test_arrival_blocks_run_wide_bit_equal(ref):
    keys = [rngstream.arrival_base_key(2, tr) for tr in range(3)]
    got = rngstream.arrival_blocks(keys, 6, 9)
    assert got.shape == (3, 6, 2, 9)
    for tr in range(3):
        for t in range(6):
            np.testing.assert_array_equal(
                got[tr, t].numpy().astype(np.float64),
                ref.rngstream.arrival_block_np(2, tr, t, 9))


# ------------------------------------------------------- resolve, tables

@pytest.mark.parametrize("kw,weights", [
    (ASPEC, None), (dict(ASPEC, on_missing="stale"), None),
    (dict(buffer_rounds=4, arrival_rate=1.0), None),
    (dict(ASPEC, weighting="designed"), np.linspace(0.5, 1.5, 8)),
    (dict(buffer_rounds=1, arrival_rate=0.3, rate_heterogeneity=3.0),
     None)])
def test_resolve_tables_bit_equal(ref, kw, weights):
    mine = A.resolve("async", A.AsyncSpec(**kw), 8, weights)
    theirs = ref.async_fl.resolve("async", ref.async_fl.AsyncSpec(**kw), 8,
                                  weights)
    assert dataclasses_equal(mine, theirs)
    assert {mine: "hashable"}[mine] == "hashable"
    for table in ("rates_array", "weights_array", "cdf_array",
                  "discounts_array", "delivery_weight_array",
                  "payload_scale_array"):
        np.testing.assert_array_equal(getattr(mine, table)(),
                                      getattr(theirs, table)())
    assert A.resolve("sync", A.AsyncSpec(**kw), 8) is None


def dataclasses_equal(mine, theirs) -> bool:
    return all(getattr(mine, f) == getattr(theirs, f)
               for f in ("buffer_rounds", "on_missing", "staleness_discount",
                         "weighting", "rates", "weights"))


@pytest.mark.parametrize("call", [
    lambda m: m.resolve("semi", m.AsyncSpec(), 8),
    lambda m: m.resolve("sync", m.AsyncSpec(), 8, np.ones(8)),
    lambda m: m.resolve("async", m.AsyncSpec(weighting="designed"), 8),
    lambda m: m.resolve("async", m.AsyncSpec(), 8, np.ones(7)),
    lambda m: m.resolve("async", m.AsyncSpec(), 8, np.r_[0.0, np.ones(7)]),
    lambda m: m.resolve("async", m.AsyncSpec(), 8, np.full(8, 0.5)),
    lambda m: m.AsyncSpec(buffer_rounds=0),
    lambda m: m.AsyncSpec(staleness_discount=1.5),
    lambda m: m.AsyncSpec(on_missing="drop")])
def test_error_messages_are_the_reference(ref, call):
    with pytest.raises(ValueError) as mine:
        call(A)
    with pytest.raises(ValueError) as theirs:
        call(ref.async_fl)
    assert str(mine.value) == str(theirs.value)


# ----------------------------------------------------- async_round itself

def test_known_realization(ref):
    """The reference's hand-built uniforms (fresh, stale, out of the
    window, silent), through both packages."""
    n, k, d = 4, 2, 3
    res = A.resolve("async", A.AsyncSpec(buffer_rounds=k, arrival_rate=0.5,
                                         staleness_discount=0.5), n)
    tables = (res.rates_array(), res.cdf_array(), res.discounts_array(),
              res.payload_scale_array())
    g_old = np.arange(n * d, dtype=np.float64).reshape(n, d)
    g_new = g_old + 100.0
    buf = np.zeros((k, n, d))
    buf[0] = g_old
    u = np.array([[0.1, 0.2, 0.3, 0.9], [0.1, 0.6, 0.8, 0.1]])
    want = ref.async_fl.async_round(g_new, buf, u, *tables)
    got = A.async_round(_t(g_new), _t(buf), _t(u), *map(_t, tables))
    np.testing.assert_array_equal(got[1].numpy(), [True, True, False, False])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)
    scale = res.payload_scale_array()
    assert got[0][1, 0].item() == g_old[1, 0] * (0.5 * scale[1])


@pytest.mark.parametrize("kw", [ASPEC, dict(buffer_rounds=5, arrival_rate=0.4,
                                            rate_heterogeneity=3.0,
                                            staleness_discount=0.7)])
def test_async_round_bit_equal_batched(ref, kw):
    """Reference-made gradients and ARRIVAL uniforms over 10 rounds, three
    trials batched in the port, the buffers carried by each package."""
    trials, n, d, rounds = 3, 8, 37, 10
    res = ref.async_fl.resolve("async", ref.async_fl.AsyncSpec(**kw), n)
    tables = (res.rates_array(), res.cdf_array(), res.discounts_array(),
              res.payload_scale_array())
    buf_r = np.zeros((trials, kw["buffer_rounds"], n, d))
    buf_p = torch.zeros(trials, kw["buffer_rounds"], n, d,
                        dtype=torch.float64)
    rng = np.random.default_rng(4)
    stale_deliveries = 0
    for t in range(rounds):
        g = rng.normal(size=(trials, n, d))
        u = np.stack([ref.rngstream.arrival_block_np(SEED, tr, t, n)
                      for tr in range(trials)])
        pay_p, ok_p, buf_p = A.async_round(_t(g), buf_p, _t(u),
                                           *map(_t, tables))
        for tr in range(trials):
            pay_r, ok_r, buf_r[tr] = ref.async_fl.async_round(
                g[tr], buf_r[tr], u[tr], *tables)
            np.testing.assert_array_equal(pay_p[tr].numpy(), pay_r)
            np.testing.assert_array_equal(ok_p[tr].numpy(), ok_r)
            np.testing.assert_array_equal(buf_p[tr].numpy(), buf_r[tr])
            fresh = np.all(pay_r == g[tr] * tables[3][:, None], axis=1)
            stale_deliveries += int((ok_r & ~fresh).sum())
    assert stale_deliveries > 0


def test_stale_replace_bit_equal(ref):
    rng = np.random.default_rng(0)
    last_r = np.zeros((6, 4))
    last_p = torch.zeros(2, 6, 4, dtype=torch.float64)
    for _ in range(8):
        g = rng.normal(size=(2, 6, 4))
        ok = rng.random((2, 6)) < 0.6
        out_p, last_p = A.stale_replace(_t(g), torch.from_numpy(ok), last_p)
        out_r, last_r = ref.async_fl.stale_replace(g[0], ok[0], last_r)
        np.testing.assert_array_equal(out_p[0].numpy(), out_r)
        np.testing.assert_array_equal(last_p[0].numpy(), last_r)


# ---------------------------------------------------------- the engine

def test_synchronous_limit_is_the_sync_run(ref, case):
    """arrival_rate = 1: every device delivers its fresh gradient at
    scale v N / sum(c v) = 1, so the run is the sync run, bit for bit (in
    both packages)."""
    spec = ref.async_fl.AsyncSpec(buffer_rounds=3, arrival_rate=1.0)
    log_p, log_r = run_both(case, case["ota"], mode="async", async_spec=spec)
    base = run_port(case, case["ota"])
    np.testing.assert_array_equal(log_p.global_loss, base.global_loss)
    assert_ota_close(log_p, log_r, len(case["ds"].y_test))


@pytest.mark.parametrize("on_missing", ["zero", "stale"])
@pytest.mark.parametrize("weighting", ["uniform", "designed"])
def test_engine_matches_reference(ref, case, on_missing, weighting):
    spec = ref.async_fl.AsyncSpec(on_missing=on_missing, weighting=weighting,
                                  **ASPEC)
    weights = np.linspace(0.5, 1.5, 6) if weighting == "designed" else None
    log_p, log_r = run_both(case, case["ota"], mode="async", async_spec=spec,
                            async_weights=weights)
    assert_ota_close(log_p, log_r, len(case["ds"].y_test))


STACK = dict(payload_dtype="bf16", clients_per_round=4,
             participation="channel", mode="async")


def _stack(ref):
    return dict(STACK, async_spec=ref.async_fl.AsyncSpec(
        on_missing="stale", **ASPEC),
        fault=ref.faults.FaultSpec(on_missing="stale", **FULL_FAULT))


def test_all_three_layers_stacked(ref, case):
    log_p, log_r = run_both(case, case["ota"], **_stack(ref))
    assert_ota_close(log_p, log_r, len(case["ds"].y_test))


def test_stacked_layers_digital(ref, case):
    kw = _stack(ref)
    check_layered_round(case, **kw)
    kw["fault"] = ref.faults.FaultSpec(on_missing="zero", **FULL_FAULT)
    assert check_layered_round(case, **kw) > 0
    run = dict(rounds=20, trials=4, eval_every=5, seed=SEED)
    log_p, log_r = run_both(case, case["digital"], run, **kw)
    digital_gate(log_p, log_r, n_samples=len(case["ds"].devices) * 200)


def test_bf16_payloads_match_reference(ref, case):
    log_p, log_r = run_both(case, case["ota"], payload_dtype="bf16")
    assert_ota_close(log_p, log_r, len(case["ds"].y_test))
    base = run_port(case, case["ota"])
    assert not np.array_equal(log_p.global_loss, base.global_loss)
    assert check_layered_round(case, rounds=2, payload_dtype="bf16") == 0


def test_sync_mode_is_bit_identical(case):
    base = run_port(case, case["ota"])
    log = run_port(case, case["ota"], mode="sync",
                   async_spec=A.AsyncSpec(buffer_rounds=2,
                                          on_missing="stale"))
    np.testing.assert_array_equal(log.global_loss, base.global_loss)
    np.testing.assert_array_equal(log.wall_time_s, base.wall_time_s)
    with pytest.raises(ValueError, match="mode is 'sync'"):
        run_port(case, case["ota"], async_weights=np.ones(6))
    assert RUN["eval_every"] == 1
    assert interop.async_spec(A.AsyncSpec(**ASPEC)) == A.AsyncSpec(**ASPEC)
