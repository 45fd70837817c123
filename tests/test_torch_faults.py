"""The port's fault layer against the reference's, on the CPU.

  * the FAULT stream (tag 53): ``fault_block`` bit-equal to
    ``repro.core.rngstream.fault_block`` round by round, and the
    run-wide ``fault_blocks`` the engine makes (trials x rounds in one
    pass) bit-equal to the same blocks;
  * ``outage_mask`` with the deep-fade threshold and ``fault_masks``
    (batched over trials) bit-equal on reference-fed uniforms and |h|;
  * the engine under each ``on_missing`` policy, under a deadline with
    stragglers and under stragglers without one: ProposedOTA and Vanilla
    OTA within 1e-5 relative of the reference's JAX engine at every
    round, wall-clocks equal; the three policies differ;
  * ProposedDigital: the faulted payloads bit-equal on reference-made
    gradients, its round on them as the reference's (zeroed rows quantize
    to exact zeros), and its trajectory within the 4-sigma gate;
  * a disabled ``FaultSpec`` (and ``straggler_mult`` alone) is
    bit-identical to no fault layer.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_layers import (FULL_FAULT, SEED, assert_ota_close,
                           check_layered_round, digital_gate, make_case,
                           run_both, run_port)
from _torch_reference import one_thread, ref  # noqa: F401  (fixtures)
from repro_torch import interop
from repro_torch.core import rngstream
from repro_torch.core.digital import outage_mask
from repro_torch.core.faults import FaultSpec, fault_masks, survival_prob

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def case(ref):
    return make_case(ref)


def _bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32).view(np.uint32)


# ------------------------------------------------------------- the stream

def test_threefry_layout_is_the_pinned_one(ref):
    assert ref.jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed,trial,t,n", [(0, 0, 0, 1), (5, 1, 17, 6),
                                            (2 ** 32 - 1, 3, 999, 50)])
def test_fault_block_bit_equal(ref, seed, trial, t, n):
    assert rngstream.FAULT_TAG == ref.rngstream.FAULT_TAG == 53
    key = rngstream.fault_base_key(seed, trial)
    assert key == tuple(int(v) for v in np.asarray(
        ref.rngstream.fault_base_key(seed, trial)))
    want = ref.rngstream.fault_block(ref.rngstream.fault_base_key(
        seed, trial), t, n)
    got = rngstream.fault_block(key, t, n)
    assert got.shape == (3, n)
    np.testing.assert_array_equal(_bits(want), _bits(got.numpy()))
    # the oracle's f64 view is the exact widening
    np.testing.assert_array_equal(
        ref.rngstream.fault_block_np(seed, trial, t, n),
        got.numpy().astype(np.float64))


def test_fault_blocks_run_wide_bit_equal(ref):
    keys = [rngstream.fault_base_key(7, tr) for tr in range(3)]
    got = rngstream.fault_blocks(keys, 9, 5)
    assert got.shape == (3, 9, 3, 5) and got.dtype == torch.float32
    for tr in range(3):
        for t in range(9):
            np.testing.assert_array_equal(
                got[tr, t].numpy().astype(np.float64),
                ref.rngstream.fault_block_np(7, tr, t, 5))


# ---------------------------------------------------------------- masks

@pytest.mark.parametrize("thr", [0.0, 2e-6, np.array([0.0, 1e-6, 3e-6])])
@pytest.mark.parametrize("dft", [0.0, 1e-6, 5e-6])
def test_outage_mask_with_deep_fades_bit_equal(ref, thr, dft):
    habs = np.abs(np.random.default_rng(3).normal(size=(4, 3)) * 3e-6)
    want = ref.digital.outage_mask(habs, thr, deep_fade_thresh=dft)
    got = outage_mask(torch.from_numpy(habs), thr, deep_fade_thresh=dft)
    np.testing.assert_array_equal(got.numpy(), want)
    if dft == 0.0:      # today's rule, the same bits
        np.testing.assert_array_equal(
            got.numpy(), outage_mask(torch.from_numpy(habs), thr).numpy())


FAULTS = [dict(FULL_FAULT, on_missing="zero"),
          dict(dropout_prob=0.2, straggler_prob=0.3, deadline_s=1e-4,
               on_missing="zero"),
          dict(erasure_prob=0.5, deep_fade_thresh=3e-6, on_missing="stale")]


@pytest.mark.parametrize("kw", FAULTS)
def test_fault_masks_bit_equal(ref, case, kw):
    """Trials batched in the port, per trial in the reference."""
    f_r = ref.faults.FaultSpec(**kw)
    f_p = interop.fault_spec(f_r)
    assert f_p == FaultSpec(**kw)
    lam = case["dep"].lambdas
    np.testing.assert_array_equal(survival_prob(f_p, lam),
                                  ref.faults.survival_prob(f_r, lam))
    trials, rounds, n = 3, 8, lam.shape[0]
    u = np.stack([np.stack([ref.rngstream.fault_block_np(SEED, tr, t, n)
                            for t in range(rounds)]) for tr in range(trials)])
    habs = np.abs(np.stack([ref.channel.sample_fading_batch(
        lam, SEED * 1000 + tr, rounds) for tr in range(trials)]))
    ok, strag = fault_masks(torch.from_numpy(u), torch.from_numpy(habs), f_p)
    assert ok.dtype == torch.bool and ok.shape == (trials, rounds, n)
    missed = 0
    for tr in range(trials):
        for t in range(rounds):
            ok_r, strag_r = ref.faults.fault_masks(u[tr, t], habs[tr, t],
                                                   f_r)
            np.testing.assert_array_equal(ok[tr, t].numpy(), ok_r)
            np.testing.assert_array_equal(strag[tr, t].numpy(), strag_r)
            missed += int((~ok_r).sum())
    assert 0 < missed < trials * rounds * n


# ---------------------------------------------------------- the engine

@pytest.mark.parametrize("policy", ["zero", "reweight", "stale"])
def test_engine_policy_matches_reference(ref, case, policy):
    f = ref.faults.FaultSpec(on_missing=policy, **FULL_FAULT)
    log_p, log_r = run_both(case, case["ota"], fault=f)
    assert_ota_close(log_p, log_r, len(case["ds"].y_test))


def test_policies_actually_differ(ref, case):
    finals = [run_port(case, case["ota"], fault=ref.faults.FaultSpec(
        on_missing=p, **FULL_FAULT)).global_loss[:, -1].tolist()
        for p in ("zero", "reweight", "stale")]
    assert len({tuple(f) for f in finals}) == 3, finals


def test_deadline_caps_rounds_with_stragglers(ref, case):
    f = ref.faults.FaultSpec(dropout_prob=0.2, straggler_prob=0.3,
                             deadline_s=1e-4, on_missing="zero")
    log_p, log_r = run_both(case, case["vanilla"], fault=f)
    assert_ota_close(log_p, log_r, len(case["ds"].y_test))
    # Vanilla's round takes d/B, longer than the deadline: every round is
    # capped at it
    assert case["task"].dim / case["dep"].cfg.bandwidth_hz > 1e-4
    np.testing.assert_allclose(np.diff(log_p.wall_time_s), 1e-4, rtol=1e-9)


def test_stragglers_stretch_rounds_without_a_deadline(ref, case):
    base = ref.faults.FaultSpec(dropout_prob=0.1, on_missing="zero")
    slow = dataclasses.replace(base, straggler_prob=0.5, straggler_mult=4.0)
    log_p, log_r = run_both(case, case["ota"], fault=slow)
    assert_ota_close(log_p, log_r, len(case["ds"].y_test))
    t_base = run_port(case, case["ota"], fault=base).wall_time_s[-1]
    assert log_p.wall_time_s[-1] > t_base


def test_digital_round_on_faulted_payloads(ref, case):
    for policy in ("zero", "reweight", "stale"):
        zeroed = check_layered_round(case, fault=ref.faults.FaultSpec(
            on_missing=policy, **FULL_FAULT))
        assert zeroed > 0 or policy == "stale"


def test_digital_trajectory_gate(ref, case):
    f = ref.faults.FaultSpec(on_missing="zero", **FULL_FAULT)
    run = dict(rounds=20, trials=4, eval_every=5, seed=SEED)
    log_p, log_r = run_both(case, case["digital"], run, fault=f)
    digital_gate(log_p, log_r, n_samples=len(case["ds"].devices) * 200)


def test_disabled_fault_is_bit_identical(case):
    base = run_port(case, case["ota"])
    for f in (FaultSpec(), FaultSpec(straggler_mult=10.0),
              FaultSpec(on_missing="stale")):
        assert not f.enabled
        log = run_port(case, case["ota"], fault=f)
        np.testing.assert_array_equal(log.global_loss, base.global_loss)
        np.testing.assert_array_equal(log.wall_time_s, base.wall_time_s)

