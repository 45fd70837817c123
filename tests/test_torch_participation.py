"""The port's partial-participation layer against the reference's, on the
CPU.

  * the PARTICIPATE stream (tag 59): ``participation_block`` bit-equal
    round by round, and the run-wide ``participation_blocks``;
  * ``resolve`` and ``capped_proportional`` bit-equal (probabilities,
    scale, the hashable resolved object), full cohorts, and every error
    message the reference's; the "datasize" weights equal and the "loss"
    weights within f32 rounding; ``ota.expected_participation`` equal;
  * the engine under the uniform, channel, designed (explicit
    probabilities), loss and datasize policies: ProposedOTA and Vanilla
    OTA within 1e-5 relative of the reference's JAX engine at every
    round;
  * ProposedDigital under sampling plus the fault layer: payloads
    bit-equal on reference-made gradients, its round as the reference's,
    the 4-sigma gate;
  * ``clients_per_round=None`` is bit-identical to no layer, whatever
    the policy.
"""
import numpy as np
import pytest
import torch

from _torch_layers import (FULL_FAULT, SEED, assert_ota_close,
                           check_layered_round, digital_gate, make_case,
                           run_both, run_port)
from _torch_reference import one_thread, ref  # noqa: F401  (fixtures)
from repro_torch import interop
from repro_torch.core import participation as P
from repro_torch.core import rngstream
from repro_torch.core.ota import expected_participation

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def case(ref):
    return make_case(ref)


# ------------------------------------------------------------- the stream

@pytest.mark.parametrize("seed,trial,t,n", [(0, 0, 0, 1), (5, 1, 17, 6),
                                            (2 ** 32 - 1, 3, 999, 50)])
def test_participation_block_bit_equal(ref, seed, trial, t, n):
    assert rngstream.PARTICIPATE_TAG == ref.rngstream.PARTICIPATE_TAG == 59
    key = rngstream.participate_base_key(seed, trial)
    assert key == tuple(int(v) for v in np.asarray(
        ref.rngstream.participate_base_key(seed, trial)))
    got = rngstream.participation_block(key, t, n)
    assert got.shape == (n,) and got.dtype == torch.float32
    want = ref.rngstream.participation_block(
        ref.rngstream.participate_base_key(seed, trial), t, n)
    np.testing.assert_array_equal(np.asarray(want).view(np.uint32),
                                  got.numpy().view(np.uint32))
    np.testing.assert_array_equal(
        ref.rngstream.participation_block_np(seed, trial, t, n),
        got.numpy().astype(np.float64))


def test_participation_blocks_run_wide_bit_equal(ref):
    keys = [rngstream.participate_base_key(3, tr) for tr in range(2)]
    got = rngstream.participation_blocks(keys, 11, 7)
    assert got.shape == (2, 11, 7)
    for tr in range(2):
        for t in range(11):
            np.testing.assert_array_equal(
                got[tr, t].numpy().astype(np.float64),
                ref.rngstream.participation_block_np(3, tr, t, 7))


# -------------------------------------------------- resolve, the policies

LAMBDAS = np.array([1.0, 1.0, 1e3, 1e-3, 2.0, 0.5, 1.0, 4.0])


@pytest.mark.parametrize("args,kw", [
    ((4, "uniform"), {}), ((8, "uniform"), {}), ((1, "uniform"), {}),
    ((4, "channel"), dict(lambdas=LAMBDAS)),
    ((3, "channel"), dict(lambdas=np.geomspace(1e-9, 1e-6, 8))),
    ((4, "designed"), dict(probs=np.full(8, 0.5))),
    ((4, "loss"), dict(weights=np.array([3.0, 1, 1, 40, 2, 1, 1, 1]))),
    ((5, "datasize"), dict(weights=np.arange(1.0, 9.0)))])
def test_resolve_bit_equal(ref, args, kw):
    mine = P.resolve(*args, n_devices=8, **kw)
    theirs = ref.participation.resolve(*args, n_devices=8, **kw)
    assert mine == interop.resolved_participation(theirs)
    assert (mine.clients, mine.policy, mine.probs) == \
        (theirs.clients, theirs.policy, theirs.probs)
    assert mine.scale == theirs.scale
    assert {mine: "hashable"}[mine] == "hashable"
    if args[0] == 8:       # the full cohort: everyone, scale 1
        assert mine.probs == (1.0,) * 8 and mine.scale == 1.0


@pytest.mark.parametrize("w,s", [
    (np.array([0.1, 10.0, 1.0, 1.0, 5.0, 0.01]), 3),
    (np.array([0.1, 10.0, 1.0, 1.0, 5.0, 0.01]), 6),
    (np.geomspace(1e-3, 1e3, 50), 16), (np.ones(12), 5)])
def test_capped_proportional_bit_equal(ref, w, s):
    np.testing.assert_array_equal(P.capped_proportional(w, s),
                                  ref.participation.capped_proportional(w, s))


@pytest.mark.parametrize("call", [
    lambda m: m.resolve(None, probs=np.full(8, 0.5), n_devices=8),
    lambda m: m.resolve(4, "importance", n_devices=8),
    lambda m: m.resolve(0, n_devices=8),
    lambda m: m.resolve(9, n_devices=8),
    lambda m: m.resolve(4, "channel", n_devices=8),
    lambda m: m.resolve(4, "designed", n_devices=8),
    lambda m: m.resolve(4, "loss", n_devices=8),
    lambda m: m.resolve(4, "designed", probs=np.full(7, 0.5), n_devices=8),
    lambda m: m.resolve(4, "designed", probs=np.r_[1.5, np.full(7, 0.5)],
                        n_devices=8),
    lambda m: m.resolve(4, "designed", probs=np.full(8, 0.4), n_devices=8),
    lambda m: m.capped_proportional(np.array([1.0, 0.0, 0.0]), 2),
    lambda m: m.capped_proportional(np.array([1.0, -1.0, 2.0]), 1),
    lambda m: m.policy_weights("loss")])
def test_error_messages_are_the_reference(ref, call):
    with pytest.raises(ValueError) as mine:
        call(P)
    with pytest.raises(ValueError) as theirs:
        call(ref.participation)
    assert str(mine.value) == str(theirs.value)


def test_policy_weights_match_reference(ref, case):
    assert P.POLICIES == ref.participation.POLICIES
    assert P.WEIGHTED_POLICIES == ref.participation.WEIGHTED_POLICIES
    np.testing.assert_array_equal(
        P.policy_weights("datasize", case["port_task"], case["port_ds"]),
        ref.participation.policy_weights("datasize", case["task"],
                                         case["ds"]))
    mine = P.policy_weights("loss", case["port_task"], case["port_ds"])
    theirs = ref.participation.policy_weights("loss", case["task"],
                                              case["ds"])
    # f32 losses: torch and XLA may order the mean's adds differently
    np.testing.assert_allclose(mine, theirs, rtol=4e-7, atol=0)
    assert P.policy_weights("uniform") is None


def test_expected_participation_matches_reference(ref, case):
    params = case["ota"].params
    np.testing.assert_array_equal(
        expected_participation(interop.ota_params(params),
                               case["dep"].lambdas),
        ref.ota.expected_participation(params, case["dep"].lambdas))


# ---------------------------------------------------------- the engine

def _designed_probs(n, s):
    pi = np.linspace(0.2, 1.0, n)
    return P.capped_proportional(pi, s)


@pytest.mark.parametrize("policy", ["uniform", "channel", "designed",
                                    "loss", "datasize"])
def test_engine_policy_matches_reference(ref, case, policy):
    kw = dict(clients_per_round=3, participation=policy)
    if policy == "designed":
        kw["participation_probs"] = _designed_probs(6, 3)
    log_p, log_r = run_both(case, case["ota"], **kw)
    assert_ota_close(log_p, log_r, len(case["ds"].y_test))


def test_vanilla_full_cohort_matches_reference(ref, case):
    log_p, log_r = run_both(case, case["vanilla"], clients_per_round=6)
    assert_ota_close(log_p, log_r, len(case["ds"].y_test))


def test_sampling_with_faults_digital(ref, case):
    kw = dict(clients_per_round=3, participation="channel",
              fault=ref.faults.FaultSpec(on_missing="zero", **FULL_FAULT))
    assert check_layered_round(case, **kw) > 0
    run = dict(rounds=20, trials=4, eval_every=5, seed=SEED)
    log_p, log_r = run_both(case, case["digital"], run, **kw)
    digital_gate(log_p, log_r, n_samples=len(case["ds"].devices) * 200)


def test_no_cohort_size_is_bit_identical(case):
    base = run_port(case, case["ota"])
    for policy in ("uniform", "designed", "loss"):
        log = run_port(case, case["ota"], participation=policy)
        np.testing.assert_array_equal(log.global_loss, base.global_loss)
        np.testing.assert_array_equal(log.wall_time_s, base.wall_time_s)
    sampled = run_port(case, case["ota"], clients_per_round=3)
    assert not np.array_equal(sampled.global_loss, base.global_loss)
