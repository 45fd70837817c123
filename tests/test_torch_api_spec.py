"""The port's scenario layer as pure data (``repro_torch.api`` spec,
results, schemes, scenarios, plan) and the host pieces it needs
(``core.faults``, ``core.async_fl``, the Lemma 1/2 variances), against
the reference (``repro.api``) through the ``ref`` fixture:

  * ``spec_hash`` of every registered scenario, quick and full, equals
    the reference's, so results compare across the packages by hash;
  * ``to_dict``/``from_dict`` round-trips, ``override``,
    ``expand_schemes``, ``design_families`` as the reference's;
  * ``plan().describe()`` character for character and ``schedule()``;
  * ``FaultSpec`` validation, ``survival_prob``, ``effective_lambdas``
    and the async tables bit-equal;
  * ``lemma1_variance`` / ``lemma2_variance`` within 1e-12 relative;
  * the strict encoder raises on an unknown type.
"""
import dataclasses
import json

import numpy as np
import pytest

from _torch_reference import ref  # noqa: F401  (module-scoped fixture)
from repro_torch.api import (SCHEMA_VERSION, ScenarioSpec, SweepSpec, plan,
                             scenarios, schemes, spec_from_dict)
from repro_torch.api.results import dump_json
from repro_torch.core import async_fl, faults
from repro_torch.core.channel import (WirelessConfig, make_deployment,
                                      participation_probability)

NAMES = scenarios.names()


def _ref_spec(ref, spec):
    """The reference's spec of the same content (through its dict)."""
    return ref.spec.spec_from_dict(json.loads(json.dumps(spec.to_dict())))


@pytest.mark.parametrize("quick", [True, False], ids=["quick", "full"])
@pytest.mark.parametrize("name", NAMES)
def test_spec_hash_matches_reference(ref, name, quick):
    mine = scenarios.get(name, quick=quick)
    theirs = ref.scenarios.get(name, quick=quick)
    assert mine.spec_hash() == theirs.spec_hash()
    assert mine.to_dict() == theirs.to_dict()
    assert type(mine).__name__ == type(theirs).__name__


def test_registry_matches_reference(ref):
    assert NAMES == ref.scenarios.names()
    assert SCHEMA_VERSION == ref.results.SCHEMA_VERSION == 7
    for name in NAMES:
        doc = scenarios.REGISTRY[name].__doc__.strip().splitlines()[0]
        assert doc == ref.scenarios.REGISTRY[name].__doc__.strip(
        ).splitlines()[0]


@pytest.mark.parametrize("name", NAMES)
def test_round_trip(name):
    spec = scenarios.get(name)
    text = json.dumps(spec.to_dict())
    back = spec_from_dict(json.loads(text))
    assert back == spec
    assert back.spec_hash() == spec.spec_hash()


def test_round_trip_of_a_scenario_with_every_block():
    spec = scenarios.sweep_async().base.replace(
        fault=faults.FaultSpec(dropout_prob=0.2, deadline_s=0.5,
                               on_missing="zero"))
    back = ScenarioSpec.from_dict(json.loads(json.dumps(spec.to_dict())))
    assert back == spec
    # pre-v5/v7 dicts (no fault / async_ block) default both off
    d = spec.to_dict()
    del d["fault"], d["async_"]
    old = ScenarioSpec.from_dict(d)
    assert old.fault == faults.FaultSpec()
    assert old.async_ == async_fl.AsyncSpec()


def test_override_matches_reference(ref):
    spec = scenarios.fig2_ota_sc()
    for path, value in (("run.rounds", 12), ("wireless.tx_power_dbm", 3.0),
                        ("run.etas", [1.0]), ("design.kappa", 2.5),
                        ("fault.dropout_prob", 0.1),
                        ("async_.buffer_rounds", 2),
                        ("schemes", ["proposed_ota"])):
        mine = spec.override(path, value)
        theirs = _ref_spec(ref, spec).override(path, value)
        assert mine.spec_hash() == theirs.spec_hash(), path
    assert isinstance(spec.override("run.etas", [1.0]).run.etas, tuple)
    with pytest.raises(KeyError, match="unknown spec field"):
        spec.override("run.nope", 1)
    with pytest.raises(ValueError, match="run.mode"):
        spec.override("run.mode", "later")


def test_numpy_axes_hash_as_python_values(ref):
    base = scenarios.sweep_smoke().base
    mine = SweepSpec(name="np", base=base,
                     axes={"wireless.tx_power_dbm": np.linspace(-3, 3, 3)})
    theirs = ref.spec.SweepSpec(
        name="np", base=_ref_spec(ref, base),
        axes={"wireless.tx_power_dbm": np.linspace(-3, 3, 3)})
    assert mine.spec_hash() == theirs.spec_hash()
    assert [c.cell_hash for c in plan(mine).cells] == \
        [c.cell_hash for c in ref.plan.plan(theirs).cells]


def test_schemes_match_reference(ref):
    assert schemes.scheme_keys() == ref.schemes.scheme_keys()
    assert schemes.SUITES == ref.schemes.SUITES
    assert schemes.DESIGN_NEEDS == ref.schemes.DESIGN_NEEDS
    for entry in (("suite:fig2_ota",), ("suite:fig2_digital", "ideal"),
                  ("suite:fig3_ota", "proposed_digital_direct"),
                  ("proposed_ota", "vanilla_ota")):
        assert schemes.expand_schemes(entry) == \
            ref.schemes.expand_schemes(entry)
        assert schemes.design_families(entry) == \
            ref.schemes.design_families(entry)
    for bad in (("suite:nope",), ("nope",)):
        with pytest.raises(KeyError):
            schemes.expand_schemes(bad)


@pytest.mark.parametrize("quick", [True, False], ids=["quick", "full"])
@pytest.mark.parametrize("name", NAMES)
def test_describe_and_schedule_match_reference(ref, name, quick):
    mine = plan(scenarios.get(name, quick=quick))
    theirs = ref.plan.plan(ref.scenarios.get(name, quick=quick))
    assert mine.describe() == theirs.describe()

    def flat(entries):
        return [(kind, item.index) if kind == "cell" else
                (kind, item.family, item.n_devices, item.solver,
                 item.cell_indices, item.needs_direct, item.batched)
                for kind, item in entries]

    assert flat(mine.schedule()) == flat(theirs.schedule())


def test_the_four_later_scenarios_still_plan():
    """The four scenarios that came after the first sweeps plan and hash
    here (execute runs the fault, participation and async sweeps,
    tests/test_torch_api_sweeps.py, and refuses fig2_batch's mini-batches,
    tests/test_torch_api_execute.py)."""
    for name in ("sweep_fault", "sweep_participation", "sweep_async",
                 "fig2_batch"):
        assert plan(scenarios.get(name)).cells


# ----------------------------------------------------- faults and async

def test_fault_spec_validation_matches_reference(ref):
    assert [f.name for f in dataclasses.fields(faults.FaultSpec)] == \
        [f.name for f in dataclasses.fields(ref.faults.FaultSpec)]
    assert faults.FaultSpec() == faults.FaultSpec(**dataclasses.asdict(
        ref.faults.FaultSpec()))
    for bad in (dict(dropout_prob=1.5), dict(erasure_prob=-0.1),
                dict(straggler_prob=2.0), dict(deep_fade_thresh=-1.0),
                dict(straggler_mult=0.5), dict(deadline_s=0.0),
                dict(on_missing="drop")):
        with pytest.raises(ValueError):
            ref.faults.FaultSpec(**bad)
        with pytest.raises(ValueError):
            faults.FaultSpec(**bad)
    assert not faults.FaultSpec(straggler_mult=3.0).enabled
    assert faults.FaultSpec(deadline_s=1.0).enabled


FAULTS = [dict(), dict(dropout_prob=0.2), dict(deep_fade_thresh=1e-6),
          dict(deep_fade_thresh=4.5e-7, erasure_prob=0.1,
               on_missing="zero"),
          dict(straggler_prob=0.3, deadline_s=0.1),
          dict(deep_fade_thresh=1.0)]


@pytest.mark.parametrize("kw", FAULTS)
def test_fault_statistics_bit_equal(ref, kw):
    lam = make_deployment(WirelessConfig(n_devices=12, seed=1,
                                         pl_exponent=2.6)).lambdas
    mine, theirs = faults.FaultSpec(**kw), ref.faults.FaultSpec(**kw)
    np.testing.assert_array_equal(faults.survival_prob(mine, lam),
                                  ref.faults.survival_prob(theirs, lam))
    np.testing.assert_array_equal(faults.effective_lambdas(lam, mine),
                                  ref.faults.effective_lambdas(lam, theirs))
    thr = np.linspace(0.0, 2e-6, 12)
    np.testing.assert_array_equal(
        participation_probability(thr, lam),
        ref.channel.participation_probability(thr, lam))


ASYNC = [dict(), dict(buffer_rounds=4, arrival_rate=0.55,
                      rate_heterogeneity=3.0, staleness_discount=0.8),
         dict(buffer_rounds=1, arrival_rate=1.0),
         dict(buffer_rounds=8, arrival_rate=0.01, rate_heterogeneity=0.5,
              staleness_discount=0.6, on_missing="stale",
              weighting="designed")]


@pytest.mark.parametrize("n", [1, 8, 50])
@pytest.mark.parametrize("kw", ASYNC)
def test_async_tables_bit_equal(ref, kw, n):
    mine, theirs = async_fl.AsyncSpec(**kw), ref.async_fl.AsyncSpec(**kw)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    r = async_fl.arrival_rates(mine, n)
    np.testing.assert_array_equal(r, ref.async_fl.arrival_rates(theirs, n))
    for fn in ("staleness_cdf", "staleness_pmf"):
        np.testing.assert_array_equal(
            getattr(async_fl, fn)(r, mine.buffer_rounds),
            getattr(ref.async_fl, fn)(r, theirs.buffer_rounds))
    for fn in ("delivery_weight", "expected_staleness"):
        np.testing.assert_array_equal(getattr(async_fl, fn)(mine, n),
                                      getattr(ref.async_fl, fn)(theirs, n))


def test_async_spec_validation_matches_reference(ref):
    assert async_fl.MODES == ref.async_fl.MODES
    for bad in (dict(buffer_rounds=0), dict(arrival_rate=0.0),
                dict(rate_heterogeneity=-1.0), dict(staleness_discount=1.5),
                dict(on_missing="reweight"), dict(weighting="best")):
        with pytest.raises(ValueError):
            ref.async_fl.AsyncSpec(**bad)
        with pytest.raises(ValueError):
            async_fl.AsyncSpec(**bad)


# ------------------------------------------------ Lemma 1 / 2 variances

@pytest.mark.parametrize("sigma", [None, "random"])
def test_lemma_variances_match_reference(ref, sigma):
    from repro_torch.core import digital_design, ota_design
    from repro_torch.core.bounds import ObjectiveWeights
    from repro_torch.core.digital import lemma2_variance
    from repro_torch.core.ota import lemma1_variance
    dep = make_deployment(WirelessConfig(n_devices=10, seed=1))
    cfg = dep.cfg
    rng = np.random.default_rng(4)
    s2 = None if sigma is None else rng.uniform(0.0, 3.0, 10)
    w = ObjectiveWeights.strongly_convex(eta=0.5, mu=0.01, kappa_sc=3.0,
                                         n=10)
    ospec = ota_design.OTADesignSpec(
        lambdas=dep.lambdas, dim=7850, g_max=20.0, e_s=cfg.energy_per_symbol,
        n0=cfg.noise_power, weights=w)
    dspec = digital_design.DigitalDesignSpec(
        lambdas=dep.lambdas, dim=7850, g_max=20.0, e_s=cfg.energy_per_symbol,
        n0=cfg.noise_power, bandwidth_hz=cfg.bandwidth_hz, t_max_s=0.2,
        weights=w)
    gam = ota_design.anchor_min_noise(ospec) * rng.uniform(0.2, 1.0, 10)
    gam[3] = 0.0                      # a silent device: alpha_m = 0
    op = ota_design.params_from_gamma(ospec, gam)
    dp = digital_design.finalize(dspec, *digital_design.anchor_uniform(dspec))
    ref_op = ref.ota.OTAParams(**dataclasses.asdict(op))
    ref_dp = ref.digital.DigitalParams(**dataclasses.asdict(dp))
    for mine, theirs in ((lemma1_variance(op, dep.lambdas, s2),
                          ref.ota.lemma1_variance(ref_op, dep.lambdas, s2)),
                         (lemma2_variance(dp, dep.lambdas, s2),
                          ref.digital.lemma2_variance(ref_dp, dep.lambdas,
                                                      s2))):
        assert mine.keys() == theirs.keys()
        for k in mine:
            assert np.isfinite(mine[k])
            np.testing.assert_allclose(mine[k], theirs[k], rtol=1e-12,
                                       atol=0, err_msg=k)


# --------------------------------------------------------- strict encoder

def test_strict_encoder_handles_numpy_and_raises_on_unknown():
    payload = {"i": np.int64(3), "f": np.float32(1.5), "b": np.bool_(True),
               "a": np.arange(3), "nested": {"x": np.float64(2.0)}}
    out = json.loads(dump_json(payload))
    assert out == {"i": 3, "f": 1.5, "b": True, "a": [0, 1, 2],
                   "nested": {"x": 2.0}}
    assert isinstance(out["b"], bool)

    class Opaque:
        def __float__(self):
            return 0.0

    import torch
    for bad in (Opaque(), WirelessConfig(), torch.tensor(1.0)):
        with pytest.raises(TypeError):
            dump_json({"bad": bad})
