"""``fig2_batch`` and ``rng="fast"`` through the port's ``execute``
against the reference's, on the CPU.

``fig2_batch(quick=True)``: Fig. 2's OTA cell (N = 50 devices of 300
samples, d = 7850) over batch sizes 16, 64 and full, cut in depth only:
20 rounds, kappa fixed at 3 (the estimate is ``test_torch_api_fig2.py``'s
subject) and two schemes, each with its four step-size probes:

  * the same sweep and cell hashes (``spec_hash`` equal);
  * design objectives within 1e-6 relative, the same eta per scheme (the
    probe accuracies printed);
  * loss and accuracy trajectories within 1e-5 relative, wall-clocks
    equal;
  * ``python -m repro_torch.api.cli run`` on the cut sweep's JSON, then
    ``--expect-cached`` a cache no-op.

``sweep_smoke`` with ``run.rng="fast"`` (N = 6, d = 650): the same
hashes and OTA trajectories within 1e-5.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from _torch_api_parity import check_probes, execute_both
from _torch_reference import one_thread, ref  # noqa: F401  (fixtures)
from repro_torch.api import scenarios
from repro_torch.api.spec import SweepSpec

pytestmark = pytest.mark.usefixtures("one_thread")

OBJ_RTOL = 1e-6
OTA_RTOL = 1e-5
SCHEMES = ("proposed_ota", "vanilla_ota")
SRC = Path(__file__).resolve().parents[1] / "src"


def _cut(sweep, cls):
    base = sweep.base
    for path, value in (("run.rounds", 20), ("design.kappa", 3.0),
                        ("schemes", SCHEMES)):
        base = base.override(path, value)
    return cls(name=sweep.name, base=base, axes=dict(sweep.axes))


@pytest.fixture(scope="module")
def batch(ref):
    spec_p = _cut(scenarios.fig2_batch(quick=True), SweepSpec)
    spec_r = _cut(ref.scenarios.fig2_batch(quick=True), ref.spec.SweepSpec)
    return (spec_p, spec_r) + execute_both(ref, spec_p, spec_r)


def _compare_cells(rs_p, rs_r, runs_p, runs_r, seed):
    assert len(rs_p) == len(rs_r)
    assert rs_p.manifest["sweep_hash"] == rs_r.manifest["sweep_hash"]
    for cp, cr in zip(rs_p, rs_r):
        assert cp.cell_hash == cr.cell_hash
        assert cp.overrides == cr.overrides
        dp, dr = cp.payload["design"]["ota"], cr.payload["design"]["ota"]
        np.testing.assert_allclose(dp["objective"], dr["objective"],
                                   rtol=OBJ_RTOL)
        for lp, lr in zip(cp.logs, cr.logs):
            check_probes(lp, lr, runs_p, runs_r, seed)
            np.testing.assert_array_equal(lp["wall_time_s"],
                                          lr["wall_time_s"])
            for field in ("loss_mean", "acc_mean"):
                a, b = np.asarray(lp[field]), np.asarray(lr[field])
                print(f"{cp.overrides} {lp['scheme_key']} {field}: "
                      f"{float(np.max(np.abs(a - b) / np.abs(b)))}")
                np.testing.assert_allclose(a, b, rtol=OTA_RTOL, atol=0)


def test_fig2_batch_matches_reference(batch):
    spec_p, spec_r, rs_p, rs_r, runs_p, runs_r = batch
    assert spec_p.spec_hash() == spec_r.spec_hash()
    assert [c.overrides for c in rs_p] == [
        {"run.batch_size": b} for b in (16, 64, None)]
    _compare_cells(rs_p, rs_r, runs_p, runs_r, spec_p.base.run.seed)


def test_fig2_batch_descends(batch):
    """Proposed OTA's loss falls in every cell, mini-batch or full."""
    for cell in batch[2]:
        loss = np.asarray(cell.log("proposed_ota")["loss_mean"])
        assert np.all(np.isfinite(loss)) and loss[-1] < loss[0]


def test_fast_rng_scenario_matches_reference(ref):
    spec_p = scenarios.sweep_smoke().base.override("run.rng", "fast")
    spec_r = ref.scenarios.sweep_smoke().base.override("run.rng", "fast")
    assert spec_p.spec_hash() == spec_r.spec_hash()
    rs_p, rs_r, runs_p, runs_r = execute_both(ref, spec_p, spec_r)
    _compare_cells(rs_p, rs_r, runs_p, runs_r, spec_p.run.seed)


def _cli(*args):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + [p for p in [env.get("PYTHONPATH")] if p])
    return subprocess.run([sys.executable, "-m", "repro_torch.api.cli",
                           *args], capture_output=True, text=True, env=env,
                          timeout=600)


def test_cli_runs_fig2_batch_then_expect_cached(tmp_path):
    """The cut sweep as a JSON spec file (one scheme, 4 rounds) through
    the command line, then its re-run from the cache."""
    sweep = _cut(scenarios.fig2_batch(quick=True), SweepSpec)
    base = sweep.base.override("run.rounds", 4).override(
        "schemes", ("proposed_ota",)).override("run.etas", (0.5,))
    path = tmp_path / "fig2_batch.json"
    path.write_text(json.dumps(SweepSpec(name=sweep.name, base=base,
                                         axes=dict(sweep.axes)).to_dict()))
    out = tmp_path / "rs"
    first = _cli("run", str(path), "--device", "cpu", "--out", str(out))
    assert first.returncode == 0, first.stderr
    assert "fig2_batch: 3 computed, 0 cached" in first.stdout
    again = _cli("run", str(path), "--device", "cpu", "--out", str(out),
                 "--expect-cached")
    assert again.returncode == 0, again.stderr
    assert "fig2_batch: 0 computed, 3 cached" in again.stdout
