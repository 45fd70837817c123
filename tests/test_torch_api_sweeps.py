"""The three robustness sweeps through the port's ``execute`` against the
reference's, on the CPU (``_torch_api_parity.execute_both``):

  * ``sweep_fault`` (quick: 4 cells, N = 6, the fault layer on both OTA
    schemes, dropout 0 and 0.3 x two path-loss exponents);
  * ``sweep_participation`` on 2 of its 8 quick cells: N = 12 and
    S = 4 (the base's other axes fixed), uniform against designed
    sampling, which solves the co-design per scheme; the full quick grid
    takes a minute in the two packages together, over this file's
    budget;
  * ``sweep_async`` on 2 of its 8 quick cells: rate heterogeneity 3 and
    discount 0.7, buffers of 2 and 5 rounds, designed weights.

Each cell: the same hash, design objectives within 1e-6 relative, the
same eta, wall-clocks equal and the OTA trajectories within 1e-5
relative. The command line runs ``sweep_fault``, then comes back all
cached.
"""
import numpy as np
import pytest

from _torch_api_parity import execute_both
from _torch_reference import ref  # noqa: F401  (module-scoped fixture)
from repro_torch.api import cli, scenarios
from repro_torch.api.spec import SweepSpec

OBJ_RTOL = 1e-6
OTA_RTOL = 1e-5


def _sub_grid(sweep_cls, sweep, fixed, axes):
    """``sweep``'s quick spec with the ``fixed`` axes set on its base and
    only ``axes`` swept (same name, so the cells hash as the full grid's
    cells of the same values)."""
    base = sweep.base
    for path, value in fixed.items():
        base = base.override(path, value)
    return sweep_cls(name=sweep.name, base=base, axes=axes)


SUB_GRIDS = {
    "sweep_fault": None,
    "sweep_participation": (
        {"wireless.n_devices": 12, "run.clients_per_round": 4},
        {"run.participation": ("uniform", "designed")}),
    "sweep_async": (
        {"async_.rate_heterogeneity": 3.0,
         "async_.staleness_discount": 0.7},
        {"async_.buffer_rounds": (2, 5)}),
}


def _specs(ref, name):
    mine, theirs = scenarios.get(name), ref.scenarios.get(name)
    if SUB_GRIDS[name] is not None:
        fixed, axes = SUB_GRIDS[name]
        mine = _sub_grid(SweepSpec, mine, fixed, axes)
        theirs = _sub_grid(ref.spec.SweepSpec, theirs, fixed, axes)
    return mine, theirs


@pytest.mark.parametrize("name", list(SUB_GRIDS))
def test_sweep_matches_reference(ref, name):
    spec_p, spec_r = _specs(ref, name)
    assert isinstance(spec_p, SweepSpec)
    assert spec_p.spec_hash() == spec_r.spec_hash()
    rs_p, rs_r, _, _ = execute_both(ref, spec_p, spec_r)
    assert len(rs_p) == len(rs_r) == (4 if name == "sweep_fault" else 2)
    for cp, cr in zip(rs_p, rs_r):
        assert cp.cell_hash == cr.cell_hash
        assert cp.status == cr.status == "computed"
        pp, pr = cp.payload, cr.payload
        assert pp["scenario"] == pr["scenario"]
        np.testing.assert_allclose(pp["design"]["ota"]["objective"],
                                   pr["design"]["ota"]["objective"],
                                   rtol=OBJ_RTOL)
        assert [lg["scheme_key"] for lg in pp["logs"]] == \
            [lg["scheme_key"] for lg in pr["logs"]]
        for lp, lr in zip(pp["logs"], pr["logs"]):
            assert lp["eta"] == lr["eta"]
            np.testing.assert_array_equal(lp["wall_time_s"],
                                          lr["wall_time_s"])
            for key in ("loss_mean", "acc_mean"):
                np.testing.assert_allclose(lp[key], lr[key], rtol=OTA_RTOL,
                                           atol=0, err_msg=key)
            assert np.all(np.isfinite(lp["loss_mean"]))
            print(f"{name} {cp.overrides} {lp['scheme_key']}: loss "
                  f"{lp['loss_mean'][0]:.6g} -> {lp['loss_mean'][-1]:.6g}")


def test_cli_runs_sweep_fault_then_all_cached(tmp_path, capsys):
    out = tmp_path / "rs"
    argv = ["run", "sweep_fault", "--device", "cpu", "--out", str(out)]
    assert cli.main(argv) == 0
    assert "4 computed, 0 cached" in capsys.readouterr().out
    assert cli.main(argv + ["--expect-cached"]) == 0
    assert "0 computed, 4 cached" in capsys.readouterr().out
