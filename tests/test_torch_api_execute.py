"""The port's ``execute`` (``repro_torch.api``) against the reference's
on the CPU, through the ``ref`` fixture:

  * ``sweep_smoke``: the same cell hashes, design objectives within 1e-6
    relative, the same eta, OTA loss and accuracy trajectories within
    1e-5 relative, the manifest but for timings;
  * the host solver policies ("sca", "direct") routed as there;
  * kappa_nc at Fig. 3's quick sizes within 1e-6 relative;
  * a second ``execute`` touches neither solver nor trainer, and a
    corrupt cell is quarantined and recomputed;
  * ``fig2_batch``'s mini-batches and ``rng="fast"`` run through
    ``execute`` (against the reference: ``test_torch_api_batch.py``);
    another backend is refused before any design solve or file write
    (the fault, participation and async sweeps run:
    ``test_torch_api_sweeps.py``);
  * the port's results root is its own: a reference cell under the
    reference's root is never read back as the port's;
  * without a card the default device raises.

Fig. 2 at its quick sizes: ``test_torch_api_fig2.py`` (OTA) and
``test_torch_api_digital.py``.
"""
import importlib
import json
import os

import numpy as np
import pytest

from _torch_api_parity import execute_both
from _torch_reference import one_thread, ref  # noqa: F401  (fixtures)
from repro_torch.api import execute, scenarios
from repro_torch.api import materialize as mat
from repro_torch.api.results import dump_json
from repro_torch.core import baselines as B
from repro_torch.core import ota_design
from repro_torch.fl.trainer import FLTrainer

pytestmark = pytest.mark.usefixtures("one_thread")

# the module (the package attribute ``repro_torch.api.execute`` is the
# function)
ex = importlib.import_module("repro_torch.api.execute")

OBJ_RTOL = 1e-6
OTA_RTOL = 1e-5
KAPPA_RTOL = 1e-6


@pytest.fixture(scope="module")
def smoke(ref):
    return execute_both(ref, scenarios.sweep_smoke(),
                        ref.scenarios.sweep_smoke())


def test_sweep_smoke_matches_reference(smoke):
    rs_p, rs_r, runs_p, runs_r = smoke
    assert len(rs_p) == len(rs_r) == 4
    assert rs_p.manifest["sweep_hash"] == rs_r.manifest["sweep_hash"]
    for cp, cr in zip(rs_p, rs_r):
        assert cp.cell_hash == cr.cell_hash
        assert cp.overrides == cr.overrides
        assert cp.status == cr.status == "computed"
        pp, pr = cp.payload, cr.payload
        assert pp["scenario"] == pr["scenario"]
        assert pp["kappa"] == pr["kappa"] == 3.0
        np.testing.assert_allclose(pp["eta_max"], pr["eta_max"], rtol=1e-15)
        np.testing.assert_allclose(pp["design"]["ota"]["objective"],
                                   pr["design"]["ota"]["objective"],
                                   rtol=OBJ_RTOL)
        assert [lg["scheme_key"] for lg in pp["logs"]] == \
            [lg["scheme_key"] for lg in pr["logs"]]
        for lp, lr in zip(pp["logs"], pr["logs"]):
            assert lp["scheme"] == lr["scheme"]
            assert lp["eta"] == lr["eta"]
            assert lp["rounds"] == lr["rounds"]
            np.testing.assert_array_equal(lp["wall_time_s"],
                                          lr["wall_time_s"])
            for key in ("loss_mean", "acc_mean"):
                np.testing.assert_allclose(lp[key], lr[key], rtol=OTA_RTOL,
                                           atol=0, err_msg=key)
            assert np.all(np.isfinite(lp["loss_mean"]))


def test_manifest_matches_reference_but_for_timings(smoke):
    rs_p, rs_r, _, _ = smoke

    def strip(m):
        m = dict(m, cells=[dict(c, elapsed_s=None) for c in m["cells"]])
        for k in ("elapsed_s", "git_rev"):
            m.pop(k)
        return m

    assert strip(rs_p.manifest) == strip(rs_r.manifest)


@pytest.mark.parametrize("solver", ["sca", "direct"])
def test_host_solver_policies_match_reference(ref, solver):
    """``design.solver`` "sca" (the SciPy SCA oracle, 8 iterations, per
    point) and "direct" (per-point L-BFGS-B) route as in the reference.
    SCA: objectives within 1e-6, OTA trajectories within 1e-5. Direct:
    the reference minimises its objective in f32 and stops early here
    (ROADMAP Queue 3), so the port's f64 design must be at least as good,
    also against the reference's gammas evaluated in f64."""
    spec_p = scenarios.sweep_smoke().base.override("design.solver", solver)
    spec_r = ref.scenarios.sweep_smoke().base.override("design.solver",
                                                       solver)
    assert "1 per-point " + solver in ex.make_plan(spec_p).describe()
    rs_p, rs_r, _, _ = execute_both(ref, spec_p, spec_r)
    dp = rs_p.cell(0).payload["design"]["ota"]
    dr = rs_r.cell(0).payload["design"]["ota"]
    assert dp["solver"] == dr["solver"] == solver
    print(f"{solver}: objective port {dp['objective']!r} reference "
          f"{dr['objective']!r}")
    if solver == "sca":
        np.testing.assert_allclose(dp["objective"], dr["objective"],
                                   rtol=OBJ_RTOL)
        for lp, lr in zip(rs_p.cell(0).logs, rs_r.cell(0).logs):
            np.testing.assert_allclose(lp["loss_mean"], lr["loss_mean"],
                                       rtol=OTA_RTOL, atol=0)
        return
    assert dp["objective"] == dp["objective_direct"]
    assert dp["objective"] <= dr["objective"] * (1 + OBJ_RTOL)
    ctx = mat.materialize(spec_p, device="cpu")
    sp = ctx.design_spec("ota")
    pr, _ = ref.ota_design.design_ota_direct(ref.ota_design.OTADesignSpec(
        lambdas=sp.lambdas, dim=sp.dim, g_max=sp.g_max, e_s=sp.e_s,
        n0=sp.n0, weights=ref.bounds.ObjectiveWeights(
            sp.weights.omega_var, sp.weights.omega_bias)))
    at_ref = ota_design.true_objective_from_gamma(sp, pr.gammas)
    print(f"direct: the reference's gammas give {at_ref!r} in f64")
    assert dp["objective"] <= at_ref * (1 + 1e-12)
    for lp in rs_p.cell(0).logs:
        assert np.all(np.isfinite(lp["loss_mean"]))


def test_kappa_nc_matches_reference(ref):
    """kappa_nc at Fig. 3's quick sizes (MLP, d = 147,994, 3 probes)."""
    spec_p = scenarios.fig3_nonconvex(quick=True)
    spec_r = ref.scenarios.fig3_nonconvex(quick=True)
    ctx_p = mat.materialize(spec_p, device="cpu")
    task_r = ref.materialize.build_task(spec_r)
    ds_r = ref.materialize.build_dataset(spec_r)
    k_r = ref.materialize.estimate_kappa_nc(task_r, ds_r, n_probes=3)
    print(f"kappa_nc port {ctx_p.kappa!r} reference {k_r!r}")
    np.testing.assert_allclose(ctx_p.kappa, k_r, rtol=KAPPA_RTOL)
    assert ctx_p.eta_max == 0.08


# ----------------------------------------------------------- caching

def test_second_execute_touches_neither_solver_nor_trainer(tmp_path,
                                                           monkeypatch):
    spec = scenarios.sweep_smoke()
    out = tmp_path / "rs"
    rs1 = execute(spec, out_dir=out, device="cpu")
    assert [c.status for c in rs1] == ["computed"] * 4
    assert (out / "manifest.json").exists()

    def boom(*a, **k):
        raise AssertionError("a cached re-run must not solve or simulate")

    monkeypatch.setattr(ota_design, "design_ota_batch", boom)
    monkeypatch.setattr(ota_design, "design_ota_direct", boom)
    monkeypatch.setattr(mat, "resolve_kappa", boom)
    monkeypatch.setattr(FLTrainer, "run", boom)
    rs2 = execute(spec, out_dir=out, device="cpu")
    assert rs2.all_cached
    assert [c.payload for c in rs2] == \
        [json.loads(dump_json(c.payload)) for c in rs1]
    # a changed spec is a new cell: the stubbed solver shows the miss
    with pytest.raises(AssertionError, match="cached re-run"):
        execute(spec.base.override("run.seed", 99), out_dir=out,
                device="cpu")


def test_corrupt_cell_is_quarantined_and_recomputed(tmp_path):
    spec = scenarios.sweep_smoke().base
    out = tmp_path / "rs"
    rs = execute(spec, out_dir=out, device="cpu")
    path = rs.cell(0).path
    path.write_text("{truncated")
    rs2 = execute(spec, out_dir=out, device="cpu")
    assert rs2.cell(0).status == "computed"
    assert path.with_name(path.name + ".bad").exists()
    again = json.loads(path.read_text())
    assert again["cell_hash"] == rs.cell(0).cell_hash
    assert again["logs"][0]["loss_mean"] == \
        rs.cell(0).logs[0]["loss_mean"]


# ------------------------------------------ the scenarios of item 9

def _cut(spec):
    """A spec cut to 4 rounds, one step size and Proposed OTA, kappa
    fixed (no estimate)."""
    for path, value in (("run.rounds", 4), ("run.eval_every", 2),
                        ("run.etas", (0.5,)), ("design.kappa", 3.0),
                        ("schemes", ("proposed_ota",))):
        spec = spec.override(path, value)
    return spec


LATER = {"fig2_batch": lambda: scenarios.SweepSpec(
             name="fig2_batch", base=_cut(scenarios.get("fig2_batch").base),
             axes=scenarios.get("fig2_batch").axes),
         "rng_fast": lambda: _cut(scenarios.sweep_smoke().base.override(
             "run.rng", "fast"))}


@pytest.mark.parametrize("name", list(LATER))
def test_later_scenarios_raise_before_any_solve_or_write(name, tmp_path):
    """The scenarios that waited for ROADMAP Queue 1 item 9 (mini-batches,
    ``rng="fast"``) run through ``execute``: every cell computed and
    written, finite losses, the cells' run options as declared."""
    out = tmp_path / name
    spec = LATER[name]()
    rs = execute(spec, out_dir=out, device="cpu")
    assert [c.status for c in rs] == ["computed"] * len(rs)
    assert (out / "manifest.json").exists()
    for cell in rs:
        run = cell.payload["scenario"]["run"]
        assert run["rng"] == ("fast" if name == "rng_fast" else "replay")
        assert np.all(np.isfinite(cell.logs[0]["loss_mean"]))
    if name == "fig2_batch":
        assert [c.payload["scenario"]["run"]["batch_size"] for c in rs] \
            == [16, 64, None]


def test_other_backends_are_refused(tmp_path):
    spec = scenarios.sweep_smoke().base.override("run.backend", "numpy")
    with pytest.raises(ValueError, match="one engine"):
        execute(spec, out_dir=tmp_path / "rs", device="cpu")
    assert not (tmp_path / "rs").exists()


# ------------------------------------------------------- results roots

def test_port_results_root_is_its_own(ref, tmp_path, monkeypatch):
    from repro_torch.api import results
    if "REPRO_TORCH_RESULTS_DIR" not in os.environ:
        assert results.DEFAULT_RESULTS_ROOT == (
            results._REPO_ROOT / "experiments" / "results_torch")
    assert results.DEFAULT_RESULTS_ROOT != ref.results.DEFAULT_RESULTS_ROOT
    # both packages on their default roots (moved under tmp_path): a cell
    # the reference computed is never read back as the port's
    monkeypatch.setattr(ref.execute, "DEFAULT_RESULTS_ROOT",
                        tmp_path / "results")
    monkeypatch.setattr(ex, "DEFAULT_RESULTS_ROOT",
                        tmp_path / "results_torch")
    spec_r = ref.scenarios.sweep_smoke().base
    spec_p = scenarios.sweep_smoke().base
    rs_r = ref.execute.execute(spec_r)
    assert rs_r.cell(0).path.is_relative_to(tmp_path / "results")
    assert spec_r.spec_hash() == spec_p.spec_hash()
    rs_p = execute(spec_p, device="cpu")
    assert rs_p.cell(0).status == "computed"
    assert rs_p.cell(0).path.is_relative_to(tmp_path / "results_torch")
    assert ex.default_out_dir("x") == tmp_path / "results_torch" / \
        "scenarios" / "x"


# --------------------------------------------------------- the card

def test_default_device_is_the_card(monkeypatch, tmp_path):
    """Without a card, execute, materialize and tune_and_run raise on
    their default device; nothing runs on the CPU unasked."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = scenarios.sweep_smoke().base
    for call in (lambda: execute(spec, out_dir=tmp_path / "rs"),
                 lambda: mat.materialize(spec)):
        with pytest.raises(RuntimeError, match="CUDA device"):
            call()
    assert not (tmp_path / "rs").exists()
    ctx = mat.materialize(spec, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA device"):
        mat.tune_and_run(ctx.task, ctx.ds, ctx.dep, B.IdealFedAvg(),
                         eta_max=ctx.eta_max, rounds=2, trials=1,
                         eval_every=1)


# ------------------------------------------------------- the trainer

def test_trainer_takes_the_reference_signature(ref):
    """The reference's ``FLTrainer`` arguments: inert at their defaults
    (and where the reference leaves them inert), validated with the
    reference's errors, the layers, mini-batches and ``rng="fast"`` run;
    one engine; ``shard_trials`` passed through to it (without a process
    group, the one-rank mesh: the unsharded run)."""
    from repro_torch.core.async_fl import AsyncSpec
    spec = scenarios.sweep_smoke().base
    ctx = mat.materialize(spec, device="cpu")
    args = (ctx.task, ctx.ds, ctx.dep, 0.5)
    run = dict(rounds=4, trials=1, eval_every=2, seed=1)
    agg = B.VanillaOTA(ctx.task.dim, ctx.task.g_max,
                       ctx.dep.cfg.energy_per_symbol, ctx.dep.cfg.noise_power)
    base = FLTrainer(*args, device="cpu").run(agg, **run)
    inert = FLTrainer(*args, participation="designed",
                      async_spec=AsyncSpec(buffer_rounds=2),
                      device="cpu").run(agg, backend="auto", **run)
    assert (inert.global_loss == base.global_loss).all()
    mean, std = base.mean_std("global_loss")
    assert (mean == base.global_loss.mean(0)).all()
    assert (std == base.global_loss.std(0)).all()
    for kw in (dict(participation_probs=[1.0 / 6] * 6),
               dict(async_weights=[1.0] * 6), dict(mode="later"),
               dict(payload_dtype="f16")):
        with pytest.raises(ValueError):
            FLTrainer(*args, device="cpu", **kw)
    for kw in (dict(clients_per_round=3), dict(mode="async"),
               dict(clients_per_round=3, participation="designed",
                    participation_probs=[0.5] * 6)):
        log = FLTrainer(*args, device="cpu", **kw).run(agg, **run)
        assert np.all(np.isfinite(log.global_loss))
    log = FLTrainer(*args, device="cpu", batch_size=16).run(agg, **run)
    assert np.all(np.isfinite(log.global_loss))
    trainer = FLTrainer(*args, device="cpu")
    log = trainer.run(agg, rng="fast", **run)
    assert np.all(np.isfinite(log.global_loss))
    assert not np.array_equal(log.global_loss, base.global_loss)
    log = FLTrainer(*args, shard_trials=True, device="cpu").run(agg, **run)
    assert (log.global_loss == base.global_loss).all()
    for backend in ("numpy", "jax", "torch"):
        with pytest.raises(ValueError, match="one engine"):
            trainer.run(agg, backend=backend, **run)


def test_solve_w_star_matches_reference(ref):
    """w* by GD: the f64 iterate on f32 gradients, as the reference's."""
    from repro_torch.fl.trainer import solve_w_star
    spec = scenarios.sweep_smoke().base
    ctx = mat.materialize(spec, device="cpu")
    x = np.concatenate([d.x for d in ctx.ds.devices])
    y = np.concatenate([d.y for d in ctx.ds.devices])
    task_r = ref.materialize.build_task(ref.scenarios.sweep_smoke().base)
    w_r = ref.trainer.solve_w_star(task_r, x, y, iters=200)
    w_p = solve_w_star(ctx.task, x, y, iters=200, device="cpu").numpy()
    assert w_p.dtype == np.float64
    np.testing.assert_allclose(w_p, w_r, rtol=1e-5,
                               atol=1e-6 * np.abs(w_r).max())


@pytest.mark.parametrize("name", ["sweep_participation", "sweep_async"])
def test_codesign_weights_match_reference(ref, name):
    """``CellContext.participation_probs`` / ``async_weights`` (the
    co-design solvers, ``core.sca_torch``) against the reference's, on
    the last cell of each quick sweep (designed sampling; designed async
    weights), for a designed scheme and for one without a wireless design
    (uniform levels)."""
    cell_p = ex.make_plan(scenarios.get(name)).cells[-1].scenario
    cell_r = ref.plan.plan(ref.scenarios.get(name)).cells[-1].scenario
    ctx_p = mat.materialize(cell_p, device="cpu")
    ctx_r = ref.materialize.materialize(cell_r)
    ota_p = ota_design.design_ota_batch([ctx_p.design_spec("ota")],
                                        device="cpu")[0][0]
    agg_p = B.ProposedOTA(ota_p)
    agg_r = ref.baselines.ProposedOTA(ref.ota.OTAParams(
        **{k: getattr(ota_p, k) for k in ("gammas", "alpha", "g_max", "dim",
                                          "energy_per_symbol",
                                          "noise_psd")}))
    solved = 0
    for fn in ("participation_probs", "async_weights"):
        for a_p, a_r in ((agg_p, agg_r),
                         (B.IdealFedAvg(), ref.baselines.IdealFedAvg())):
            mine, theirs = getattr(ctx_p, fn)(a_p), getattr(ctx_r, fn)(a_r)
            assert (mine is None) == (theirs is None), fn
            if mine is not None:
                np.testing.assert_allclose(mine, theirs, rtol=1e-6,
                                           atol=1e-9, err_msg=fn)
                solved += 1
    assert solved == 2
