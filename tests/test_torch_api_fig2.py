"""Fig. 2 OTA through the port's ``execute`` against the reference's on
the CPU, at the quick sizes (``fig2_ota_sc(quick=True)``: N = 50 devices
of 300 samples, d = 7850), kappa estimated on the data, cut in depth
only: 20 rounds, 500 of the estimate's 1500 GD steps (the reference's
steps copy its 47 MB of data to its device each, 50 ms a step on two
cores; ``test_torch_api_digital.py`` runs all 1500 at N = 10), and the
two proposed schemes:

  * kappa_sc within 1e-6 relative of the reference's (GD on f32
    gradients; torch and XLA differ in the last bits of f32 products,
    ROADMAP Queue 3);
  * the batched design's objective within 1e-6 relative;
  * the same eta per scheme (the probe accuracies printed);
  * ProposedOTA's loss and accuracy trajectories within 1e-5 relative;
  * the direct design: the reference evaluates its objective in f32 and
    stops within that resolution, the port in f64, so the two designs
    are not the same point: objectives within 1e-6 relative, the port's
    f64 objective at or below the reference's gammas', and the
    trajectories within 1e-3 relative (on the CPU: 3.7e-4 at the
    estimate's full 1500 steps, 1.6e-6 at 500).
"""
import numpy as np
import pytest

from _torch_api_parity import check_probes, execute_both
from _torch_reference import ref  # noqa: F401  (module-scoped fixture)
from repro_torch.api import scenarios
from repro_torch.core import ota_design
from repro_torch.core.bounds import ObjectiveWeights

OBJ_RTOL = 1e-6
KAPPA_RTOL = 1e-6
OTA_RTOL = 1e-5
DIRECT_RTOL = 1e-3
SCHEMES = ("proposed_ota", "proposed_ota_direct")


@pytest.fixture(scope="module")
def fig2(ref):
    spec_p = scenarios.fig2_ota_sc(quick=True)
    spec_r = ref.scenarios.fig2_ota_sc(quick=True)
    for path, value in (("run.rounds", 20), ("design.kappa_iters", 500),
                        ("schemes", SCHEMES)):
        spec_p, spec_r = (spec_p.override(path, value),
                          spec_r.override(path, value))
    return (spec_p,) + execute_both(ref, spec_p, spec_r)


def test_kappa_objective_and_eta_match_reference(fig2):
    spec, rs_p, rs_r, runs_p, runs_r = fig2
    cp, cr = rs_p.cell(0), rs_r.cell(0)
    assert cp.cell_hash == cr.cell_hash == spec.spec_hash()
    kp, kr = cp.payload["kappa"], cr.payload["kappa"]
    print(f"kappa_sc port {kp!r} reference {kr!r}")
    np.testing.assert_allclose(kp, kr, rtol=KAPPA_RTOL)
    dp, dr = cp.payload["design"]["ota"], cr.payload["design"]["ota"]
    print(f"objective port {dp['objective']!r} reference "
          f"{dr['objective']!r}; direct port {dp['objective_direct']!r} "
          f"reference {dr['objective_direct']!r}")
    np.testing.assert_allclose(dp["objective"], dr["objective"],
                               rtol=OBJ_RTOL)
    np.testing.assert_allclose(dp["objective_direct"],
                               dr["objective_direct"], rtol=OBJ_RTOL)
    for lp, lr in zip(cp.logs, cr.logs):
        check_probes(lp, lr, runs_p, runs_r, spec.run.seed)


@pytest.mark.parametrize("key,rtol", [("proposed_ota", OTA_RTOL),
                                      ("proposed_ota_direct", DIRECT_RTOL)])
def test_trajectories_match_reference(fig2, key, rtol):
    _, rs_p, rs_r, _, _ = fig2
    lp, lr = rs_p.cell(0).log(key), rs_r.cell(0).log(key)
    assert lp["scheme"] == lr["scheme"]
    np.testing.assert_array_equal(lp["wall_time_s"], lr["wall_time_s"])
    gaps = {}
    for field in ("loss_mean", "acc_mean"):
        a, b = np.asarray(lp[field]), np.asarray(lr[field])
        gaps[field] = float(np.max(np.abs(a - b) / np.abs(b)))
        np.testing.assert_allclose(a, b, rtol=rtol, atol=0, err_msg=field)
    print(f"{key}: largest relative gaps {gaps} (limit {rtol})")
    loss = np.asarray(lp["loss_mean"])
    assert np.all(np.isfinite(loss)) and loss[-1] < loss[0]


def test_direct_design_is_at_least_as_good_in_f64(ref, fig2):
    """Both direct solvers on the reference's design point: the port's
    gammas give an f64 objective (15a) at or below the reference's."""
    spec, _, rs_r, _, _ = fig2
    ctx = ref.materialize.materialize(ref.scenarios.fig2_ota_sc(
        quick=True).override("design.kappa", rs_r.cell(0).payload["kappa"]))
    sr = ctx.design_spec("ota")
    sp = ota_design.OTADesignSpec(
        lambdas=sr.lambdas, dim=sr.dim, g_max=sr.g_max, e_s=sr.e_s,
        n0=sr.n0, weights=ObjectiveWeights(sr.weights.omega_var,
                                           sr.weights.omega_bias))
    pr, _ = ref.ota_design.design_ota_direct(sr)
    pp, f_p = ota_design.design_ota_direct(sp)
    f_at_ref = ota_design.true_objective_from_gamma(sp, pr.gammas)
    gap = float(np.max(np.abs(pp.gammas - pr.gammas) / pr.gammas))
    print(f"direct: port f64 objective {f_p!r}, at the reference's gammas "
          f"{f_at_ref!r}; gammas apart by {gap} relative")
    assert f_p <= f_at_ref * (1 + 1e-12)
