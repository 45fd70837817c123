"""The port's Fig. 2 trainer against the reference's, end to end.

The ``tests/test_system.py`` end-to-end recipe shrunk to d = 650 (8x8
images, 6 devices): parameters from the reference's closed-form anchors,
carried across with ``repro_torch.interop``; the port's ``FLTrainer.run``
on the CPU against the reference's ``FLTrainer.run(backend="jax")``.
Tolerances: OTA schemes' global loss within 1e-5 relative at every eval
point and accuracy within 1/n_test — torch and XLA f32 gradients differ
in the last ulps (the reference's engine-vs-oracle slack); the digital
scheme's loss within 1e-3 and accuracy within 2/n_test, since those ulps
occasionally flip a dither code.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_reference import one_thread, ref  # noqa: F401  (fixtures)
import repro_torch
from repro_torch import interop
from repro_torch.core.async_fl import AsyncSpec
from repro_torch.fl import FLTrainer, SoftmaxRegressionTask

pytestmark = pytest.mark.usefixtures("one_thread")

N = 6
RUN = dict(rounds=20, trials=2, eval_every=10, seed=5)


@pytest.fixture(scope="module")
def setup(ref):
    spec = ref.synthetic.SyntheticSpec(image_shape=(8, 8, 1),
                                       n_train_per_class=200,
                                       n_test_per_class=50, noise_sigma=1.5)
    x_tr, y_tr, x_te, y_te = ref.synthetic.make_classification_dataset(spec)
    shards = ref.partition.partition_by_class(x_tr, y_tr, N, 1, 200, seed=3)
    ds = ref.loader.FLDataset.from_shards(shards, x_te, y_te)
    task = ref.tasks.SoftmaxRegressionTask(n_features=64, mu=0.01,
                                           g_max=20.0)
    dep = ref.channel.make_deployment(ref.channel.WirelessConfig(n_devices=N,
                                                                 seed=1))
    cfg = dep.cfg
    eta = 0.5 / (task.mu + task.smooth_l)
    w = ref.bounds.ObjectiveWeights.strongly_convex(eta=eta, mu=task.mu,
                                                    kappa_sc=3.0, n=N)
    ospec = ref.ota_design.OTADesignSpec(
        lambdas=dep.lambdas, dim=task.dim, g_max=task.g_max,
        e_s=cfg.energy_per_symbol, n0=cfg.noise_power, weights=w)
    dspec = ref.digital_design.DigitalDesignSpec(
        lambdas=dep.lambdas, dim=task.dim, g_max=task.g_max,
        e_s=cfg.energy_per_symbol, n0=cfg.noise_power,
        bandwidth_hz=cfg.bandwidth_hz, t_max_s=0.2, weights=w)
    schemes = {
        "ideal": ref.baselines.IdealFedAvg(),
        "ota": ref.baselines.ProposedOTA(ref.ota_design.params_from_gamma(
            ospec, ref.ota_design.anchor_min_noise(ospec))),
        "vanilla": ref.baselines.VanillaOTA(task.dim, task.g_max,
                                            cfg.energy_per_symbol,
                                            cfg.noise_power),
        "digital": ref.baselines.ProposedDigital(ref.digital_design.finalize(
            dspec, *ref.digital_design.anchor_uniform(dspec))),
    }
    port_task = SoftmaxRegressionTask(n_features=64, mu=0.01, g_max=20.0)
    return dict(
        schemes=schemes, task=task, ds=ds, dep=dep, eta=eta,
        ref_trainer=ref.trainer.FLTrainer(task, ds, dep, eta=eta),
        port_task=port_task,
        port_trainer=FLTrainer(port_task, interop.dataset(ds),
                               interop.deployment(dep), eta, device="cpu"))


def _compare(log_p, log_r, n_test, loss_rel, acc_steps):
    assert log_p.scheme == log_r.scheme
    np.testing.assert_array_equal(log_p.rounds, log_r.rounds)
    np.testing.assert_array_equal(log_p.wall_time_s, log_r.wall_time_s)
    assert log_p.global_loss.shape == log_r.global_loss.shape
    np.testing.assert_allclose(log_p.global_loss, log_r.global_loss,
                               rtol=loss_rel, atol=0)
    assert np.max(np.abs(log_p.accuracy - log_r.accuracy)) \
        <= acc_steps / n_test + 1e-6


@pytest.mark.parametrize("name,loss_rel,acc_steps", [
    ("ideal", 1e-5, 1), ("ota", 1e-5, 1), ("vanilla", 1e-5, 1),
    ("digital", 1e-3, 2)])
def test_trajectory_matches_reference(setup, name, loss_rel, acc_steps):
    agg = setup["schemes"][name]
    log_r = setup["ref_trainer"].run(agg, backend="jax", **RUN)
    log_p = setup["port_trainer"].run(interop.scheme(agg), **RUN)
    n_test = len(setup["ds"].y_test)
    _compare(log_p, log_r, n_test, loss_rel, acc_steps)
    # the noiseless schemes learn (at d = 650 the OTA noise floor, which
    # scales as d*N0/alpha^2 against a d-sized E_s budget, dominates)
    if name in ("ideal", "digital"):
        assert log_p.global_loss[:, -1].max() < log_p.global_loss[:, 0].min()


def test_time_budget_freezes_on_the_same_round(setup):
    agg = setup["schemes"]["digital"]
    run = dict(rounds=20, trials=2, eval_every=4, seed=5,
               time_budget_s=1.0)
    log_r = setup["ref_trainer"].run(agg, backend="jax", **run)
    log_p = setup["port_trainer"].run(interop.scheme(agg), **run)
    # the budget bites mid-run: the wall-clock stops short of 20 rounds
    assert log_r.wall_time_s[-1] == log_r.wall_time_s[-2]
    assert log_r.wall_time_s[1] < log_r.wall_time_s[-1]
    _compare(log_p, log_r, len(setup["ds"].y_test), 1e-3, 2)


def test_task_and_weights_carry_across(ref, setup):
    task_r, task_p = setup["task"], setup["port_task"]
    w = np.random.default_rng(7).normal(size=task_r.dim) * 0.05
    interop.load_weights(task_p, w)
    np.testing.assert_array_equal(interop.flat_weights(task_p), w)
    ds = setup["ds"]
    xs = np.stack([d.x for d in ds.devices])
    ys = np.stack([d.y for d in ds.devices])
    g_r = task_r.device_grads(w, xs, ys)
    g_p = task_p.device_grads(torch.tensor(w, dtype=torch.float32),
                              torch.from_numpy(xs), torch.from_numpy(ys))
    np.testing.assert_allclose(g_p.double().numpy(), g_r, rtol=1e-5,
                               atol=1e-6 * np.abs(g_r).max())
    x_te = torch.from_numpy(ds.x_test)
    w32 = torch.tensor(w, dtype=torch.float32)
    assert float(task_p.loss(w32, x_te, torch.from_numpy(ds.y_test))) == \
        pytest.approx(task_r.global_loss(w, ds.x_test, ds.y_test), rel=1e-6)
    acc = task_r.accuracy(w, ds.x_test, ds.y_test)
    assert float(task_p.accuracy(w32, x_te, torch.from_numpy(ds.y_test))) \
        == pytest.approx(acc, abs=1.0 / len(ds.y_test))
    logits = task_p(x_te)
    assert logits.shape == (len(ds.y_test), 10)


def test_default_device_is_the_card(setup):
    # no card here: an entry point left at its default must refuse the CPU
    with pytest.raises(RuntimeError, match="CUDA"):
        FLTrainer(setup["port_task"], interop.dataset(setup["ds"]),
                  interop.deployment(setup["dep"]), setup["eta"])


@pytest.mark.parametrize("option,error,match", [
    (dict(batch_size=32), None, None),
    (dict(payload_dtype="f16"), ValueError, "'f32' or 'bf16'"),
    (dict(clients_per_round=7), ValueError, "n_devices=6"),
    (dict(mode="async", async_spec=AsyncSpec(weighting="designed")),
     ValueError, "explicit async_weights")])
def test_options_outside_the_slice_raise(setup, option, error, match):
    """Mini-batches run (``tests/test_torch_batch.py`` holds them to the
    reference); the bf16, sampling and async layers run
    (``tests/test_torch_faults.py`` and its siblings) and refuse what the
    reference refuses."""
    def trainer():
        return FLTrainer(setup["port_task"], interop.dataset(setup["ds"]),
                         interop.deployment(setup["dep"]), setup["eta"],
                         device="cpu", **option)

    if error is None:
        log = trainer().run(interop.scheme(setup["schemes"]["ota"]),
                            rounds=2, trials=1, eval_every=1)
        assert np.all(np.isfinite(log.global_loss))
        return
    with pytest.raises(error, match=match):
        trainer()


def test_fast_rng_raises(setup):
    """``rng="fast"`` runs (``tests/test_torch_rng_fast.py``); Ideal FedAvg
    on full batches draws nothing, so its fast run is its replay run."""
    agg = interop.scheme(setup["schemes"]["ideal"])
    run = dict(rounds=2, trials=1, eval_every=1)
    fast = setup["port_trainer"].run(agg, rng="fast", **run)
    replay = setup["port_trainer"].run(agg, **run)
    np.testing.assert_array_equal(fast.global_loss, replay.global_loss)


def test_port_imports_neither_jax_nor_reference():
    src = Path(repro_torch.__file__).resolve().parents[1]
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import repro_torch, repro_torch.fl, repro_torch.interop\n"
            "import repro_torch.kernels, repro_torch.core\n"
            "import repro_torch.optim, repro_torch.checkpoint\n"
            "import repro_torch.core.collectives, repro_torch.launch.train\n"
            "import repro_torch.data, repro_torch.api, repro_torch.api.cli\n"
            "from repro_torch.fl import SyntheticHighDimTask\n"
            "import repro_torch.launch.serve, repro_torch.launch.shapes\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(src)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
    # nor does any source line, lazily imported ones, the chip script and
    # the card's scripts included
    banned = re.compile(r"^\s*(import|from)\s+(jax|repro)\b", re.M)
    files = [*(src / "repro_torch").rglob("*.py"),
             src.parent / "chip_smoke.py",
             *(src.parent / "scripts").glob("*.py")]
    hits = [str(f) for f in files if banned.search(f.read_text())]
    assert not hits, hits
