"""The port's FL-LM training (``repro_torch.launch``, ``optim``,
``checkpoint`` and the design solver) on the CPU against the JAX
reference, on a small llama-style model in f32 (2 layers, d_model 64,
4 heads, 2 KV heads, d_ff 96, vocab 128; 8 x 16 tokens a step).

Three steps of the train step under each aggregator, from the same
weights and token batches, against ``repro.launch.steps.make_train_step``:
one client in this process, four clients (the reference's mesh data axis
of 4 JAX CPU devices) in a subprocess. Tolerances:
  * losses within rtol 1e-5; parameters within 1e-5 of the largest
    magnitude (gradients differ in the last ulps: XLA fuses and contracts,
    torch rounds op by op);
  * digital, as the ROADMAP's parity contract: the payloads are held bit
    for bit on fed gradients by ``tests/test_torch_collectives.py``; on
    the trajectory an ulp-level gradient gap can flip a code at the dither
    floor, so at most 0.1% of the entries may exceed 1e-5 (none did so
    far), and none 1e-2, of the largest magnitude;
  * ``design_ota_direct``: the reference evaluates its objective in f32,
    the port in f64: objective within rtol 1e-6 and gamma within 1e-3 at
    N = 4 and 8; at N = 1 the f32 run stops early, and the port's
    objective must be no higher (it was 0.1% and 3% lower on the two
    deployments checked);
  * SGD and the checkpoints: bit-equal.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from _torch_reference import one_thread, ref  # noqa: F401  (fixtures)
from repro_torch import interop
from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.core import bounds, channel, ota_design, rngstream
from repro_torch.launch import train as train_mod
from repro_torch.launch.steps import fl_round_arrays, make_train_step
from repro_torch.models import make_model
from repro_torch.models.common import ModelConfig
from repro_torch.optim import SGDConfig, sgd_init, sgd_update

pytestmark = pytest.mark.usefixtures("one_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AGGS = ("ideal", "ota", "digital")
CFG = dict(name="fl-small", arch_type="dense", n_layers=2, d_model=64,
           n_heads=4, n_kv_heads=2, d_ff=96, vocab_size=128, head_dim=16)
STEPS, BATCH, SEQ, ETA = 3, 8, 16, 0.5

# The reference's train step: 3 steps under each aggregator from the
# weights of key 0, each run's final parameters saved with the
# reference's own save_checkpoint, and the losses.
REF_SRC = textwrap.dedent('''
    import numpy as np
    import jax
    import jax.numpy as jnp
    from repro.checkpoint import save_checkpoint
    from repro.launch.mesh import make_host_mesh
    from repro.launch.steps import fl_round_arrays, make_train_step
    from repro.models import make_model
    from repro.models.common import ModelConfig
    from repro.optim.sgd import SGDConfig


    def run_all(inp, out_dir, cfg_kw, aggs, steps, batch, seq, eta):
        model = make_model(ModelConfig(**cfg_kw, dtype=jnp.float32))
        params0 = model.init(jax.random.key(0))
        save_checkpoint(out_dir, 0, params0)
        mesh = make_host_mesh(model_axis=1, data_axis=len(jax.devices()))
        losses = {}
        for agg in aggs:
            sb = make_train_step(model, mesh, aggregator=agg,
                                 sgd=SGDConfig(eta=eta), batch=batch,
                                 seq=seq)
            f = jax.jit(sb.fn, in_shardings=sb.in_shardings,
                        out_shardings=sb.out_shardings)
            params, out = params0, []
            for t in range(steps):
                fl = fl_round_arrays(mesh, gammas=inp["gammas"],
                                     chis=inp["chis"][t], alpha=2.0,
                                     noise_scale=1e-3, levels=15.0)
                params, loss = f(params, {"tokens": jnp.asarray(
                    inp["tokens"][t])}, fl, jax.random.key(t))
                out.append(float(loss))
            save_checkpoint(f"{out_dir}/{agg}", steps, params)
            losses[agg] = out
        return losses


    if __name__ == "__main__":
        import json, sys
        kw = json.loads(sys.argv[3])
        inp = dict(np.load(sys.argv[1]))
        print(json.dumps(run_all(inp, sys.argv[2], **kw)))
''')


def _inputs(n):
    rng = np.random.default_rng([n, 1])
    chis = np.ones((STEPS, n))
    chis[1, -1] = 0.0                 # a client out of a round (weight 0)
    return {"tokens": rng.integers(0, CFG["vocab_size"], (STEPS, BATCH, SEQ)
                                   ).astype(np.int32),
            "gammas": np.linspace(0.5, 1.5, n), "chis": chis}


def _port_model(directory):
    model = make_model(ModelConfig(**CFG, dtype=torch.float32), seed=None,
                       device="cpu")
    return restore_checkpoint(directory, latest_step(directory), model)


def _port_run(inp, directory, agg, n):
    """Three port steps from the reference's initial weights."""
    model = _port_model(directory)
    step = make_train_step(model, n_clients=n, aggregator=agg,
                           sgd=SGDConfig(eta=ETA), batch=BATCH, seq=SEQ)
    losses = []
    for t in range(STEPS):
        fl = fl_round_arrays(n, gammas=inp["gammas"], chis=inp["chis"][t],
                             alpha=2.0, noise_scale=1e-3, levels=15.0)
        loss = step({"tokens": torch.from_numpy(inp["tokens"][t]).long()},
                    fl, rngstream.prng_key(t))
        assert loss.dtype == torch.float32 and loss.dim() == 0
        losses.append(float(loss))
    return model, losses


def _check_run(inp, directory, agg, n, want_losses):
    model, losses = _port_run(inp, directory, agg, n)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    want = _port_model(os.path.join(directory, agg))
    gaps, scale = [], 0.0
    for (k, a), b in zip(model.state_dict().items(),
                         want.state_dict().values()):
        gaps.append((a - b).abs().reshape(-1))
        scale = max(scale, float(b.abs().max()))
    gaps = torch.cat(gaps)
    over = float((gaps > 1e-5 * scale).float().mean())
    assert float(gaps.max()) <= (1e-2 if agg == "digital" else 1e-5) * scale
    assert over <= (1e-3 if agg == "digital" else 0.0)
    print(f"{agg}, {n} client(s): losses {losses}; parameter gap "
          f"{float(gaps.max()) / scale:.3g} of the largest magnitude, "
          f"{over:.2g} of entries above 1e-5")


@pytest.fixture(scope="module")
def ref1(ref, tmp_path_factory):
    """The reference's 3-step runs over one client, in this process."""
    d = tmp_path_factory.mktemp("ref1")
    ns = {}
    exec(REF_SRC, ns)
    inp = _inputs(1)
    losses = ns["run_all"](inp, str(d), CFG, AGGS, STEPS, BATCH, SEQ, ETA)
    return inp, str(d), losses


@pytest.fixture(scope="module")
def ref4(tmp_path_factory):
    """The same over four clients on 4 JAX CPU devices (a subprocess: the
    device count is fixed when JAX starts)."""
    import json
    d = tmp_path_factory.mktemp("ref4")
    inp = _inputs(4)
    np.savez(d / "in.npz", **inp)
    (d / "ref4.py").write_text(REF_SRC)
    kw = dict(cfg_kw=CFG, aggs=AGGS, steps=STEPS, batch=BATCH, seq=SEQ,
              eta=ETA)
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    out = subprocess.run([sys.executable, str(d / "ref4.py"),
                          str(d / "in.npz"), str(d), json.dumps(kw)],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return inp, str(d), json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("agg", AGGS)
def test_train_step_one_client_matches_reference(ref1, agg):
    inp, d, losses = ref1
    _check_run(inp, d, agg, 1, losses[agg])


@pytest.mark.parametrize("agg", AGGS)
def test_train_step_four_clients_matches_reference(ref4, agg):
    inp, d, losses = ref4
    _check_run(inp, d, agg, 4, losses[agg])


def test_train_step_checks_and_counts(ref1):
    """The batch must split over the clients and have the step's shape;
    the loss falls over a few more steps; no gradient is left behind."""
    inp, d, _ = ref1
    model = _port_model(d)
    with pytest.raises(ValueError):
        make_train_step(model, n_clients=3, batch=BATCH, seq=SEQ)
    step = make_train_step(model, n_clients=2, aggregator="ota",
                           sgd=SGDConfig(eta=ETA), batch=BATCH, seq=SEQ)
    fl = fl_round_arrays(2, alpha=1.0, noise_scale=1e-4)
    tokens = torch.from_numpy(inp["tokens"][0]).long()
    with pytest.raises(ValueError):
        step({"tokens": tokens[:, :8]}, fl, rngstream.prng_key(0))
    losses = [float(step({"tokens": tokens}, fl, rngstream.prng_key(t)))
              for t in range(6)]
    assert losses[-1] < losses[0]
    assert all(p.grad is None for p in model.parameters())


def _ref_two_steps(ref, inp, agg, momentum):
    """Two reference train steps over one client from the weights of key
    0, at the given SGD momentum: (losses, final parameters as numpy)."""
    jax, jnp = ref.jax, ref.jax.numpy
    rmodel = ref.api.make_model(ref.common.ModelConfig(**CFG,
                                                       dtype=jnp.float32))
    params = rmodel.init(jax.random.key(0))
    mesh = ref.mesh.make_host_mesh(model_axis=1, data_axis=1)
    sb = ref.steps.make_train_step(
        rmodel, mesh, aggregator=agg,
        sgd=ref.sgd.SGDConfig(eta=ETA, momentum=momentum), batch=BATCH,
        seq=SEQ)
    f = jax.jit(sb.fn, in_shardings=sb.in_shardings,
                out_shardings=sb.out_shardings)
    losses = []
    for t in range(2):
        fl = ref.steps.fl_round_arrays(mesh, gammas=inp["gammas"],
                                       chis=inp["chis"][t], alpha=2.0,
                                       noise_scale=1e-3, levels=15.0)
        params, loss = f(params, {"tokens": jnp.asarray(inp["tokens"][t])},
                         fl, jax.random.key(t))
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, params)


def _port_two_steps(inp, directory, agg, momentum):
    model = _port_model(directory)
    step = make_train_step(model, n_clients=1, aggregator=agg,
                           sgd=SGDConfig(eta=ETA, momentum=momentum),
                           batch=BATCH, seq=SEQ)
    losses = []
    for t in range(2):
        fl = fl_round_arrays(1, gammas=inp["gammas"], chis=inp["chis"][t],
                             alpha=2.0, noise_scale=1e-3, levels=15.0)
        losses.append(float(step(
            {"tokens": torch.from_numpy(inp["tokens"][t]).long()}, fl,
            rngstream.prng_key(t))))
    return losses, model.state_dict()


def _params_close(got: dict, want: dict):
    scale = max(float(v.abs().max()) for v in want.values())
    gap = max(float((got[k] - want[k]).abs().max()) for k in want)
    assert gap <= 1e-5 * scale, (gap, scale)


@pytest.mark.parametrize("agg", ["ideal", "ota"])
def test_momentum_is_inert_in_both_packages(ref, ref1, agg):
    """ROADMAP Queue 3: each package's train step starts SGD from zero
    momentum every step, so two steps at momentum 0.9 train as at 0 in
    both (the port's bit for bit), and the two packages agree at 0.9
    within this file's train-step tolerance."""
    inp, d, _ = ref1
    r_losses9, r_params9 = _ref_two_steps(ref, inp, agg, 0.9)
    r_losses0, r_params0 = _ref_two_steps(ref, inp, agg, 0.0)
    np.testing.assert_allclose(r_losses9, r_losses0, rtol=1e-5)
    want9 = interop.model_state(r_params9)
    _params_close(interop.model_state(r_params0), want9)
    losses9, state9 = _port_two_steps(inp, d, agg, 0.9)
    losses0, state0 = _port_two_steps(inp, d, agg, 0.0)
    assert losses9 == losses0
    assert all(torch.equal(state9[k], state0[k]) for k in state0)
    np.testing.assert_allclose(losses9, r_losses9, rtol=1e-5)
    _params_close(state9, want9)


# ------------------------------------------------------ host-side pieces

def test_fl_round_arrays_match_reference(ref):
    mesh = ref.mesh.make_host_mesh(model_axis=1, data_axis=1)
    kw = dict(gammas=np.array([0.7]), chis=np.array([1.0]),
              nus=np.array([3.0]), alpha=1.7, noise_scale=0.01, levels=63.0)
    want = ref.steps.fl_round_arrays(mesh, **kw)
    got = fl_round_arrays(1, **kw)
    for k in ("weight", "alpha", "noise_scale", "levels"):
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(),
                                      np.asarray(want[k]).reshape(-1)
                                      if got[k].dim() else np.asarray(want[k]))
    ones = fl_round_arrays(3)
    assert torch.equal(ones["weight"], torch.ones(3))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("kw", [dict(eta=0.1),
                                dict(eta=0.3, momentum=0.9,
                                     weight_decay=0.01)])
def test_sgd_update_bit_equal(ref, dt, kw):
    """(p.f32 - eta u.f32).to(p.dtype), with the reference's coefficient
    rounding in bf16 (eager JAX, no fusion)."""
    jnp = ref.jax.numpy
    jdt, tdt = ((jnp.float32, torch.float32) if dt == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    rng = np.random.default_rng(3)
    p, g, m = ([rng.standard_normal((9, 13)).astype(np.float32)
                for _ in range(2)] for _ in range(3))
    new_p, new_m = ref.sgd.sgd_update(
        ref.sgd.SGDConfig(**kw), *([jnp.asarray(a, jdt) for a in x]
                                   for x in (p, g, m)))
    tp, tg, tm = ([torch.from_numpy(a).to(tdt) for a in x]
                  for x in (p, g, m))
    got_m = sgd_update(SGDConfig(**kw), tp, tg, tm)
    for a, b in zip(new_p, tp):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      b.float().numpy())
    if kw.get("momentum"):
        for a, b in zip(new_m, got_m):
            np.testing.assert_array_equal(np.asarray(a, np.float32),
                                          b.float().numpy())
    assert all(torch.equal(z, torch.zeros_like(a))
               for z, a in zip(sgd_init(tp), tp))


def _specs(ref, n, seed):
    dep = ref.channel.make_deployment(ref.channel.WirelessConfig(
        n_devices=n, seed=seed))
    w = ref.bounds.ObjectiveWeights.non_convex(eta=1.0, smooth_l=10.0,
                                               kappa_nc=5.0, n=n)
    kw = dict(lambdas=dep.lambdas, dim=100_000, g_max=10.0,
              e_s=dep.cfg.energy_per_symbol, n0=dep.cfg.noise_power)
    return (ref.ota_design.OTADesignSpec(weights=w, **kw),
            ota_design.OTADesignSpec(weights=bounds.ObjectiveWeights(
                w.omega_var, w.omega_bias), **kw), dep)


@pytest.mark.parametrize("n,seed", [(4, 1), (4, 3), (8, 1)])
def test_design_ota_direct_matches_reference(ref, n, seed):
    rspec, spec, dep = _specs(ref, n, seed)
    rp, rf = ref.ota_design.design_ota_direct(rspec)
    pp, pf = ota_design.design_ota_direct(spec)
    np.testing.assert_allclose(pf, rf, rtol=1e-6)
    np.testing.assert_allclose(pp.gammas, rp.gammas, rtol=1e-3)
    np.testing.assert_allclose(pp.alpha, rp.alpha, rtol=1e-3)
    np.testing.assert_allclose(pp.participation_levels(dep.lambdas),
                               rp.participation_levels(dep.lambdas),
                               rtol=1e-3)
    print(f"N = {n}: objective {pf} against {rf}, gamma within "
          f"{np.max(np.abs(pp.gammas / rp.gammas - 1)):.3g}")


@pytest.mark.parametrize("seed", [1, 3])
def test_design_ota_direct_one_client_no_worse(ref, seed):
    rspec, spec, _ = _specs(ref, 1, seed)
    rp, _ = ref.ota_design.design_ota_direct(rspec)
    pp, pf = ota_design.design_ota_direct(spec)
    theirs = ref.ota_design.true_objective_from_gamma(rspec, rp.gammas)
    assert pf <= theirs * (1 + 1e-12)
    print(f"N = 1, deployment seed {seed}: objective {pf} against the "
          f"reference's {theirs} ({pf / theirs - 1:.3g})")


def test_objective_and_participation_match_reference(ref):
    rspec, spec, dep = _specs(ref, 6, 2)
    gmax = spec.gamma_max()
    for gam in (gmax, 0.3 * gmax, 50.0 * gmax, np.full(6, 1e-3)):
        assert (ota_design.true_objective_from_gamma(spec, gam)
                == ref.ota_design.true_objective_from_gamma(rspec, gam))
    rp = ref.ota_design.params_from_gamma(rspec, 0.7 * gmax)
    pp = ota_design.params_from_gamma(spec, 0.7 * gmax)
    np.testing.assert_array_equal(pp.alpha_m(dep.lambdas),
                                  rp.alpha_m(dep.lambdas))
    np.testing.assert_array_equal(pp.participation_levels(dep.lambdas),
                                  rp.participation_levels(dep.lambdas))


# ------------------------------------------------------------ checkpoints

def test_checkpoints_cross_packages(ref, tmp_path):
    """The reference's checkpoint loads into the port, the port's into the
    reference (same keys, shapes and values), and a bf16 model round-trips
    through the reference's |V2 layout."""
    jax = ref.jax
    rmodel = ref.api.make_model(ref.common.ModelConfig(
        **CFG, dtype=jax.numpy.float32))
    params = rmodel.init(jax.random.key(4))
    ref.ckpt.save_checkpoint(tmp_path / "a", 7, params)
    model = _port_model(tmp_path / "a")
    want = interop.model_state(jax.tree.map(np.asarray, params))
    assert all(torch.equal(model.state_dict()[k], v) for k, v in want.items())
    path = save_checkpoint(tmp_path / "b", 9, model,
                           extra={"opt": {"step": torch.tensor(9)}})
    assert path.name == "ckpt_00000009.npz" and latest_step(tmp_path / "b") == 9
    back = ref.ckpt.restore_checkpoint(tmp_path / "b", 9, params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert int(np.load(path)["__extra__/opt/step"]) == 9
    # bf16: the reference writes raw 2-byte voids; the port reads and
    # writes the same
    rb = ref.api.make_model(ref.common.ModelConfig(**CFG))
    pb = rb.init(jax.random.key(5))
    ref.ckpt.save_checkpoint(tmp_path / "c", 1, pb)
    mb = make_model(ModelConfig(**CFG), seed=None, device="cpu")
    restore_checkpoint(tmp_path / "c", 1, mb)
    assert all(torch.equal(mb.state_dict()[k], v) for k, v in
               interop.model_state(jax.tree.map(np.asarray, pb)).items())
    save_checkpoint(tmp_path / "d", 1, mb)
    a, b = np.load(tmp_path / "c/ckpt_00000001.npz"), np.load(
        tmp_path / "d/ckpt_00000001.npz")
    assert sorted(a) == sorted(b)
    assert all(a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
               for k in a)
    with pytest.raises(ValueError):
        restore_checkpoint(tmp_path / "a", 7, make_model(
            ModelConfig(**{**CFG, "d_ff": 32}, dtype=torch.float32),
            device="cpu"))
    with pytest.raises(FileNotFoundError):
        latest_step(tmp_path / "e")


# ---------------------------------------------------------------- launcher

def test_launcher_pieces_match_reference(ref):
    """The token stream, the configs and the design the launcher uses."""
    import argparse
    from repro.launch import train as rtrain
    for seed in (0, 3):
        want = rtrain.synthetic_token_batch(np.random.default_rng(seed),
                                            1000, 4, 33)["tokens"]
        got = train_mod.synthetic_token_batch(np.random.default_rng(seed),
                                              1000, 4, 33)["tokens"]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ap = argparse.Namespace(arch="tinyllama-1.1b", reduced=False)
    assert train_mod.build_cfg(ap).n_layers == 22
    ap.reduced = True
    assert train_mod.build_cfg(ap).d_model == 128
    dep, params = train_mod.design(4, eta=1.0, g_max=10.0)
    rdep = ref.channel.make_deployment(ref.channel.WirelessConfig(
        n_devices=4, seed=1))
    np.testing.assert_array_equal(dep.lambdas, rdep.lambdas)
    np.testing.assert_array_equal(
        channel.FadingProcess(dep, seed=7).gains(3),
        ref.channel.FadingProcess(rdep, seed=7).gains(3))
    assert params.gammas.shape == (4,)


def test_launcher_cli_on_cpu(capsys, tmp_path):
    train_mod.main(["--device", "cpu", "--arch", "tinyllama-1.1b",
                    "--aggregator", "digital", "--steps", "3",
                    "--n-clients", "2", "--seq", "16", "--ckpt-dir",
                    str(tmp_path), "--ckpt-every", "3"])
    out = capsys.readouterr().out
    assert "params=459,392" in out and "done." in out
    assert latest_step(tmp_path) == 3
    log = train_mod.train(
        make_model(ModelConfig(**CFG, dtype=torch.float32), device="cpu"),
        steps=2, seq=SEQ, n_clients=4, log=lambda s: None)
    assert len(log.losses) == 2 and all(np.isfinite(log.losses))
    assert log.launches[0]["ota_combine"] == 0       # CPU: plain versions
