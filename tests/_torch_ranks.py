"""Rank-side halves of the port's multi-rank tests.

``repro_torch.launch.distributed.spawn`` starts the ranks (gloo on the
CPU, a ``FileStore`` under the test's temporary directory) and runs
:func:`run_jobs` in each: one group runs every rank check a test module
needs, and the module compares the results with the one-card forms (or
the reference's outputs) in its own process. This module imports the port
only, so a rank starts without JAX, and each job imports what it needs,
so a rank starts with no more than its jobs use.
"""
import numpy as np
import torch

# ---------------------------------------------------------------- inputs

#: the fed leaves of the collective's tests, in the reference's key order
LEAVES = {"embed": (96, 16), "final_norm": (16,),
          "groups.b0.mlp.w_gate": (3, 16, 40), "lm_head": (16, 96)}


def psum_inputs(n, seed=0):
    """n clients' leaves and round arrays for ``wireless_psum``: weights
    with a silent client, levels with one at 0 (no quantization), a zero
    leaf (m = 0)."""
    rng = np.random.default_rng([n, seed])
    inp = {"n": n, "alpha": np.float32(2.5), "noise_scale": np.float32(1e-2),
           "seed": 11,
           "weight": np.array([0.5, 0.0, 1.5, 1.0][:n], np.float32),
           "levels": np.array([255.0, 15.0, 0.0, 1023.0][:n], np.float32)}
    if n == 1:
        inp["weight"] = np.array([1.5], np.float32)
    for name, shape in LEAVES.items():
        g = rng.standard_normal((n,) + shape) * rng.uniform(0.1, 5.0)
        inp["g/" + name] = g.astype(np.float32)
    inp["g/final_norm"][0] = 0.0          # a zero leaf: m = 0 gives exact 0
    return inp


def psum_round(inp, weight=None):
    from repro_torch.core.collectives import WirelessRound
    return WirelessRound(
        weight=torch.from_numpy(inp["weight"] if weight is None else weight),
        alpha=torch.tensor(inp["alpha"]),
        noise_scale=torch.tensor(inp["noise_scale"]),
        levels=torch.from_numpy(inp["levels"]))


N_DEVICES = 6
#: the engine runs a rank repeats with its trials laid over the ranks
SHARD_RUN = dict(rounds=12, trials=4, eval_every=3, seed=5)


def fl_case():
    """The trainer tests' cell (8x8 images, d = 650, N = 6 devices of one
    class, Fig. 2's deployment seed) built by the port alone, with the
    designed ProposedOTA and ProposedDigital."""
    from repro_torch.core import (baselines, bounds, channel,
                                  digital_design, ota_design)
    from repro_torch.data import loader, partition, synthetic
    from repro_torch.fl import SoftmaxRegressionTask
    spec = synthetic.SyntheticSpec(image_shape=(8, 8, 1),
                                   n_train_per_class=200,
                                   n_test_per_class=50, noise_sigma=1.5)
    x_tr, y_tr, x_te, y_te = synthetic.make_classification_dataset(spec)
    shards = partition.partition_by_class(x_tr, y_tr, N_DEVICES, 1, 200,
                                          seed=3)
    ds = loader.FLDataset.from_shards(shards, x_te, y_te)
    task = SoftmaxRegressionTask(n_features=64, mu=0.01, g_max=20.0)
    dep = channel.make_deployment(channel.WirelessConfig(
        n_devices=N_DEVICES, seed=1))
    cfg = dep.cfg
    eta = 0.5 / (task.mu + task.smooth_l)
    w = bounds.ObjectiveWeights.strongly_convex(eta=eta, mu=task.mu,
                                                kappa_sc=3.0, n=N_DEVICES)
    kw = dict(lambdas=dep.lambdas, dim=task.dim, g_max=task.g_max,
              e_s=cfg.energy_per_symbol, n0=cfg.noise_power, weights=w)
    ospec = ota_design.OTADesignSpec(**kw)
    dspec = digital_design.DigitalDesignSpec(
        bandwidth_hz=cfg.bandwidth_hz, t_max_s=0.2, **kw)
    schemes = {
        "ota": baselines.ProposedOTA(ota_design.params_from_gamma(
            ospec, ota_design.anchor_min_noise(ospec))),
        "digital": baselines.ProposedDigital(digital_design.finalize(
            dspec, *digital_design.anchor_uniform(dspec)))}
    return task, ds, dep, eta, schemes


#: (scheme, rng, batch size) of the sharded runs: one OTA and one digital
#: scheme on the replayed streams, OTA on the fast ones and on
#: mini-batches of 32
SHARD_CASES = (("ota", "replay", None), ("digital", "replay", None),
               ("ota", "fast", None), ("ota", "replay", 32))


def engine_runs(shard_trials: bool, run=SHARD_RUN) -> dict:
    """{case: (global loss, accuracy, wall time)} of each case."""
    from repro_torch.fl import FLTrainer
    task, ds, dep, eta, schemes = fl_case()
    out = {}
    for scheme, rng, batch in SHARD_CASES:
        trainer = FLTrainer(task, ds, dep, eta, batch_size=batch,
                            shard_trials=shard_trials, device="cpu")
        log = trainer.run(schemes[scheme], rng=rng, **run)
        out[(scheme, rng, batch)] = (log.global_loss, log.accuracy,
                                     log.wall_time_s)
    return out


# ------------------------------------------------------------- rank jobs

def run_jobs(rank, jobs):
    """Run each ``(name, job, args)`` of ``jobs`` in order (``job`` names
    a function of this module) and return {name: result}."""
    return {name: globals()[job](*args) for name, job, args in jobs}


def psum_job(inp, multi_pod=False, data_axis=None):
    """The mesh ``wireless_psum`` of this rank's client leaves in each
    mode, and (skip_psum) its own digital payload w_c Q(g_c)."""
    from repro_torch.core import rngstream
    from repro_torch.core.collectives import wireless_psum
    from repro_torch.launch.mesh import client_index, make_host_mesh
    mesh = make_host_mesh(device_type="cpu", multi_pod=multi_pod,
                          data_axis=data_axis)
    c = client_index(mesh)
    names = sorted(LEAVES)
    leaves = [torch.from_numpy(inp["g/" + k][c]) for k in names]
    key = rngstream.prng_key(int(inp["seed"]))
    out = {"client": c, "shape": dict(mesh.shape)}
    for mode in ("ideal", "ota", "digital"):
        got = wireless_psum(leaves, psum_round(inp), key, mode=mode,
                            mesh=mesh)
        out[mode] = [g.numpy() for g in got]
    own = wireless_psum(leaves, psum_round(inp), key, mode="digital",
                        mesh=mesh, skip_psum=[True] * len(names))
    out["own"] = [g.numpy() for g in own]
    return out


def train_job(model_fn, fl_inputs, aggs, steps, batch, seq, eta):
    """Per aggregator, ``steps`` mesh train steps from the weights
    ``model_fn()`` makes (a function of this module): the losses and the
    final parameters."""
    from repro_torch.core import rngstream
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import fl_round_arrays, make_train_step
    from repro_torch.optim import SGDConfig
    mesh = make_host_mesh(device_type="cpu")
    out = {}
    for agg in aggs:
        model = globals()[model_fn[0]](*model_fn[1:])
        step = make_train_step(model, mesh=mesh, aggregator=agg,
                               sgd=SGDConfig(eta=eta), batch=batch, seq=seq)
        losses = []
        for t in range(steps):
            fl = fl_round_arrays(mesh, gammas=fl_inputs["gammas"],
                                 chis=fl_inputs["chis"][t], alpha=2.0,
                                 noise_scale=1e-3, levels=15.0)
            loss = step({"tokens": torch.from_numpy(
                fl_inputs["tokens"][t]).long()}, fl, rngstream.prng_key(t))
            losses.append(float(loss))
        out[agg] = (losses, {k: v.clone() for k, v in
                             model.state_dict().items()})
    return out


def launcher_job(cfg_kw, seed, steps, batch, seq):
    """The launcher's ``train`` with one client a rank: its losses and
    the final parameters."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import train
    mesh = make_host_mesh(device_type="cpu")
    model = seeded_model(cfg_kw, seed)
    log = train(model, mesh=mesh, steps=steps, batch=batch, seq=seq,
                log=lambda s: None)
    return log.losses, {k: v.clone() for k, v in model.state_dict().items()}


def checkpoint_model(cfg_kw, directory):
    """A port model in f32 with the reference checkpoint's weights."""
    from repro_torch.checkpoint import latest_step, restore_checkpoint
    from repro_torch.models import make_model
    from repro_torch.models.common import ModelConfig
    model = make_model(ModelConfig(**cfg_kw, dtype=torch.float32), seed=None,
                       device="cpu")
    return restore_checkpoint(directory, latest_step(directory), model)


def seeded_model(cfg_kw, seed):
    """A port model in f32 with weights from ``seed``."""
    from repro_torch.models import make_model
    from repro_torch.models.common import ModelConfig
    return make_model(ModelConfig(**cfg_kw, dtype=torch.float32), seed=seed,
                      device="cpu")


def shard_job():
    """The engine's sharded runs, and the indivisible trial count's
    error message."""
    out = {"runs": engine_runs(True)}
    try:
        engine_runs(True, {**SHARD_RUN, "trials": 3, "rounds": 3})
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


def die_job(rank):
    """Rank 1 raises at once; the others wait in a collective for it."""
    if rank == 1:
        raise RuntimeError("rank 1 stops here")
    torch.distributed.barrier()
