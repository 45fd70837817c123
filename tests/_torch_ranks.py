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


#: the two-rank sum's cases: dtype, and whether the tensor summed is a
#: transposed (not contiguous) view
SUM_CASES = {"float32": ("float32", False), "bfloat16": ("bfloat16", False),
             "float64": ("float64", False),
             "float32_transposed": ("float32", True)}


def sum_job():
    """Each case of ``SUM_CASES`` summed over two ranks three ways:
    ``core.dist.all_reduce_sum`` (which takes the send/receive sum on two
    gloo ranks), ``core.dist._add_peer`` itself, and gloo's own
    ``all_reduce`` on a contiguous copy."""
    import torch.distributed as tdist
    from repro_torch.core import dist
    rank = tdist.get_rank()
    out = {}
    for i, (name, (dt, transposed)) in enumerate(SUM_CASES.items()):
        rng = np.random.default_rng([rank, i])
        x = rng.standard_normal((37, 53)) * 10.0 ** rng.integers(
            -30, 30, (37, 53))
        x[0, :4] = [0.0, -0.0, -0.0, 0.0] if rank else [-0.0, -0.0, 0.0, 0.0]
        x = torch.from_numpy(x).to(getattr(torch, dt))
        if transposed:
            x = x.t()
        gloo = x.contiguous().clone()
        tdist.all_reduce(gloo)
        out[name] = {"all_reduce_sum": dist.all_reduce_sum(x.clone()),
                     "add_peer": dist._add_peer(x.clone(), None),
                     "gloo": gloo}
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


# ------------------------------------------------------- expert parallel

EP_ARCH = "qwen3-moe-30b-a3b"
#: the reference's EP runs, tagged as ``_torch_ep_ref.py`` saves them:
#: (tag, aggregator, moe_a2a_quant)
EP_TRAIN = tuple((agg + ("_quant" if quant else ""), agg, quant)
                 for quant in (False, True)
                 for agg in ("ideal", "ota", "digital"))


def unflatten(flat, prefix):
    """{"<prefix>a/b/c": v} -> {"a": {"b": {"c": v}}} for the keys under
    ``prefix``."""
    tree = {}
    for key, v in flat.items():
        if key.startswith(prefix):
            *head, last = key[len(prefix):].split("/")
            node = tree
            for h in head:
                node = node.setdefault(h, {})
            node[last] = v
    return tree


def ep_model(ref_path, mesh=None):
    """The port's scaled-down qwen3-moe (f32) with the reference's weights
    (``p/...`` of ``ref_path``): on a ``mesh``, this rank's blocks only."""
    from repro_torch import interop
    from repro_torch.configs import get_config
    from repro_torch.launch.sharding import Placement
    from repro_torch.models import make_model
    ref = np.load(ref_path)
    params = unflatten({k: ref[k] for k in ref.files if k.startswith("p/")},
                       "p/")
    model = make_model(get_config(EP_ARCH).scaled_down(), seed=None,
                       device="cpu",
                       placement=None if mesh is None else Placement(mesh))
    model.load_state_dict(interop.model_state(params, model))
    return model


def _leaves(model, of=lambda p: p):
    from repro_torch import interop
    return {leaf.key: leaf.value(of).detach().clone()
            for leaf in interop.reference_leaves(model)}


def ep_job(inp_path, ref_path):
    """This rank's side of ``_torch_ep_ref.py`` on a 2-rank mesh: the EP
    block, the int8 exchange's codes and output on the fed buffer, prefill
    and fed decode steps, the summed gradients and the train steps."""
    from repro_torch.core import dist, rngstream
    from repro_torch.launch.mesh import client_index, make_host_mesh
    from repro_torch.launch.steps import (fl_round_arrays, make_decode_step,
                                          make_prefill_step, make_train_step,
                                          sharded_leaves)
    from repro_torch.models import api, layers as L
    from repro_torch.optim import SGDConfig
    mesh = make_host_mesh(device_type="cpu")
    n, c = mesh.shape["data"], client_index(mesh)
    group = dist.axis_group(mesh, "data")
    inp = dict(np.load(inp_path))
    model = ep_model(ref_path, mesh)
    cfg = model.cfg
    ep = {"moe_impl": "ep"}
    out = {"client": c, "skip": sharded_leaves(model, mesh, ep)}

    def rows(a):
        b = a.shape[0] // n
        return torch.from_numpy(np.ascontiguousarray(a[c * b:(c + 1) * b]))

    with torch.no_grad():
        for tag, quant in (("ep", False), ("ep_quant", True)):
            out[f"moe/{tag}"] = L.moe_apply(
                cfg, model.layers[0].moe, rows(inp["x"]),
                flags={**ep, "mesh": mesh, "moe_a2a_quant": quant})
        u = rows(inp["u"])
        out["a2a/codes"] = L._a2a_codes(u)
        out["a2a/out"] = L._a2a_quantized(u, group, n)

        B, S = inp["prompt"].shape
        steps = inp["feed"].shape[1]
        cache_len = S + steps + 1
        pre = make_prefill_step(model, batch=B, seq=S, cache_len=cache_len,
                                flags=ep, mesh=mesh)
        logits, caches, memory = pre(
            {"tokens": torch.from_numpy(inp["prompt"]).long()})
        dec = make_decode_step(model, batch=B, cache_len=cache_len,
                               flags=ep, mesh=mesh)
        kept, feed = [], rows(inp["feed"]).long()
        for i in range(steps):
            lg, caches = dec(feed[:, i:i + 1],
                             torch.full((B // n,), S + i, dtype=torch.int64),
                             caches, memory)
            kept.append(lg)
        out["serve"] = (logits, torch.stack(kept))

    loss, _ = api.loss_fn(model, {"tokens": rows(inp["tokens"][0]).long()},
                          {**ep, "mesh": mesh, "_in_manual": True})
    (loss * float(inp["gammas"][c])).backward()
    grads = _leaves(model, lambda p: p.grad)
    for skip, key in zip(out["skip"], grads):
        if not skip:
            dist.all_reduce_sum(grads[key], group)
    out["grad"] = grads

    Bt, St = inp["tokens"].shape[1:]
    for tag, agg, quant in EP_TRAIN:
        model = ep_model(ref_path, mesh)
        step = make_train_step(model, mesh=mesh, aggregator=agg,
                               sgd=SGDConfig(eta=float(inp["eta"])),
                               batch=Bt, seq=St,
                               flags={**ep, "moe_a2a_quant": quant})
        losses = []
        for t in range(inp["tokens"].shape[0]):
            fl = fl_round_arrays(mesh, gammas=inp["gammas"], alpha=2.0,
                                 noise_scale=1e-3, levels=15.0)
            losses.append(float(step(
                {"tokens": torch.from_numpy(inp["tokens"][t]).long()}, fl,
                rngstream.prng_key(t))))
        out[f"train/{tag}"] = (losses, _leaves(model))
    return out
