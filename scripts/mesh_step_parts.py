#!/usr/bin/env python3
"""Where the time of ``chip_smoke.py`` phase 13's mesh train step goes:
two ranks sharing card 0 under gloo, llama3.2-1b at full size, 8 x 128
tokens, one client a rank. On a machine with a card:

    python3 scripts/mesh_step_parts.py

Each rank times, with the card synchronized around each part: building the
mesh and the model; its client's forward and backward twice (the first
is the process's first on the card); three passes over the 12 reference
leaves' f32 gradients, each leaf copied to the pinned host buffer, summed
with one gloo ``all_reduce`` and copied back (the copies and the reduce
timed apart); one gloo ``all_reduce`` of a plain 1 GiB host tensor,
twice; the leaves again with each leaf's all-reduce cut into async
chunks of 4M and of 16M entries; then two ideal and one OTA mesh step
(``make_train_step(model, mesh=...)``). Prints the card's name and power
limit, the seconds of the whole group, and one JSON object a rank.

    python3 scripts/mesh_step_parts.py --first-forward alone|ranks|eager

times instead a fresh process's first steps on the card: the context, a
256 x 256 bf16 matmul, the model, then twice a no-grad forward, a forward
and a backward of 4 x 128 tokens; ``alone`` in this process, ``ranks`` in
two ranks at once, ``eager`` in two ranks with
``CUDA_MODULE_LOADING=EAGER``.
"""
import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def rank_fn(rank):
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import interop
    from repro_torch.configs import get_config
    from repro_torch.core import dist as core_dist
    from repro_torch.core import rngstream
    from repro_torch.launch.mesh import client_group, make_host_mesh
    from repro_torch.launch.steps import fl_round_arrays, make_train_step
    from repro_torch.launch.train import synthetic_token_batch
    from repro_torch.models import api, make_model
    from repro_torch.optim import SGDConfig
    out = {}

    def sync():
        torch.cuda.synchronize()
        return time.perf_counter()

    t0 = sync()
    mesh = make_host_mesh(device_type="cuda")
    group = client_group(mesh)
    out["mesh"] = sync() - t0
    t0 = sync()
    model = make_model(get_config("llama3.2-1b"), seed=0)
    out["model"] = sync() - t0
    batch = {k: v.cuda() for k, v in synthetic_token_batch(
        np.random.default_rng(0), model.cfg.vocab_size, 8, 128).items()}
    for i in range(2):
        t0 = sync()
        model.zero_grad(set_to_none=True)
        loss, _ = api.loss_fn(model, {k: v[rank * 4:(rank + 1) * 4]
                                      for k, v in batch.items()})
        loss.backward()
        out[f"fwdbwd{i}"] = sync() - t0
    leaves = interop.reference_leaves(model)

    def grad(p):
        return p.grad if p.grad is not None else torch.zeros_like(p)

    out["leaf_numels"] = [leaf.value(grad).numel() for leaf in leaves]
    for i in range(3):
        d2h = gl = h2d = 0.0
        t00 = sync()
        for leaf in leaves:
            g = leaf.value(grad).float()
            a = sync()
            host = core_dist._pinned(g)
            host.copy_(g)
            b = sync()
            dist.all_reduce(host, group=group)
            c = sync()
            g.copy_(host)
            d = sync()
            d2h += b - a
            gl += c - b
            h2d += d - c
            del g
        out[f"ar{i}"] = dict(d2h=d2h, gloo=gl, h2d=h2d, total=sync() - t00)
    x = torch.ones(1 << 28)
    for i in range(2):
        t0 = time.perf_counter()
        dist.all_reduce(x, group=group)
        out[f"raw1g{i}"] = time.perf_counter() - t0
    for chunk in (1 << 22, 1 << 24):
        t00 = sync()
        gl = 0.0
        for leaf in leaves:
            g = leaf.value(grad).float()
            host = core_dist._pinned(g).view(-1)
            host.copy_(g.view(-1))
            b = sync()
            works = [dist.all_reduce(host[s:s + chunk], group=group,
                                     async_op=True)
                     for s in range(0, host.numel(), chunk)]
            for w in works:
                w.wait()
            gl += time.perf_counter() - b
            g.view(-1).copy_(host)
            del g
        out[f"chunk{chunk}"] = dict(gloo=gl, total=sync() - t00)
    sgd = SGDConfig(eta=1e-2)
    kw = dict(gammas=np.array([0.8, 1.2]), alpha=1.5, noise_scale=1e-3,
              levels=255.0)
    for agg in ("ideal", "ideal", "ota"):
        step = make_train_step(model, mesh=mesh, aggregator=agg, sgd=sgd,
                               batch=8, seq=128)
        t0 = sync()
        float(step(batch, fl_round_arrays(mesh, **kw), rngstream.prng_key(0)))
        out.setdefault("steps", []).append((agg, sync() - t0))
    return out


def first_forward(rank=0):
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.train import synthetic_token_batch
    from repro_torch.models import api, make_model
    out = {"module_loading": os.environ.get("CUDA_MODULE_LOADING"),
           "arch_list": torch.cuda.get_arch_list(),
           "torch": torch.__version__, "cuda": torch.version.cuda}

    def sync():
        torch.cuda.synchronize()
        return time.perf_counter()

    t0 = time.perf_counter()
    torch.cuda.init()
    torch.zeros(1, device="cuda")
    out["ctx"] = sync() - t0
    t0 = sync()
    a = torch.randn(256, 256, device="cuda", dtype=torch.bfloat16)
    (a @ a).sum().item()
    out["matmul"] = sync() - t0
    t0 = sync()
    model = make_model(get_config("llama3.2-1b"), seed=0)
    out["model"] = sync() - t0
    batch = {k: v.cuda()[:4] for k, v in synthetic_token_batch(
        np.random.default_rng(0), model.cfg.vocab_size, 8, 128).items()}
    for i in range(2):
        t0 = sync()
        with torch.no_grad():
            api.loss_fn(model, batch)
        out[f"fwd_nograd{i}"] = sync() - t0
        t0 = sync()
        model.zero_grad(set_to_none=True)
        loss, _ = api.loss_fn(model, batch)
        out[f"fwd{i}"] = sync() - t0
        t0 = sync()
        loss.backward()
        out[f"bwd{i}"] = sync() - t0
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--first-forward", choices=("alone", "ranks", "eager"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("mesh_step_parts: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.launch import distributed
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if args.first_forward == "alone":
        print(json.dumps(first_forward()))
        return 0
    if args.first_forward == "eager":
        os.environ["CUDA_MODULE_LOADING"] = "EAGER"
    fn = rank_fn if args.first_forward is None else first_forward
    t0 = time.perf_counter()
    ranks = distributed.spawn(fn, 2, device="cuda",
                              store_dir=ROOT / "build" / "mesh")
    print("spawn_s", time.perf_counter() - t0)
    for r in ranks:
        print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
