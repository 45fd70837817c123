#!/usr/bin/env python3
"""Where the time goes in the port's main paths on one card.

    python3 scripts/profile_port.py [--rounds 40]

Builds six cells of ``chip_smoke.py``'s main path, 4 trials each: Fig. 2
ProposedOTA (N = 50) and ProposedDigital (N = 10) at d = 7850, two of
Fig. 2's digital baselines at the same size (Best Channel-Norm, which
scores devices through the row-statistics kernel, and FedTOE, whose bit
allocation is planned on the host once a run), and Fig. 3 ProposedOTA and
ProposedDigital (N = 10, the MLP at d = 147,994, the digital one on the
fused payload route). It warms each
up, then runs ``--rounds`` rounds under ``torch.profiler`` and prints one
JSON line per cell: host wall time per round (one run's host-side
fading/noise set-up and final eval included), device time per round
(kernels run on one stream, so their sum is the busy time), the device's
idle share, kernel launches per round, and device time per round by
kernel family (gradient GEMMs, the threefry dither's int64 bitwise and
shift ops, each of the port's CUDA kernels, the copy of the host-made PS
noise to the card, the rest).

The train cell (``--cells train``) builds tinyllama-1.1b at full width
and depth (random bf16 weights) and profiles one FL train step of 8 x 128
tokens over 4 clients under each aggregator (ideal, OTA, digital), after
a warm-up step, through ``launch.steps.make_train_step`` with the
launcher's round inputs: wall and device time per step, idle share,
launches per step, device time by family and the top kernels.

The serve cells (``--cells serve``) build falcon-mamba-7b and then
recurrentgemma-2b at full width and depth (random bf16 weights) and
profile one prefill of 4 x 512 (recurrentgemma: 4 x 2,560) prompt tokens
and then 32 greedy decode steps of the 4 requests, each on its own,
through the serve steps with the scans on their CUDA kernels: wall time,
device time by family, idle share and launches per token. Needs a card;
exits non-zero without one.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

FAMILIES = (                      # first match wins, on the kernel's name
    ("selective_scan", ("selective_scan",)),
    ("linear_scan", ("linear_scan",)),
    ("dithered_quantize", ("dithered_quantize_kernel",)),
    ("ota_combine_keyed", ("ota_combine_keyed",)),
    ("ota_combine", ("ota_combine",)),
    ("dithered_quantize_rows", ("dithered_quantize",)),
    ("quantize_pack_rows", ("quantize_pack",)),
    ("packed_weighted_sum", ("packed_weighted_sum",)),
    ("unpack_dequant_rows", ("unpack_dequant",)),
    ("row_maxabs_sumsq", ("row_maxabs",)),
    ("gemm", ("gemm", "sm90_xmma", "cutlass", "gemv", "dot_kernel",
              "nvjet")),
    ("bitwise/shift (threefry)", ("bitwise", "shift")),
    ("memcpy host to card", ("memcpy htod",)),
    ("softmax", ("softmax",)),
    ("reduce", ("reduce", "norm")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def profiled(fn, kernels=None):
    """Run ``fn()`` under the profiler (the card's activity only); (device
    time by family in us, launches, busy us, host wall seconds to a
    synchronise), read from the profiler's raw events: building its
    per-op tables took tens of seconds for a digital train step's 72,000
    launches. A dict passed as ``kernels`` receives each kernel's (device
    us, launches) by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_family, launches, busy_us = {}, 0, 0.0
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        name, dev_us = evt.name(), evt.duration_ns() / 1e3
        fam = family(name)
        by_family[fam] = by_family.get(fam, 0.0) + dev_us
        if kernels is not None:
            us, n = kernels.get(name, (0.0, 0))
            kernels[name] = (us + dev_us, n + 1)
        launches += 1
        busy_us += dev_us
    if busy_us == 0:
        raise SystemExit("profiler recorded no device time")
    return by_family, launches, busy_us, wall


def profile_cell(trainer, agg, rounds, **run):
    import torch
    trainer.run(agg, rounds=2, eval_every=1, **run)          # warm-up
    torch.cuda.synchronize()
    by_family, launches, busy_us, wall = profiled(
        lambda: trainer.run(agg, rounds=rounds, eval_every=rounds, **run))
    return dict(
        wall_ms_per_round=wall * 1e3 / rounds,
        device_ms_per_round=busy_us / 1e3 / rounds,
        idle_share=1.0 - busy_us / 1e6 / wall,
        launches_per_round=launches / rounds,
        device_ms_per_round_by_family={
            k: v / 1e3 / rounds for k, v in sorted(
                by_family.items(), key=lambda kv: -kv[1])})


def profile_serve(arch, prompt_len, batch=4, tokens=32):
    """A model's prefill and decode, each profiled on its own."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import SERVE_FLAGS
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import make_batch, make_model
    cfg = get_config(arch)
    model = make_model(cfg, seed=0)
    cache_len = prompt_len + tokens + 1
    prefill = make_prefill_step(model, batch=batch, seq=prompt_len,
                                cache_len=cache_len, flags=SERVE_FLAGS)
    decode = make_decode_step(model, batch=batch, cache_len=cache_len,
                              flags=SERVE_FLAGS)
    inputs = {"tokens": make_batch(cfg, batch, prompt_len,
                                   torch.Generator().manual_seed(1))
              ["tokens"].cuda()}
    state = {}

    def run_prefill():
        state["logits"], state["caches"], _ = prefill(inputs)

    def run_decode(steps):
        for i in range(steps):
            tok = torch.argmax(state["logits"], -1)[:, None]
            pos = torch.full((batch,), prompt_len + i, device="cuda")
            state["logits"], state["caches"] = decode(tok, pos,
                                                      state["caches"])

    run_prefill()                                         # warm-up
    run_decode(2)
    cells = []
    for label, fn, n_tok in (
            (f"{arch} prefill {batch}x{prompt_len}", run_prefill,
             batch * prompt_len),
            (f"{arch} decode {batch}x{tokens}",
             lambda: run_decode(tokens), batch * tokens)):
        per_kernel = {}
        by_family, launches, busy_us, wall = profiled(fn, per_kernel)
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:6]
        cells.append(dict(
            cell=label, wall_ms=wall * 1e3, device_ms=busy_us / 1e3,
            idle_share=1.0 - busy_us / 1e6 / wall, launches=launches,
            launches_per_token=launches / n_tok,
            tokens_per_s=n_tok / wall,
            device_ms_by_family={k: v / 1e3 for k, v in sorted(
                by_family.items(), key=lambda kv: -kv[1])},
            top_kernels=[dict(name=k[:90], device_ms=us / 1e3, launches=n)
                         for k, (us, n) in top]))
    return cells


def profile_train(batch=8, seq=128, n_clients=4):
    """One tinyllama-1.1b FL train step under each aggregator."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core import rngstream
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.steps import fl_round_arrays, make_train_step
    from repro_torch.models import make_model
    from repro_torch.optim import SGDConfig
    cfg = get_config("tinyllama-1.1b")
    _, ota_p = train_mod.design(n_clients, eta=1.0, g_max=10.0)
    scale = float(np.mean(ota_p.gammas))
    fl = fl_round_arrays(n_clients, gammas=ota_p.gammas / scale,
                         alpha=ota_p.alpha / scale,
                         noise_scale=np.sqrt(ota_p.noise_psd) / ota_p.alpha
                         * 1e-2, levels=255.0)
    tokens = train_mod.synthetic_token_batch(np.random.default_rng(0),
                                             cfg.vocab_size, batch, seq)
    tokens = {"tokens": tokens["tokens"].cuda()}
    cells = []
    for agg in ("ideal", "ota", "digital"):
        model = make_model(cfg, seed=0)
        step = make_train_step(model, n_clients=n_clients, aggregator=agg,
                               sgd=SGDConfig(eta=1.0), batch=batch, seq=seq)
        step(tokens, fl, rngstream.prng_key(0))                # warm-up
        per_kernel = {}
        c0 = kernels.launch_counts()
        by_family, launches, busy_us, wall = profiled(
            lambda: step(tokens, fl, rngstream.prng_key(1)), per_kernel)
        c1 = kernels.launch_counts()
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:6]
        cells.append(dict(
            cell=f"tinyllama-1.1b train {agg} N={n_clients} "
                 f"{batch}x{seq}",
            wall_ms_per_step=wall * 1e3, device_ms_per_step=busy_us / 1e3,
            idle_share=1.0 - busy_us / 1e6 / wall,
            launches_per_step=launches,
            port_kernel_launches={k: c1[k] - c0[k] for k in c0
                                  if c1[k] - c0[k]},
            tokens_per_s=batch * seq / wall,
            device_ms_by_family={k: v / 1e3 for k, v in sorted(
                by_family.items(), key=lambda kv: -kv[1])},
            top_kernels=[dict(name=k[:90], device_ms=us / 1e3, launches=n)
                         for k, (us, n) in top]))
        del model, step
        torch.cuda.empty_cache()
    return cells


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--cells", choices=("all", "fl", "serve", "train"),
                    default="all")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("profile_port: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    print(chip_smoke.nvidia_smi_line(), flush=True)
    if args.cells in ("all", "fl"):
        profile_fl(args.rounds)
    if args.cells in ("all", "serve"):
        for arch, prompt_len in (("falcon-mamba-7b", 512),
                                 ("recurrentgemma-2b", 2560)):
            for cell in profile_serve(arch, prompt_len):
                print(json.dumps(cell), flush=True)
    if args.cells in ("all", "train"):
        for cell in profile_train():
            print(json.dumps(cell), flush=True)
    return 0


def profile_fl(rounds):
    import chip_smoke
    from repro_torch.core import baselines as B
    from repro_torch.fl import FLTrainer
    task, ds, dep, eta, ota_p, _ = chip_smoke.fig2_setup(50, 6000)
    cell = profile_cell(FLTrainer(task, ds, dep, eta), B.ProposedOTA(ota_p),
                        rounds, trials=4, seed=0)
    print(json.dumps(dict(cell="fig2_ota N=50", **cell)), flush=True)
    task, ds, dep, eta, _, dig_p = chip_smoke.fig2_setup(10, 1200)
    cfg = dep.cfg
    dconsts = (task.dim, task.g_max, cfg.energy_per_symbol, cfg.noise_power,
               cfg.bandwidth_hz)
    trainer = FLTrainer(task, ds, dep, eta)
    for label, agg in (("fig2_digital N=10", B.ProposedDigital(dig_p)),
                       ("fig2_best_channel_norm N=10 K=4",
                        B.BestChannelNorm(dep, *dconsts, k=4)),
                       ("fig2_fedtoe N=10 K=4", B.FedTOE(dep, *dconsts,
                                                          k=4))):
        cell = profile_cell(trainer, agg, rounds, trials=4, seed=0,
                            time_budget_s=150.0)
        print(json.dumps(dict(cell=label, **cell)), flush=True)
    task, ds, dep, eta, ota_p, dig_p = chip_smoke.fig3_setup()
    trainer = FLTrainer(task, ds, dep, eta)
    cell = profile_cell(trainer, B.ProposedOTA(ota_p), rounds,
                        trials=4, seed=9)
    print(json.dumps(dict(cell="fig3_ota N=10 d=147994", **cell)),
          flush=True)
    cell = profile_cell(trainer, B.ProposedDigital(dig_p), rounds,
                        trials=4, seed=9)
    print(json.dumps(dict(cell="fig3_digital N=10 d=147994 (fused)",
                          **cell)), flush=True)


if __name__ == "__main__":
    sys.exit(main())
