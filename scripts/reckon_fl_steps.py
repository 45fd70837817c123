#!/usr/bin/env python3
"""Peak device memory of the FL train steps ``chip_smoke.py`` phase 11 runs
(8 x 128 tokens over 4 clients, ``launch/steps.py``'s step with its
kernels), reckoned on the meta device for an H100 (no card, no weights):

    PYTHONPATH=src python3 scripts/reckon_fl_steps.py [--archs llama3.2-1b gemma3-4b qwen3-8b]
    PYTHONPATH=src python3 scripts/reckon_fl_steps.py --archs qwen3-8b --ranks 4

One JSON line a (arch, aggregator): the reckoned peak and argument bytes,
the kernel calls, and whether the peak fits the card
(``dryrun.card_capacity``). qwen3-8b's step is the one phase 11 leaves out
(it stopped out of memory on the card). With ``--ranks W`` the step is one
rank's of the mesh step, one client a rank (``launch.mesh.abstract_mesh``,
client 0), and the line adds the collective: the bytes the rank sends in
its all-reduces (a ring: 2(W-1)/W of the f32 leaves) and their time on
NVLink. ``--moe-impl ep`` makes a MoE model's step expert-parallel: the
rank holds its block of the expert leaves, and the line adds the
all-to-alls of the MoE blocks ((W-1)/W of each exchanged buffer):

    PYTHONPATH=src python3 scripts/reckon_fl_steps.py --ranks 4 \
        --arch qwen3-moe-30b-a3b --moe-impl ep
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch import analysis, dryrun  # noqa: E402
from repro_torch.launch.mesh import abstract_mesh  # noqa: E402
from repro_torch.launch.shapes import InputShape  # noqa: E402

FL_STEP = InputShape("fl_8x128", 128, 8, "train")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--archs", nargs="+",
                    default=["llama3.2-1b", "gemma3-4b", "qwen3-8b"])
    ap.add_argument("--aggregators", nargs="+",
                    default=["ideal", "ota", "digital"])
    ap.add_argument("--ranks", type=int, default=None,
                    help="reckon one rank of the mesh step over this many "
                         "ranks, one client a rank")
    ap.add_argument("--moe-impl", default="auto", choices=("auto", "ep"),
                    help="ep: the expert-parallel MoE (needs --ranks)")
    args = ap.parse_args(argv)
    if args.moe_impl == "ep" and args.ranks is None:
        ap.error("--moe-impl ep runs over ranks: give --ranks")
    mesh = None if args.ranks is None else abstract_mesh(args.ranks)
    capacity, source = dryrun.card_capacity()
    for arch in args.archs:
        for agg in args.aggregators:
            t0 = time.time()
            bundle, _ = dryrun.build_bundle(
                arch, FL_STEP, aggregator=agg, mesh=mesh,
                flags={"moe_impl": args.moe_impl})
            out, counter, live = analysis.reckon(bundle.fn,
                                                 bundle.arguments)
            print(json.dumps({
                "arch": arch, "aggregator": agg, "batch": FL_STEP.global_batch,
                "seq": FL_STEP.seq_len,
                "n_clients": args.ranks or dryrun.N_CLIENTS,
                "ranks": args.ranks or 1, "moe_impl": args.moe_impl,
                "collectives": analysis.collective_stats(counter),
                "collective_s": analysis.time_terms(counter)["collective_s"],
                "peak_bytes": live.peak,
                "memory": live.memory_summary(out),
                "kernel_calls": dict(counter.kernel_calls),
                "fits_one_card": live.peak <= capacity,
                "capacity_bytes": capacity, "capacity_source": source,
                "reckon_s": time.time() - t0}), flush=True)


if __name__ == "__main__":
    main()
