#!/usr/bin/env python3
"""Peak device memory of the FL train steps ``chip_smoke.py`` phase 11 runs
(8 x 128 tokens over 4 clients, ``launch/steps.py``'s step with its
kernels), reckoned on the meta device for an H100 (no card, no weights):

    PYTHONPATH=src python3 scripts/reckon_fl_steps.py [--archs llama3.2-1b gemma3-4b qwen3-8b]

One JSON line a (arch, aggregator): the reckoned peak and argument bytes,
the kernel calls, and whether the peak fits the card
(``dryrun.card_capacity``). qwen3-8b's step is the one phase 11 leaves out
(it stopped out of memory on the card).
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch import analysis, dryrun  # noqa: E402
from repro_torch.launch.shapes import InputShape  # noqa: E402

FL_STEP = InputShape("fl_8x128", 128, 8, "train")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--archs", nargs="+",
                    default=["llama3.2-1b", "gemma3-4b", "qwen3-8b"])
    ap.add_argument("--aggregators", nargs="+",
                    default=["ideal", "ota", "digital"])
    args = ap.parse_args(argv)
    capacity, source = dryrun.card_capacity()
    for arch in args.archs:
        for agg in args.aggregators:
            t0 = time.time()
            bundle, _ = dryrun.build_bundle(arch, FL_STEP, aggregator=agg)
            out, counter, live = analysis.reckon(bundle.fn,
                                                 bundle.arguments)
            print(json.dumps({
                "arch": arch, "aggregator": agg, "batch": FL_STEP.global_batch,
                "seq": FL_STEP.seq_len, "n_clients": dryrun.N_CLIENTS,
                "peak_bytes": live.peak,
                "memory": live.memory_summary(out),
                "kernel_calls": dict(counter.kernel_calls),
                "fits_one_card": live.peak <= capacity,
                "capacity_bytes": capacity, "capacity_source": source,
                "reckon_s": time.time() - t0}), flush=True)


if __name__ == "__main__":
    main()
