#!/usr/bin/env python3
"""The row statistics (kernel 4) and the train path's OTA epilogue (kernel
1 with its noise) of this tree against another tree's, timed in turns on
one card.

    python3 scripts/compare_rule2.py --parent DIR

DIR holds another tree of this repo, for example an earlier commit
unpacked with ``git archive <commit> | tar -x -C DIR`` into a directory
that ``.gitignore`` lists (``build/checkout/parent``). Its port package is
imported under a name of its own and builds its own sources into its own
``build/``. For each case every tree's route runs on the same inputs
(``chip_smoke.reduce_inputs`` and ``keyed_inputs``), and is checked bit
for bit, floats compared as integers:

  * ``row_maxabs_sumsq`` (the wrapper) against that tree's own plain
    version, since the order of the sum may differ between trees;
  * ``ops.ota_combine(g, alpha, noise_scale, key)``, the call of the train
    path's collective (a tree without the keyed entry draws its normals
    with torch and runs the row entry), against this tree's
    ``ref.ota_combine_keyed_ref``.

Then the trees are timed in turns, in order and then in reverse, kernel
4 with ``chip_smoke.device_ms`` (CUDA graphs) beside one
``torch.linalg.vector_norm`` call, kernel 1 with ``chip_smoke.event_ms``
(the torch draw copies its constants to the card, which a graph cannot
capture). One JSON line a case, then the card's name and power limit as
nvidia-smi gives them. Needs a card; exits non-zero without one.
"""
import argparse
import importlib
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (rows, d, g's dtype): the main path (Best Channel-Norm's 4 trials x 10
# devices), Fig. 3's width, the payload benchmark's case in bf16 and f32,
# and rows off a 16-byte boundary
REDUCE_CASES = ((40, 7850, "float64"), (40, 147994, "float64"),
                (256, 1000000, "bfloat16"), (256, 1000000, "float32"),
                (40, 7851, "float64"))
# tinyllama-1.1b's stacked leaves on the train path, f32: the largest (22
# layers of w_gate), the embedding, and the key projection (22 layers);
# each call takes tens of microseconds at least, above its host cost
KEYED_CASES = (((22, 2048, 5632), "float32"), ((32000, 2048), "float32"),
               ((22, 2048, 256), "float32"))


def load_tree(tag: str, root: Path):
    """The ``repro_torch`` package of the tree at ``root``, imported as
    ``repro_torch_<tag>`` (its imports are relative, so it stays whole)."""
    name = f"repro_torch_{tag}"
    pkg = Path(root) / "src" / "repro_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{name}.kernels")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="root of another source tree")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("compare_rule2: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as S
    trees = {"parent": load_tree("parent", Path(args.parent)),
             "this": importlib.import_module("repro_torch.kernels")}
    for k in trees.values():
        k.build.build(("ota_combine", "row_reduce"))
    order = list(trees) + list(trees)[::-1]

    for rows, d, dt in REDUCE_CASES:
        g, acc = S.reduce_inputs(rows, d, getattr(torch, dt), seed=d % 89)
        calls = {}
        for tag, k in trees.items():
            out = k.row_maxabs_sumsq(g, acc)
            torch.cuda.synchronize()
            S.check(S.same_bits(out, k.ref.row_maxabs_sumsq_ref(g, acc)),
                    f"{tag}'s row_maxabs_sumsq != its plain version at "
                    f"({rows}, {d}) {dt}")
            calls[tag] = (lambda k=k: k.row_maxabs_sumsq(g, acc))
        iters = 4 if g.numel() * g.element_size() > 64e6 else 50
        ms = {tag: [] for tag in trees}
        for tag in order:
            ms[tag].append(S.device_ms(calls[tag], iters))
        lib = S.device_ms(
            lambda: torch.linalg.vector_norm(g, dim=1, dtype=acc), iters)
        print(json.dumps(dict(
            kernel="row_maxabs_sumsq", case=[rows, d, dt], ms=ms,
            mean_ms={t: sum(v) / len(v) for t, v in ms.items()},
            vector_norm_ms=lib, bit_equal=True)), flush=True)
        del g
        S.free_card()

    this = trees["this"]
    for shape, dt in KEYED_CASES:
        g, inv, key = S.keyed_inputs(shape, getattr(torch, dt), seed=7)
        plain = this.ref.ota_combine_keyed_ref(g, inv, S.KEYED_NOISE_SCALE,
                                               key)
        calls = {}
        for tag, k in trees.items():
            call = (lambda k=k: k.ops.ota_combine(g, 2.5, S.KEYED_NOISE_SCALE,
                                                  key))
            S.check(S.same_bits(call(), plain),
                    f"{tag}'s ops.ota_combine != the keyed plain version at "
                    f"{list(shape)} {dt}")
            calls[tag] = call
        del plain
        big = g.numel() > (1 << 24)
        ms = {tag: [] for tag in trees}
        for tag in order:
            ms[tag].append(S.event_ms(calls[tag], 3 if big else 10))
        print(json.dumps(dict(
            kernel="ota_combine (key form)", case=[list(shape), dt], ms=ms,
            mean_ms={t: sum(v) / len(v) for t, v in ms.items()},
            bit_equal=True)), flush=True)
        del g
        S.free_card()
    print(S.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
