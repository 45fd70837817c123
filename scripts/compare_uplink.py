#!/usr/bin/env python3
"""The digital uplink's two kernels from several source trees, timed in
turns on one card.

    python3 scripts/compare_uplink.py [--parent DIR] [--variants a,b,...]

DIR holds another tree of this repo, for example an earlier commit
unpacked with ``git archive <commit> | tar -x -C DIR`` into a directory
that ``.gitignore`` lists. Each variant is this tree's sources with the
textual edits that ``VARIANTS`` names (another block size, prefetch depth
or conversion), written under ``build/repro_torch_kernels/compare/``. The
script compiles ``dithered_quant.cu`` and ``payload.cu`` of every tree
with the flags of ``repro_torch.kernels.build`` (one nvcc process each, all
started together) and loads each library with ctypes. For each case it
runs ``dithered_quantize_rows`` (kernel 2) or ``packed_weighted_sum``
(kernel 7) of every tree on the same inputs (``chip_smoke.quant_inputs``
and ``chip_smoke.payload_inputs``), checks each bit-equal to this tree's
plain version (``kernels/ref.py``, floats compared as integers), then
times them in turns, the trees in order and then in reverse, with
``chip_smoke.device_ms``. It prints one JSON line a case with the two
readings of each tree and their means, then the card's name and power
limit as nvidia-smi gives them. Needs a card; exits non-zero without one.
"""
import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCES = ("dithered_quant", "payload")
_P, _I = ctypes.c_void_p, ctypes.c_int64
SIGNATURES = {
    **{f"dithered_quantize_rows_{t}": [_P] * 4 + [_I] * 2 + [_P]
       for t in ("f64", "f32")},
    **{f"packed_weighted_sum_{t}": [ctypes.c_int] + [_P] * 3 + [_I] * 4 + [_P]
       for t in ("f64", "f32")}}
# (rows, d, dtype, offset) of kernel 2; (rows, d, dtype, code_bits, trials,
# silent) of kernel 7: the main paths' shapes and chip_smoke's large ones
QUANT_CASES = ((40, 7850, "float64", 0), (40, 7850, "float32", 0),
               (64, 1 << 20, "float64", 0), (64, 1 << 20, "float32", 0),
               (40, 7851, "float64", 1))
WSUM_CASES = ((40, 147994, "float64", 8, 4, "one"),
              (40, 147994, "float32", 8, 4, "one"),
              (40, 147994, "float64", 4, 4, "one"),
              (40, 147994, "float64", 16, 4, "one"),
              (40, 147994, "float64", 8, 4, "best_channel"),
              (256, 1000000, "float32", 8, 1, "one"))


WSUM_T = "constexpr int WSUM_THREADS = 64;"
DEPTH = "constexpr int DEPTH = 4;"
ROWS = "constexpr int ROW_THREADS = 128;"
CONV = "sizeof(T) == 4 || (q * K + k) % 2 ? T(code)"
VEC = "aligned ? launch_rows<T, I, 2>("
# name: [(source, text, replacement)], each text found exactly once
VARIANTS = {
    "threads32": [("payload", WSUM_T, WSUM_T.replace("64", "32"))],
    "threads128": [("payload", WSUM_T, WSUM_T.replace("64", "128"))],
    "depth2": [("payload", DEPTH, DEPTH.replace("4", "2"))],
    "depth8": [("payload", DEPTH, DEPTH.replace("4", "8"))],
    "words4": [("payload", "constexpr int WV = 2;", "constexpr int WV = 4;")],
    "words4_bits": [("payload", "constexpr int WV = 2;", "constexpr int WV = 4;"),
                    ("payload", CONV, "sizeof(T) == 4 ? T(code)")],
    "words4_i2f": [("payload", "constexpr int WV = 2;", "constexpr int WV = 4;"),
                   ("payload", CONV, "true ? T(code)")],
    # f64 codes all from their bits, or all by I2F.F64; f32 codes from
    # their bits (2^23 + q less 2^23)
    "bits": [("payload", CONV, "sizeof(T) == 4 ? T(code)")],
    "i2f": [("payload", CONV, "true ? T(code)")],
    "f32_bits": [("payload", CONV,
                  "sizeof(T) == 4 ? T(__fsub_rn(__uint_as_float(0x4B000000u "
                  "| code), 8388608.0f)) : (q * K + k) % 2 ? T(code)")],
    # kernel 2 in 4-entry vectors (16-byte loads of u), or entry by entry
    "vec4": [("dithered_quant", VEC, VEC.replace("2>(", "4>(")),
             ("dithered_quant", "(2 * sizeof(T) - 1)", "15"),
             ("dithered_quant", "(2 * sizeof(float) - 1)", "15")],
    "vec1": [("dithered_quant", VEC, VEC.replace("2>(", "1>("))],
    "rows64": [("dithered_quant", ROWS, ROWS.replace("128", "64"))],
    "rows256": [("dithered_quant", ROWS, ROWS.replace("128", "256"))],
}
CSRC = Path("src/repro_torch/kernels/csrc")


def variant_tree(name: str, out_dir: Path) -> Path:
    """This tree's two sources with ``VARIANTS[name]``'s edits, as a tree
    under ``out_dir``."""
    root = out_dir / f"tree-{name}"
    (root / CSRC).mkdir(parents=True, exist_ok=True)
    for src in SOURCES:
        text = (ROOT / CSRC / f"{src}.cu").read_text()
        for target, old, new in VARIANTS[name]:
            if target == src:
                if text.count(old) != 1:
                    raise ValueError(f"variant {name}: {old!r} is not found "
                                     f"exactly once in {src}.cu")
                text = text.replace(old, new)
        (root / CSRC / f"{src}.cu").write_text(text)
    return root


def build_trees(trees: dict) -> dict:
    """{tag: ctypes library by source} for each tree {tag: root}."""
    from repro_torch.kernels import build
    out_dir = build.BUILD_DIR / "compare"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = build._nvcc()
    procs = []
    for tag, root in trees.items():
        for name in SOURCES:
            src = Path(root) / CSRC / f"{name}.cu"
            so = out_dir / f"lib{name}-{tag}.so"
            procs.append((tag, name, so, subprocess.Popen(
                [nvcc, *build.NVCC_FLAGS, "-o", str(so), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for tag, name, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {tag}'s {name}.cu:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn, args in SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = args
                getattr(lib, fn).restype = ctypes.c_int
        libs.setdefault(tag, {})[name] = lib
    return libs


def launcher(libs, case):
    """(the plain result, {tag: a call of that tree's kernel into out}) for
    one case."""
    import torch
    import chip_smoke as S
    from repro_torch.kernels import ref
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    if len(case) == 4:
        rows, d, dt, offset = case
        g, u, scal = S.quant_inputs(rows, d, getattr(torch, dt), rows, offset)
        plain = ref.dithered_quantize_rows_ref(g, u, scal[:, 0], scal[:, 1])
        fn = f"dithered_quantize_rows_{'f64' if dt == 'float64' else 'f32'}"
        out = torch.empty_like(g)

        def call(lib):
            return lambda: getattr(lib["dithered_quant"], fn)(
                g.data_ptr(), u.data_ptr(), scal.data_ptr(), out.data_ptr(),
                rows, d, stream())
        return plain, out, {tag: call(lib) for tag, lib in libs.items()}
    rows, d, dt, cb, trials, silent = case
    tdt = getattr(torch, dt)
    g, u, scal, w = S.payload_inputs(rows, d, tdt, cb, d + cb, trials, silent)
    n = rows // trials
    words = ref.quantize_pack_rows_ref(g, u, scal, cb).reshape(
        trials, n, -1, ref.LANES)
    scal3 = torch.cat([scal.reshape(trials, n, 2), w[..., None]],
                      -1).contiguous()
    plain = ref.packed_weighted_sum_ref(words, scal3, cb, d)
    fn = f"packed_weighted_sum_{'f64' if dt == 'float64' else 'f32'}"
    out = torch.empty(trials, d, dtype=tdt, device="cuda")

    def call(lib):
        return lambda: getattr(lib["payload"], fn)(
            cb, words.data_ptr(), scal3.data_ptr(), out.data_ptr(), trials, n,
            d, words[0, 0].numel(), stream())
    return plain, out, {tag: call(lib) for tag, lib in libs.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="root of another source tree")
    ap.add_argument("--variants", default="",
                    help=f"comma-separated, of {sorted(VARIANTS)}")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("compare_uplink: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as S
    from repro_torch.kernels import build
    trees = {"parent": args.parent} if args.parent else {}
    trees["this"] = ROOT
    for name in filter(None, args.variants.split(",")):
        trees[name] = variant_tree(name, build.BUILD_DIR / "compare")
    libs = build_trees(trees)
    order = list(trees) + list(trees)[::-1]
    for case in QUANT_CASES + WSUM_CASES:
        plain, out, calls = launcher(libs, case)
        for tag, call in calls.items():
            out.fill_(float("nan"))
            S.check(call() == 0, f"{tag} launch failed at {case}")
            torch.cuda.synchronize()
            S.check(S.same_bits(out, plain), f"{tag} != plain at {case}")
        big = plain.numel() * plain.element_size() > 64e6 or case[0] >= 256
        ms = {tag: [] for tag in trees}
        for tag in order:
            ms[tag].append(S.device_ms(calls[tag], 4 if big else 50))
        kernel = ("dithered_quantize_rows" if len(case) == 4
                  else "packed_weighted_sum")
        print(json.dumps(dict(kernel=kernel, case=list(case), ms=ms,
                              mean_ms={k: sum(v) / len(v)
                                       for k, v in ms.items()},
                              bit_equal=True)), flush=True)
    print(S.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
