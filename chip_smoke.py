#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. device — the card's name and count, and nvidia-smi's name and power
   limit line;
2. build — nvcc builds the six sources of
   ``src/repro_torch/kernels/csrc`` (one process per source, all started
   together), with ptxas' register report;
3. kernels — first the launch floor (``ota_combine`` on (1, 2) f64, the
   least time one launch takes in this harness); then each of the nine
   kernels (ten entries: kernel 1's row entry and its keyed entry, which
   draws its threefry normals itself) against its plain PyTorch version
   on the card, bit-equal (the
   floats compared as integers, so -0.0 differs from +0.0), at the main
   path's shapes and at large ones, with degenerate and ragged rows (the
   two-step quantizer also with rows crossing its 2-entry vectors, d odd
   and d = 3, and on g and u views off a vector's boundary; the
   weighted sum also on Fig. 3 Best Channel's pattern of 6 of 10 devices
   out of the round, a trial of silent devices only, which must sum to
   +0.0, 300 devices a trial, and words read off an 8-byte boundary; the
   whole-tensor quantizer and the keyed epilogue also on one tensor of
   more than 2^31 entries, the keyed epilogue also either side of the
   plain draw's 2^24-counter chunks and with no noise; the row statistics
   also at the edges of their 8-block cluster's chunks, d below one
   vector a chunk, rows off a 16-byte boundary, 70,000 rows and a NaN
   entry;
   the scans also at the edges of their tiles: S = 1, a step short of a
   tile and past one or three, D = 33, and state sizes that do not divide
   among the selective scan's warps); the payload decoder
   ``unpack(pack(g))`` also bit-equal to the two-step quantizer kernel on
   the same inputs; device times of kernel, plain
   version and the one PyTorch call computing the same function (where
   there is one), beside the least time the card could take (bytes over
   3.35 TB/s or operations over the peak rate, whichever is larger); the
   SASS instructions a step in each scan's unrolled full tile, one body
   for each warp role, and the rest of its tile loop (``cuobjdump``, "not
   measured" where the toolkit has none), and of the f64 weighted sum's
   unrolled device loop; from those and the SM clock read while each
   runs, the selective scan's issue-slot floor and the f64 weighted sum's
   (issue slots and the FP64 pipe) as ranges, estimates, and the keyed
   epilogue's: threefry's 32-bit integer operations an entry over the
   integer pipe, which at the maximum clock is its bound when above the
   bytes', beside the SASS of its loop;
4. design — the batched Sec.-IV solver (``core/sca_torch.py``, float64
   torch) on the card: Fig. 2's OTA design (N = 50) and digital design
   (N = 10, T_max = 0.2 s) at B = 1, and ``benchmarks/design_bench.py``'s
   fig2-sized sweep (N = 50, a 4 x 4 (omega_var, omega_bias) grid, B = 16)
   for both families: cold and warm seconds (host clock to a
   synchronise), the kernel launches and device ms of one more solve
   under ``torch.profiler``, the objectives, which must agree with the
   same solve on the CPU within 1e-6 relative (the digital bits
   exactly); on the bench's quick grid (N = 20, 2 x 2) the card must
   match or beat the port's SciPy SCA oracle (4 iterations) within 1e-3;
5. main path — the paper's experiments at full width through the port's
   ``FLTrainer`` on the card:
     Fig. 2 (softmax regression, d = 7850), on the parameters the card
     designed in phase 4: ProposedOTA (N = 50 devices, 1000 samples each,
     4 trials, 30 rounds) and ProposedDigital (N = 10, 4 trials, 40
     rounds, 150 s budget; then 20 rounds under a 1 s budget that stops
     it mid-run);
     Fig. 2's OTA suite (OPC OTA-FL, OPC OTA-Comp, LCPC OTA-Comp, BB-FL
     Interior and Alternative; N = 50, 30 rounds) and digital suite (Best
     Channel, Best Channel-Norm, Proportional Fairness, UQOS, QML and
     FedTOE; N = 10, K = 4, 40 rounds under the figure's 150 s budget);
     Fig. 3 (MLP 3072 -> 48 -> 10, d = 147,994, N = 10 devices with two
     classes and 100 samples each, 4 trials), on the closed-form design
     anchors (min-noise gamma; uniform at a 15% participation target):
     ProposedOTA (30 rounds), ProposedDigital (40 rounds) and Best
     Channel (10 rounds, r = 6), the digital ones on the fused route
     (8-bit codes packed once a round, one packed weighted sum a round,
     no two-step quantizer).
   Each run's launch counts start at 0 and must be the expected ones;
   the loss must be finite (and fall, for the proposed schemes); the same
   run with the plain versions (``use_kernel=False``) must give the same
   trajectory to the bit; the dither stream made on the card must equal
   the CPU's to the bit; every scheme at a small size (the proposed ones
   on parameters the card designed and on the anchors), and the proposed
   ones at Fig. 3 width, must agree with the port's CPU run (which the
   tests tie to the JAX reference);
6. serve (``repro_torch.launch.serve.serve``), random weights from a
   seed, for falcon-mamba-7b (the selective scan on its CUDA kernel) and
   recurrentgemma-2b (the RG-LRU recurrence on the linear-scan kernel,
   local attention over the KV ring buffer):
     at full width cut to one pattern (falcon-mamba 2 layers,
     recurrentgemma 3: rglru, rglru, local), 4 prompts (512 tokens;
     recurrentgemma 2,560, over its 2,048-token window) and 32 decoded
     tokens with the kernel and again with its plain version fed the same
     tokens: prefill and decode logits bit-equal;
     at the ``scaled_down()`` sizes (f32) on the card against the CPU run
     (which the tests tie to the JAX reference), within the tests' 1e-4;
     at full width and full depth, 4 x 512 (falcon-mamba-7b: 64 layers,
     d_model 4096, d_inner 8192, n 16, vocab 65,024, 7,272,665,088 bf16
     parameters) or 4 x 2,560 (recurrentgemma-2b: 26 layers, 18 RG-LRU
     and 8 local, d_model 2560, 10 heads / 1 KV head of 256, d_ff 7680,
     lru_width 2560, vocab 256,000, 3,549,934,080 bf16 parameters) prompt
     tokens and 32 decoded tokens: exactly one scan launch a recurrent
     layer in the prefill (64, 18) and none in decode, finite logits;
     prefill and decode tokens/s and the peak memory;
7. FL-LM training (``repro_torch.launch.train``, the wireless collective
   ``core.collectives.wireless_psum``), tinyllama-1.1b, random weights:
     at 2 layers of the full width (bf16), the collective's kernel route
     against its plain route on the same per-client gradients, bit-equal
     in the ideal, OTA and digital modes;
     at the ``scaled_down()`` sizes (f32), 3 steps under each aggregator
     on the card against the CPU;
     at full width and depth (22 layers, d_model 2048, 32 heads / 4 KV
     heads, d_ff 5632, vocab 32,000, 1,100,048,384 bf16 parameters), 3
     steps of 8 x 128 tokens over 4 clients under the ideal, OTA and
     digital aggregators: exactly 12 ``ota_combine_keyed`` launches a step
     on OTA (none of the row entry), 48 ``dithered_quantize`` a step on
     digital, nothing else; finite losses; the loss per step, steps/s,
     tokens/s and peak memory, and one more step under the profiler:
     every launch on the card and the device time a step;
8. the kernel table, nvidia-smi's line, and the result line.
"""
import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12            # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FLOPS = {"float64": 34e12,      # H100 SXM FP64 non-tensor (data sheet)
              "float32": 67e12}      # H100 SXM FP32 non-tensor (data sheet)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


T_IMPORT = time.perf_counter()


def emit(**kw):
    """One JSON line, with the seconds since the script started."""
    print(json.dumps({**kw, "at_s": time.perf_counter() - T_IMPORT}),
          flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0 and out.stdout.strip(),
          f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, iters: int, reps: int = 5) -> float:
    """Device time of one ``fn()``: ``iters`` calls captured in a CUDA
    graph, replayed ``reps`` times between CUDA events (no host gaps)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (reps * iters)
    del graph
    torch.cuda.empty_cache()
    return ms


def event_ms(fn, iters: int) -> float:
    """Device time of one ``fn()`` between CUDA events around ``iters``
    calls after a warm one, for work a CUDA graph cannot capture (the
    plain threefry draw copies its constants to the card); at milliseconds
    a call, the card's queue hides the host's launch gaps."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def same_bits(a, b) -> bool:
    """Equal as integers: unlike ``torch.equal``, -0.0 differs from +0.0
    (and NaNs compare by their bits)."""
    import torch
    ints = {8: torch.int64, 4: torch.int32}[a.element_size()]
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.view(ints), b.view(ints)))


def bound(bytes_moved: float, flops: float, dtype: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------- kernels

def ota_case(rows, d, gdt, seed):
    import torch
    from repro_torch.kernels import ota_combine, ref
    acc = torch.float64 if gdt == torch.float64 else torch.float32
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = torch.randn(rows, d, generator=gen, device="cuda", dtype=acc).to(gdt)
    z = torch.randn(rows, d, generator=gen, device="cuda", dtype=acc) * 1e-3
    inv = torch.rand(rows, generator=gen, device="cuda", dtype=acc) + 0.5
    out = ota_combine(g, inv, z)
    plain = ref.ota_combine_ref(g, inv, z)
    torch.cuda.synchronize()
    check(out.dtype == acc and out.shape == (rows, d), "ota_combine shape")
    err = float((out - plain).abs().max())
    check(torch.equal(out, plain),
          f"ota_combine != plain at ({rows}, {d}) {gdt}: max err {err}")
    n = rows * d
    nbytes = n * (g.element_size() + 2 * z.element_size()) + rows * 8
    iters = 50 if nbytes < 64e6 else 4
    ms = device_ms(lambda: ota_combine(g, inv, z), iters)
    plain_ms = device_ms(lambda: ref.ota_combine_ref(g, inv, z), iters)
    inv_col = inv[:, None]
    # one PyTorch call for the same function, where the types allow it
    lib_ms = (device_ms(lambda: torch.addcmul(z, g, inv_col), iters)
              if gdt == acc else None)
    b_ms, b_by = bound(nbytes, 2 * n, str(acc).split(".")[1])
    return dict(shape=[rows, d], dtype=str(gdt).split(".")[1],
                max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by)


def quant_inputs(rows, d, dt, seed, offset=0):
    """Kernel 2's inputs, made on the card from a seed: (g, u, scal). Row 1
    is all zero (m = 0), row 2 has no bits (L = 0). ``offset``: g and u
    are taken as ``[offset:]`` of (rows + offset, d) buffers, so with d
    odd their addresses are off the kernel's 2-entry vectors."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = torch.randn(rows + offset, d, generator=gen, device="cuda", dtype=dt)
    g = g * (torch.rand(rows + offset, 1, generator=gen, device="cuda",
                        dtype=dt) * 5)
    g = g[offset:]
    g[1] = 0.0                                    # m = 0: all-zero row
    u = torch.rand(rows + offset, d, generator=gen, device="cuda")[offset:]
    check(g.is_contiguous() and u.is_contiguous(), "views not contiguous")
    check(offset == 0 or d % 2 == 0
          or (g.data_ptr() % (2 * g.element_size()) != 0
              and u.data_ptr() % 8 != 0),
          "the offset views are aligned to the kernel's vectors")
    bits = torch.randint(1, 17, (rows,), generator=gen, device="cuda")
    levels = (2.0 ** bits.to(dt)) - 1.0
    levels[2] = 0.0                               # a device with no bits
    scal = torch.stack([g.abs().amax(1), levels], 1).contiguous()
    return g, u, scal


def quant_case(rows, d, dt, seed, offset=0):
    """Kernel 2 against its plain version (``quant_inputs``), compared by
    bits; with an odd d and ``offset`` 1, on the kernel's entry-by-entry
    path for operands off its vectors."""
    import torch
    from repro_torch.kernels import dithered_quantize_rows, ref
    g, u, scal = quant_inputs(rows, d, dt, seed, offset)
    m, levels = scal[:, 0], scal[:, 1]
    out = dithered_quantize_rows(g, u, scal)
    plain = ref.dithered_quantize_rows_ref(g, u, m, levels)
    torch.cuda.synchronize()
    check(out.shape == (rows, d) and bool(torch.isfinite(out).all()),
          "dithered_quantize_rows output")
    err = float((out - plain).abs().max())
    check(same_bits(out, plain),
          f"dithered_quantize_rows != plain at ({rows}, {d}) {dt} offset "
          f"{offset}: max err {err}")
    check(not bool(out[1:3].view(torch.int64 if dt == torch.float64
                                 else torch.int32).any()),
          "degenerate rows must quantize to +0.0")
    # this run's data: invalid rows read nothing and only write zeros
    live = int(((m > 0) & (levels > 0)).sum())
    s = g.element_size()
    nbytes = live * d * (s + 4) + rows * d * s + rows * 2 * s
    iters = 50 if nbytes < 64e6 else 4
    ms = device_ms(lambda: dithered_quantize_rows(g, u, scal), iters)
    plain_ms = device_ms(
        lambda: ref.dithered_quantize_rows_ref(g, u, m, levels), iters)
    b_ms, b_by = bound(nbytes, 10 * live * d, str(dt).split(".")[1])
    return dict(shape=[rows, d], dtype=str(dt).split(".")[1], offset=offset,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=b_ms, bound_by=b_by)


PAYLOAD_SOURCE = "src/repro_torch/kernels/csrc/payload.cu"


def payload_inputs(rows, d, dt, cb, seed, trials, silent="one"):
    """Rows of the payload cases, made on the card from a seed: (g, u,
    scal, weights w (trials, rows // trials)). Row 1 is all zero (m = 0)
    and row 2 has no bits (L = 0). ``silent`` says which devices are out
    of the round (w = 0): "one", the last device of the last trial;
    "best_channel", Fig. 3 Best Channel's pattern, 6 of the 10 devices of
    every trial (K = 4 scheduled); "trial", every device of trial 0."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = torch.randn(rows, d, generator=gen, device="cuda", dtype=dt)
    g = g * (torch.rand(rows, 1, generator=gen, device="cuda", dtype=dt) * 5)
    g[1] = 0.0
    u = torch.rand(rows, d, generator=gen, device="cuda")
    bits = torch.randint(1, cb + 1, (rows,), generator=gen, device="cuda")
    # integer levels, as the engine's (NumPy) are: 2.0 ** bits on the card
    # is not exact (2^11 - 1 came out as 2046.9999999999998), and a code
    # the packer truncates is no longer the two-step quantizer's
    levels = ((1 << bits) - 1).to(dt)
    levels[2] = 0.0
    m = g.abs().amax(1)
    scal = torch.stack([m, levels], 1).contiguous()
    n = rows // trials
    w = torch.rand(trials, n, generator=gen, device="cuda", dtype=dt) * 2
    if silent == "one":
        w[-1, -1] = 0.0
    elif silent == "best_channel":
        for t in range(trials):
            off = torch.rand(n, generator=gen, device="cuda").argsort()[:n - 4]
            w[t, off] = 0.0
    elif silent == "trial":
        w[0] = 0.0
    else:
        raise ValueError(silent)
    return g, u, scal, w


def payload_case(rows, d, dt, cb, seed, trials, silent="one",
                 misaligned=False, timed=True):
    """The three payload kernels on one set of rows (``payload_inputs``),
    each against its plain version, compared by bits; rows = trials x
    devices for the weighted sum. ``misaligned``: the weighted sum reads
    its words from a view 4 bytes past an 8-byte boundary."""
    import torch
    from repro_torch.kernels import (dithered_quantize_rows,
                                     packed_weighted_sum, quantize_pack_rows,
                                     ref, unpack_dequant_rows)
    g, u, scal, w = payload_inputs(rows, d, dt, cb, seed, trials, silent)
    m, levels = scal[:, 0], scal[:, 1]
    n = rows // trials
    scal3 = torch.cat([scal.reshape(trials, n, 2), w[..., None]],
                      -1).contiguous()
    tag = (f"({rows}, {d}) {dt} code_bits {cb} trials {trials} silent "
           f"{silent}{' misaligned' if misaligned else ''}")

    words = quantize_pack_rows(g, u, scal, cb)
    words_p = ref.quantize_pack_rows_ref(g, u, scal, cb)
    out = unpack_dequant_rows(words, scal, cb, d)
    out_p = ref.unpack_dequant_rows_ref(words, scal, cb, d)
    two_step = dithered_quantize_rows(g, u, scal)
    words4 = words.reshape(trials, n, *words.shape[1:])
    if misaligned:
        flat = torch.empty(words4.numel() + 1, dtype=torch.int32,
                           device="cuda")
        flat[1:] = words4.flatten()
        words4 = flat[1:].view(words4.shape)
        check(words4.data_ptr() % 8 == 4, "the words view is aligned")
    acc = packed_weighted_sum(words4, scal3, cb, d)
    acc_p = ref.packed_weighted_sum_ref(words4, scal3, cb, d)
    torch.cuda.synchronize()
    errs = {
        "quantize_pack_rows": float((words.long() - words_p.long()).abs()
                                    .max()),
        "unpack_dequant_rows": float((out - out_p).abs().max()),
        "packed_weighted_sum": float((acc - acc_p).abs().max())}
    check(torch.equal(words, words_p), f"quantize_pack_rows != plain at {tag}")
    check(not bool(words[1:3].any()), "degenerate rows must code to 0")
    check(same_bits(out, out_p), f"unpack_dequant_rows != plain at {tag}")
    check(same_bits(out, two_step),
          f"unpack(pack(g)) != dithered_quantize_rows kernel at {tag}")
    check(acc.shape == (trials, d) and bool(torch.isfinite(acc).all()),
          "packed_weighted_sum output")
    check(same_bits(acc, acc_p), f"packed_weighted_sum != plain at {tag}")
    if silent == "trial":
        check(not bool(acc[0].view(torch.int64 if dt == torch.float64
                                   else torch.int32).any()),
              f"a trial of silent devices must sum to +0.0 at {tag}")

    # this run's data: degenerate rows read nothing and write zero words
    # (or zeros); the sum needs only the words of devices that quantize
    # and carry weight
    s = g.element_size()
    live = (m > 0) & (levels > 0)
    n_live = int(live.sum())
    n_sum = int((live.reshape(trials, n) & (w != 0)).sum())
    wpr = words[0].numel()
    fam = str(dt).split(".")[1]
    work = {
        "quantize_pack_rows": (
            n_live * d * (s + 4) + rows * wpr * 4 + rows * 2 * s,
            10 * n_live * d,
            lambda: quantize_pack_rows(g, u, scal, cb),
            lambda: ref.quantize_pack_rows_ref(g, u, scal, cb)),
        "unpack_dequant_rows": (
            n_live * wpr * 4 + rows * d * s + rows * 2 * s,
            2 * n_live * d,
            lambda: unpack_dequant_rows(words, scal, cb, d),
            lambda: ref.unpack_dequant_rows_ref(words, scal, cb, d)),
        "packed_weighted_sum": (
            n_sum * wpr * 4 + trials * d * s + rows * 3 * s,
            4 * n_sum * d,
            lambda: packed_weighted_sum(words4, scal3, cb, d),
            lambda: ref.packed_weighted_sum_ref(words4, scal3, cb, d))}
    out_rows = {}
    for kname, (nbytes, ops, fn, plain_fn) in work.items():
        iters = 50 if nbytes < 64e6 else 4
        b_ms, b_by = bound(nbytes, ops, fam)
        out_rows[kname] = dict(
            shape=[rows, d], trials=trials, dtype=fam, code_bits=cb,
            silent=silent, misaligned=misaligned, max_abs_err=errs[kname],
            ms=device_ms(fn, iters) if timed else None,
            plain_ms=device_ms(plain_fn, iters) if timed else None,
            library_ms=None, bound_ms=b_ms, bound_by=b_by)
    return out_rows


def reduce_inputs(rows, d, gdt, seed):
    """Kernel 4's rows, made on the card from a seed, and the accumulator
    type (f32 for bf16 rows). Row 0 is all zero."""
    import torch
    acc = torch.float32 if gdt == torch.bfloat16 else gdt
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = torch.randn(rows, d, generator=gen, device="cuda", dtype=acc)
    g = (g * (torch.rand(rows, 1, generator=gen, device="cuda", dtype=acc)
              * 5)).to(gdt)
    g[0] = 0.0
    return g, acc


def reduce_case(rows, d, gdt, seed, timed=True, nan=False):
    """Per-row (max |g|, sum g^2) against its plain version
    (``reduce_inputs``): both add in the kernel's order, so bit-equal,
    compared as integers. With ``nan``, row 2 holds one NaN entry (its
    maximum and sum are NaN, the other rows as ever)."""
    import torch
    from repro_torch.kernels import ref, row_maxabs_sumsq
    g, acc = reduce_inputs(rows, d, gdt, seed)
    if nan:
        g[2, d // 3] = float("nan")
    out = row_maxabs_sumsq(g, acc)
    plain = ref.row_maxabs_sumsq_ref(g, acc)
    torch.cuda.synchronize()
    finite = torch.isfinite(out).all(1)
    check(out.shape == (rows, 2) and out.dtype == acc
          and bool(finite.sum() == rows - int(nan))
          and (not nan or bool(torch.isnan(out[2]).all()))
          and not bool(out[0].any()),
          f"row_maxabs_sumsq output at ({rows}, {d}) {gdt}")
    err = float((out - plain)[finite].abs().max())
    check(same_bits(out, plain),
          f"row_maxabs_sumsq != plain at ({rows}, {d}) {gdt}: max err {err}")
    nbytes = rows * d * g.element_size() + rows * 2 * out.element_size()
    row = dict(shape=[rows, d], dtype=str(gdt).split(".")[1],
               acc_dtype=str(acc).split(".")[1], nan_row=nan,
               max_abs_err=err, ms=None, plain_ms=None, library_ms=None,
               library="torch.linalg.vector_norm (the sum half only)")
    row["bound_ms"], row["bound_by"] = bound(nbytes, 3 * rows * d,
                                             str(acc).split(".")[1])
    if timed:
        iters = 50 if nbytes < 64e6 else 4
        row["ms"] = device_ms(lambda: row_maxabs_sumsq(g, acc), iters)
        row["plain_ms"] = device_ms(
            lambda: ref.row_maxabs_sumsq_ref(g, acc), iters)
        # one PyTorch call reading the same bytes for half of the function
        row["library_ms"] = device_ms(
            lambda: torch.linalg.vector_norm(g, dim=1, dtype=acc), iters)
    return row


SCAN_SOURCE = "src/repro_torch/kernels/csrc/selective_scan.cu"


def scan_inputs(B, S, D, n, seed):
    """The reference test's distributions (``tests/test_kernels.py``), made
    on the card from a seed: (dt, x, bm, cm, a_w, h0)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(generator=gen, device="cuda")
    dt = torch.rand(B, S, D, **kw) * 0.199 + 0.001
    x = torch.randn(B, S, D, **kw)
    bm = torch.randn(B, S, n, **kw) * 0.5
    cm = torch.randn(B, S, n, **kw) * 0.5
    a_w = -torch.exp(torch.randn(D, n, **kw) * 0.3)
    h0 = torch.randn(B, D, n, **kw) * 0.1
    return dt, x, bm, cm, a_w, h0


def scan_case(B, S, D, n, seed, timed=True):
    """The selective scan against its plain version on the reference
    test's distributions: bit-equal y and h_last."""
    import torch
    from repro_torch.kernels import ref, selective_scan
    ins = scan_inputs(B, S, D, n, seed)
    y, h = selective_scan(*ins)
    y_p, h_p = ref.selective_scan_ref(*ins)
    torch.cuda.synchronize()
    tag = f"({B}, {S}, {D}, {n})"
    check(y.shape == (B, S, D) and h.shape == (B, D, n)
          and bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all()),
          f"selective_scan output at {tag}")
    err = max(float((y - y_p).abs().max()), float((h - h_p).abs().max()))
    check(torch.equal(y, y_p) and torch.equal(h, h_p),
          f"selective_scan != plain at {tag}: max err {err}")
    # each input read once, y and h_last written once; per (b, t, d, j)
    # one exp (counted as one operation) and 7 multiplies and adds
    nbytes = 4 * (3 * B * S * D + 2 * B * S * n + D * n + 2 * B * D * n)
    b_ms, b_by = bound(nbytes, 8 * B * S * D * n, "float32")
    out = dict(shape=[B, S, D, n], dtype="float32", max_abs_err=err,
               library_ms=None, bound_ms=b_ms, bound_by=b_by)
    if timed:
        big = nbytes > 64e6
        out["ms"] = device_ms(lambda: selective_scan(*ins), 5 if big else 20)
        out["plain_ms"] = device_ms(lambda: ref.selective_scan_ref(*ins),
                                    2 if big else 5, reps=3)
    return out


LSCAN_SOURCE = "src/repro_torch/kernels/csrc/linear_scan.cu"


def lscan_case(B, S, D, seed, identity=False, timed=True):
    """The linear scan against its plain version on the reference test's
    distributions (``tests/test_kernels.py``: a uniform in [0.3, 0.999),
    b normal x 0.1, h0 normal), or on identity dynamics (a = 1, b = 0:
    h_t = h0 exactly): bit-equal h_all and h_last."""
    import torch
    from repro_torch.kernels import linear_scan, ref
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(generator=gen, device="cuda")
    h0 = torch.randn(B, D, **kw)
    if identity:
        a = torch.ones(B, S, D, device="cuda")
        b = torch.zeros(B, S, D, device="cuda")
    else:
        a = torch.rand(B, S, D, **kw) * 0.699 + 0.3
        b = torch.randn(B, S, D, **kw) * 0.1
    h, last = linear_scan(a, b, h0)
    h_p, last_p = ref.linear_scan_ref(a, b, h0)
    torch.cuda.synchronize()
    tag = f"({B}, {S}, {D}){' identity' if identity else ''}"
    check(h.shape == (B, S, D) and last.shape == (B, D)
          and bool(torch.isfinite(h).all()), f"linear_scan output at {tag}")
    err = max(float((h - h_p).abs().max()), float((last - last_p).abs().max()))
    check(torch.equal(h, h_p) and torch.equal(last, last_p),
          f"linear_scan != plain at {tag}: max err {err}")
    check(not identity or (torch.equal(h, h0[:, None].expand(B, S, D))
                           and torch.equal(last, h0)),
          f"linear_scan identity dynamics moved h at {tag}")
    # a and b read once, h_all written once, h0 and h_last; a multiply
    # and an add a step
    nbytes = 4 * (3 * B * S * D + 2 * B * D)
    b_ms, b_by = bound(nbytes, 2 * B * S * D, "float32")
    out = dict(shape=[B, S, D], dtype="float32", identity=identity,
               max_abs_err=err, library_ms=None, bound_ms=b_ms,
               bound_by=b_by)
    if timed:
        out["ms"] = device_ms(lambda: linear_scan(a, b, h0),
                              5 if nbytes > 64e6 else 20)
        out["plain_ms"] = device_ms(lambda: ref.linear_scan_ref(a, b, h0),
                                    1 if S >= 2048 else 3, reps=3)
    return out


SASS_BRANCH = r"(@!?U?P\w+\s+)?(BRA|EXIT|RET)\b(?:.*?0x([0-9a-f]+))?"


def sass_bodies(lib: Path, function: str, marker: str):
    """The unrolled bodies of a kernel's full tile in SASS, read with
    cuobjdump from the built library: in ``function`` (a substring of its
    mangled name), the straight-line stretches (a forward branch over
    straight code, a skipped store, does not end one) that hold the most
    ``marker`` instructions, one a step and state, so one body for each
    role a warp can take. Returns each body's instructions over its
    markers, and the other instructions of the tile loop (the outermost
    backward branch's span, less every stretch holding a marker): what a
    tile can add to a body at most (the wait, the barrier, the copies,
    the dispatch), and the opcodes of the first body. "not measured"
    where the toolkit has no cuobjdump."""
    import re
    import shutil
    from repro_torch.kernels import build
    tool = shutil.which("cuobjdump") or str(
        Path(build._nvcc()).parent / "cuobjdump")
    if not Path(tool).exists():
        return "not measured"
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=120)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr.strip()}")
    found = [part for part in out.stdout.split("Function : ")[1:]
             if function in part.split(None, 1)[0]]
    check(len(found) == 1, f"{len(found)} SASS functions match {function}")
    ins = [(int(m[1], 16), m[2]) for m in
           re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", found[0])]
    match = [re.match(SASS_BRANCH, text) for _, text in ins]
    after, nxt = [0.0] * len(ins), float("inf")
    for i in reversed(range(len(ins))):      # the next branch's address
        after[i] = nxt
        if match[i]:
            nxt = ins[i][0]
    stretches, cur = [], []
    for i, m in enumerate(match):
        cur.append(i)
        if m and not (m[1] and m[3] and ins[i][0] < int(m[3], 16) <= after[i]):
            stretches.append(cur)
            cur = []
    stretches.append(cur)
    marks = [sum(marker in ins[i][1] for i in st) for st in stretches]
    top = max(marks)
    check(top > 0, f"no {marker} in {function}'s SASS")
    bodies = [len(st) for st, k in zip(stretches, marks) if k == top]
    first = next(st for st, k in zip(stretches, marks) if k == top)
    opcodes = {}
    for i in first:                          # the first body's opcodes
        op = re.sub(r"^@!?U?P\w+\s+", "", ins[i][1]).split()[0].split(".")[0]
        opcodes[op] = opcodes.get(op, 0) + 1
    lo, hi = max(((int(m[3], 16), ins[i][0]) for i, m in enumerate(match)
                  if m and m[3] and int(m[3], 16) < ins[i][0]),
                 key=lambda span: span[1] - span[0])
    marked = {i for st, k in zip(stretches, marks) if k for i in st}
    loop_other = sum(lo <= a <= hi and i not in marked
                     for i, (a, _) in enumerate(ins))
    return dict(steps_a_body=top, bodies=bodies,
                per_step=[b / top for b in bodies], loop_other=loop_other,
                opcodes=opcodes)


def issue_floor(shape, row, bodies) -> dict:
    """An estimate of the selective scan's floor in issue slots at
    ``shape``: its warp-instructions over four a clock on every SM, at the
    SM clock read while it runs. The low end counts only the bodies (their
    mean an element), the high end the largest body and all the tile
    loop's other code; ``row`` is the kernel case's reading."""
    import torch
    from repro_torch.kernels import selective_scan
    if bodies == "not measured":
        return dict(shape=list(shape), floor_ms="not measured")
    ins = scan_inputs(*shape, seed=sum(shape))
    clock = sm_clock_under(lambda: selective_scan(*ins), 10000)
    mhz = float(clock["clocks_sm"].split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    B, S, D, n = shape
    per_element = (sum(bodies["per_step"]) / len(bodies["per_step"]),
                   (max(bodies["bodies"]) + bodies["loop_other"])
                   / bodies["steps_a_body"])
    floor_ms = [B * S * D * n / 32 * k / (4 * sms * mhz * 1e6) * 1e3
                for k in per_element]
    return dict(shape=list(shape), ms=row["ms"], sms=sms, **clock,
                instructions_an_element=per_element, floor_ms=floor_ms,
                share_of_floor=[f / row["ms"] for f in floor_ms])


FP64_LANES_AN_SM = 64   # H100 SXM: 34 TFLOP/s FP64 = 132 SMs x 64 FMA x 2 x 1.98 GHz
CONV64_AN_SM = 16       # conversions to and from 64-bit types a clock an SM
                        # (CUDA C++ Programming Guide, throughput, cc 9.0)


def graph_of(fn, calls: int):
    """``calls`` calls of ``fn`` captured in one CUDA graph (after a warm
    call on a side stream), to keep the card busy with short kernels."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return graph


def wsum_issue_floor(row, bodies) -> dict:
    """An estimate of the f64 weighted sum's floor at the main path's case
    (``row``, 8-bit codes; its inputs made again from the same seed):
    every code of every word of the devices it keeps, at the SASS
    instructions an entry of its full unrolled device loop (two DMUL an
    entry; the low end the loop's bodies, the high end the largest body
    and all the loop's other code), over four warp-instructions a clock on
    every SM, its FP64 instructions an entry over the FP64 pipe's 64
    lanes an SM, and its I2F.F64 conversions an entry over the 16 a clock
    an SM, at the SM clock read while it runs."""
    import torch
    from repro_torch.kernels import packed_weighted_sum, quantize_pack_rows
    if bodies == "not measured":
        return dict(shape=row["shape"], floor_ms="not measured")
    (rows, d), trials, cb = row["shape"], row["trials"], row["code_bits"]
    g, u, scal, w = payload_inputs(rows, d, torch.float64, cb, seed=d + cb,
                                   trials=trials)
    n = rows // trials
    words = quantize_pack_rows(g, u, scal, cb).reshape(trials, n, -1, 128)
    scal3 = torch.cat([scal.reshape(trials, n, 2), w[..., None]],
                      -1).contiguous()
    graph = graph_of(lambda: packed_weighted_sum(words, scal3, cb, d), 200)
    clock = sm_clock_under(graph.replay, 1500)
    del graph
    mhz = float(clock["clocks_sm"].split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    live = (scal[:, 0] > 0) & (scal[:, 1] > 0)
    kept = int((live.reshape(trials, n) & (w != 0)).sum())
    entries = kept * words.shape[2] * 128 * (32 // cb)
    per_dmul = (sum(bodies["per_step"]) / len(bodies["per_step"]),
                (max(bodies["bodies"]) + bodies["loop_other"])
                / bodies["steps_a_body"])
    per_entry = [2 * k for k in per_dmul]
    fp64_entry = 2 * sum(bodies["opcodes"].get(op, 0) for op in
                         ("DADD", "DMUL", "DFMA")) / bodies["steps_a_body"]
    issue_ms = [entries / 32 * k / (4 * sms * mhz * 1e6) * 1e3
                for k in per_entry]
    fp64_ms = entries * fp64_entry / (FP64_LANES_AN_SM * sms * mhz * 1e6) * 1e3
    conv_entry = 2 * bodies["opcodes"].get("I2F", 0) / bodies["steps_a_body"]
    conv_ms = entries * conv_entry / (CONV64_AN_SM * sms * mhz * 1e6) * 1e3
    floor_ms = [max(f, fp64_ms, conv_ms) for f in issue_ms]
    return dict(shape=row["shape"], trials=trials, code_bits=cb,
                ms=row["ms"], bound_ms=row["bound_ms"], sms=sms, **clock,
                entries=entries, instructions_an_entry=per_entry,
                fp64_an_entry=fp64_entry, i2f_an_entry=conv_entry,
                issue_ms=issue_ms, fp64_pipe_ms=fp64_ms, i2f_ms=conv_ms,
                floor_ms=floor_ms,
                share_of_floor=[f / row["ms"] for f in floor_ms])


def ota_launch_floor() -> dict:
    """``ota_combine`` on (1, 2) f64 (48 bytes) timed as every kernel case
    is: the least time one launch takes in this harness."""
    import torch
    from repro_torch.kernels import ota_combine, ref
    g = torch.tensor([[1.5, -2.0]], dtype=torch.float64, device="cuda")
    inv = torch.tensor([0.25], dtype=torch.float64, device="cuda")
    z = torch.tensor([[1e-3, 2e-3]], dtype=torch.float64, device="cuda")
    check(same_bits(ota_combine(g, inv, z), ref.ota_combine_ref(g, inv, z)),
          "ota_combine != plain at (1, 2)")
    return dict(ms=device_ms(lambda: ota_combine(g, inv, z), 50))


def sm_clock_under(fn, calls: int) -> dict:
    """nvidia-smi's SM clock and power draw, read while ``calls`` calls of
    ``fn`` run back to back on the card."""
    import threading
    import torch
    fn()
    torch.cuda.synchronize()
    got = {}

    def read():
        time.sleep(0.3)
        got["smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        got["done"] = torch.cuda.current_stream().query()

    reader = threading.Thread(target=read)
    reader.start()
    for _ in range(calls):
        fn()
    reader.join()
    torch.cuda.synchronize()
    check("smi" in got and got["smi"], "nvidia-smi gave no clock")
    check(not got["done"], "the card went idle before the clock was read")
    sm, sm_max, power = (v.strip() for v in got["smi"].split(","))
    return dict(clocks_sm=sm, clocks_max_sm=sm_max, power_draw=power)


# ------------------------------------------------------------------ design

DESIGN_CPU_RTOL = 1e-6      # card against the CPU, objectives
PARITY_RTOL = 1e-3          # card against the SciPy SCA oracle
                            # (benchmarks/design_bench.py's gate)


def bench_specs(n_devices, grid):
    """``benchmarks/design_bench.py``'s grid: deployment seed 1, d = 7850,
    G = 20, T_max = 0.2 s, (omega_var, omega_bias) log-spaced over
    [0.1, 10] x the strongly convex weights at eta = 0.1, mu = 0.01,
    kappa_sc = 3."""
    import numpy as np
    from repro_torch.core import digital_design, ota_design
    from repro_torch.core.bounds import ObjectiveWeights
    from repro_torch.core.channel import WirelessConfig, make_deployment
    dep = make_deployment(WirelessConfig(n_devices=n_devices, seed=1))
    cfg = dep.cfg
    base = ObjectiveWeights.strongly_convex(eta=0.1, mu=0.01, kappa_sc=3.0,
                                            n=n_devices)
    weights = [ObjectiveWeights(omega_var=base.omega_var * a,
                                omega_bias=base.omega_bias * b)
               for a in np.logspace(-1.0, 1.0, grid[0])
               for b in np.logspace(-1.0, 1.0, grid[1])]
    ota = [ota_design.OTADesignSpec(
        lambdas=dep.lambdas, dim=7850, g_max=20.0, e_s=cfg.energy_per_symbol,
        n0=cfg.noise_power, weights=w) for w in weights]
    dig = [digital_design.DigitalDesignSpec(
        lambdas=dep.lambdas, dim=7850, g_max=20.0, e_s=cfg.energy_per_symbol,
        n0=cfg.noise_power, bandwidth_hz=cfg.bandwidth_hz, t_max_s=0.2,
        weights=w) for w in weights]
    return ota, dig


def launches_of(fn):
    """Run ``fn()`` under ``torch.profiler`` (the card's activity only);
    (kernel launches, {memory copy or set: count}, device ms) it made,
    read from the profiler's raw events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels, copies, busy_ns = 0, {}, 0
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        busy_ns += evt.duration_ns()
        if evt.name().startswith(("Memcpy", "Memset")):
            copies[evt.name()] = copies.get(evt.name(), 0) + 1
        else:
            kernels += 1
    check(kernels > 0, "the profiler saw no kernel on the card")
    return kernels, copies, busy_ns / 1e6


def design_case(family, specs, run, oracle_iters=None):
    """Solve ``specs`` with the port's batched solver on the card: cold,
    then warm (host clock to a synchronise), then once more under the
    profiler; the same solve with ``device="cpu"`` must give the same
    objectives within DESIGN_CPU_RTOL and, for the digital family, the
    same finalized bits. With ``oracle_iters`` the case is the oracle
    check instead of a timing: one solve on the card, each point also
    solved by the port's SciPy SCA oracle (``design_*_sca``), which the
    card must match or beat within PARITY_RTOL. Returns the card's
    parameters."""
    import numpy as np
    import torch
    from repro_torch.core import digital_design, ota_design
    batch, sca = ((ota_design.design_ota_batch, ota_design.design_ota_sca)
                  if family == "ota" else
                  (digital_design.design_digital_batch,
                   digital_design.design_digital_sca))
    line = dict(phase="design", family=family, run=run, batch=len(specs),
                n_devices=specs[0].n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, objs = batch(specs)
    torch.cuda.synchronize()
    line["cold_s"] = time.perf_counter() - t0
    if oracle_iters is None:
        t0 = time.perf_counter()
        params, objs = batch(specs)
        torch.cuda.synchronize()
        line["warm_s"] = time.perf_counter() - t0
        kernels, copies, device_ms = launches_of(lambda: batch(specs))
        line.update(launches=kernels, copies=copies, device_ms=device_ms,
                    device_idle=1.0 - device_ms / 1e3 / line["warm_s"])
    cpu_params, cpu_objs = batch(specs, device="cpu")
    rel = float(np.max(np.abs(objs - cpu_objs) / np.abs(cpu_objs)))
    check(np.all(np.isfinite(objs)) and rel <= DESIGN_CPU_RTOL,
          f"design {run}: card vs CPU objectives differ by {rel} relative "
          f"(limit {DESIGN_CPU_RTOL}): {objs.tolist()} vs "
          f"{cpu_objs.tolist()}")
    line.update(objectives=objs.tolist(), max_rel_vs_cpu=rel,
                limit_vs_cpu=DESIGN_CPU_RTOL)
    if family == "digital":
        same = all(np.array_equal(p.r_bits, c.r_bits)
                   for p, c in zip(params, cpu_params))
        check(same, f"design {run}: r_bits differ between card and CPU")
        line.update(r_bits_equal_cpu=True,
                    r_bits=sorted({int(r) for p in params for r in p.r_bits}))
    if oracle_iters is not None:
        t0 = time.perf_counter()
        oracle = np.array([sca(spec, n_iters=oracle_iters)[1].objective
                           for spec in specs])
        gap = float(np.max((objs - oracle) / np.abs(oracle)))
        check(gap <= PARITY_RTOL,
              f"design {run}: the card loses to the SCA oracle by {gap} "
              f"relative (limit {PARITY_RTOL})")
        line.update(oracle_n_iters=oracle_iters,
                    oracle_objectives=oracle.tolist(),
                    max_rel_gap_vs_oracle=gap, limit_vs_oracle=PARITY_RTOL,
                    oracle_host_s=time.perf_counter() - t0)
    emit(**line)
    return params


def design_phase():
    """The batched Sec.-IV solver (``core/sca_torch.py``) on the card:
    Fig. 2's two designs at B = 1, which the main path then runs on; the
    design bench's fig2-sized sweep (N = 50, 4 x 4 weights, B = 16) for
    both families; its quick grid (N = 20, 2 x 2, SCA oracle at 4
    iterations) against the port's SciPy SCA oracle."""
    *_, ospec, _ = fig2_problem(50)
    *_, dspec = fig2_problem(10)
    (ota_p,) = design_case("ota", [ospec], "Fig. 2 OTA, N = 50")
    (dig_p,) = design_case("digital", [dspec],
                           "Fig. 2 digital, N = 10, T_max = 0.2 s")
    for family, specs in zip(("ota", "digital"), bench_specs(50, (4, 4))):
        design_case(family, specs, "design bench sweep, N = 50, 4 x 4")
    for family, specs in zip(("ota", "digital"), bench_specs(20, (2, 2))):
        design_case(family, specs, "design bench quick grid, N = 20, 2 x 2",
                    oracle_iters=4)
    return ota_p, dig_p


# --------------------------------------------------------------- main path

def fig2_problem(n_devices, t_max_s=0.2):
    """Fig. 2's task, deployment (seed 1), step and design problems at N
    devices: softmax regression (d = 7850, G = 20, mu = 0.01), eta =
    0.5 / (mu + L), the strongly convex weights at kappa_sc = 3, and the
    digital budget T_max."""
    from repro_torch.core import digital_design, ota_design
    from repro_torch.core.bounds import ObjectiveWeights
    from repro_torch.core.channel import WirelessConfig, make_deployment
    from repro_torch.fl import SoftmaxRegressionTask
    task = SoftmaxRegressionTask(n_features=784, mu=0.01, g_max=20.0)
    dep = make_deployment(WirelessConfig(n_devices=n_devices, seed=1))
    cfg = dep.cfg
    eta = 0.5 / (task.mu + task.smooth_l)          # 0.25 * eta_max
    w = ObjectiveWeights.strongly_convex(eta=eta, mu=task.mu, kappa_sc=3.0,
                                         n=n_devices)
    ospec = ota_design.OTADesignSpec(
        lambdas=dep.lambdas, dim=task.dim, g_max=task.g_max,
        e_s=cfg.energy_per_symbol, n0=cfg.noise_power, weights=w)
    dspec = digital_design.DigitalDesignSpec(
        lambdas=dep.lambdas, dim=task.dim, g_max=task.g_max,
        e_s=cfg.energy_per_symbol, n0=cfg.noise_power,
        bandwidth_hz=cfg.bandwidth_hz, t_max_s=t_max_s, weights=w)
    return task, dep, eta, ospec, dspec


def fig2_setup(n_devices, n_train_per_class):
    """The Fig. 2 cell at full width: MNIST-like data, one class and 1000
    samples per device; the parameters come from the design phase."""
    from repro_torch.data import (FLDataset, SyntheticSpec,
                                  make_classification_dataset,
                                  partition_by_class)
    task, dep, eta, _, _ = fig2_problem(n_devices)
    spec = SyntheticSpec(n_train_per_class=n_train_per_class,
                         n_test_per_class=200, noise_sigma=1.5, seed=0)
    x_tr, y_tr, x_te, y_te = make_classification_dataset(spec)
    ds = FLDataset.from_shards(
        partition_by_class(x_tr, y_tr, n_devices, 1, 1000, seed=3),
        x_te, y_te)
    return task, ds, dep, eta


def fig3_setup(n_devices=10, t_max_s=3.0):
    """The Fig. 3 cell at full width (``benchmarks/common.py::
    make_nc_setup``): CIFAR-like 32x32x3 data, two classes and 100 samples
    per device, the MLP 3072 -> 48 -> 10 (d = 147,994), eta = 0.08; the
    closed-form anchors under the non-convex weights (L = 10, kappa_nc =
    3; the anchors do not read them)."""
    import numpy as np
    from repro_torch.core import ota_design, digital_design
    from repro_torch.core.bounds import ObjectiveWeights
    from repro_torch.core.channel import WirelessConfig, make_deployment
    from repro_torch.data import (FLDataset, SyntheticSpec,
                                  make_classification_dataset,
                                  partition_by_class)
    from repro_torch.fl import MLPTask
    spec = SyntheticSpec(name="cifar-like", image_shape=(32, 32, 3),
                         n_train_per_class=120, n_test_per_class=100,
                         noise_sigma=1.8, seed=7)
    x_tr, y_tr, x_te, y_te = make_classification_dataset(spec)
    ds = FLDataset.from_shards(
        partition_by_class(x_tr, y_tr, n_devices, 2, 100, seed=5),
        x_te, y_te)
    task = MLPTask(n_features=3072, hidden=48, mu_nc=0.01, g_max=49.0)
    dep = make_deployment(WirelessConfig(n_devices=n_devices, seed=1))
    cfg, eta = dep.cfg, 0.08
    w = ObjectiveWeights.non_convex(eta=eta, smooth_l=10.0, kappa_nc=3.0,
                                    n=n_devices)
    ospec = ota_design.OTADesignSpec(
        lambdas=dep.lambdas, dim=task.dim, g_max=task.g_max,
        e_s=cfg.energy_per_symbol, n0=cfg.noise_power, weights=w)
    dspec = digital_design.DigitalDesignSpec(
        lambdas=dep.lambdas, dim=task.dim, g_max=task.g_max,
        e_s=cfg.energy_per_symbol, n0=cfg.noise_power,
        bandwidth_hz=cfg.bandwidth_hz, t_max_s=t_max_s, weights=w)
    ota_params = ota_design.params_from_gamma(
        ospec, ota_design.anchor_min_noise(ospec))
    # uniform anchor at a 15% participation target: a 3 s budget fits 7
    # bits a device, so the payload packs 8-bit codes
    dig_params = digital_design.finalize(
        dspec, *digital_design.anchor_uniform(dspec, beta0=0.15))
    check(np.isfinite(ota_params.alpha) and 5 <= dig_params.r_bits.min()
          and dig_params.r_bits.max() <= 8, "Fig. 3 design anchors")
    return task, ds, dep, eta, ota_params, dig_params


def run_path(name, trainer, engine_plain, agg, expect, bites=False,
             must_fall=True, **run):
    """Drive one scheme through the trainer with the launch counts at 0,
    read them just after, then the same run on the plain versions; both
    must agree bit for bit. ``expect`` maps kernels to the launches the
    run must make. With ``bites``, the run's ``time_budget_s`` must stop
    it mid-run: the wall-clock and the model freeze over the last eval
    slots; with ``bites=None`` it may or may not (the figure's budget over
    a baseline whose airtime depends on the draws). ``must_fall``: the
    loss must fall over the run (the proposed schemes); a baseline's must
    only be finite."""
    import numpy as np
    import torch
    from repro_torch import kernels
    trainer.run(agg, **{**run, "rounds": 2, "eval_every": 1})   # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    log = trainer.run(agg, **run)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    for kernel, n in expect.items():
        check(counts[kernel] == n,
              f"{name}: {kernel} launched {counts[kernel]} times, not {n}")
    loss = log.global_loss
    check(loss.shape == (run["trials"], run["rounds"] // run["eval_every"]
                         + 1) and np.all(np.isfinite(loss)),
          f"{name}: loss not finite / wrong shape {loss.shape}")
    fell = bool(loss[:, -1].mean() < loss[:, 0].mean())
    check(fell or not must_fall,
          f"{name}: loss did not fall: {loss.mean(0).tolist()}")
    wall = log.wall_time_s
    budget = run.get("time_budget_s", np.inf)
    bit = bool(wall[-1] >= budget)
    if bites:
        check(wall[1] < wall[-1] and wall[-1] == wall[-2] and bit
              and np.array_equal(loss[:, -1], loss[:, -2]),
              f"{name}: the budget did not stop the run mid-way: "
              f"wall {wall.tolist()}, loss {loss.mean(0).tolist()}")
    elif bites is None:
        check(np.all(np.diff(wall) >= 0) and wall[-1] > 0,
              f"{name}: wall-clock not increasing: {wall.tolist()}")
    else:
        check(np.all(np.diff(wall) > 0) and not bit,
              f"{name}: the budget bit: wall {wall.tolist()}")
    plain = engine_plain.run(agg, **run)
    check(np.array_equal(plain.global_loss, log.global_loss)
          and np.array_equal(plain.accuracy, log.accuracy)
          and np.array_equal(plain.wall_time_s, log.wall_time_s),
          f"{name}: kernel and plain trajectories differ: "
          f"{log.global_loss.tolist()} vs {plain.global_loss.tolist()}")
    emit(phase="main_path", run=name, scheme=log.scheme, launches=counts,
         rounds=run["rounds"], trials=run["trials"],
         time_budget_s=run.get("time_budget_s"), budget_bit=bit,
         seconds=seconds, rounds_per_s=run["rounds"] / seconds,
         loss=log.global_loss.mean(0).tolist(), loss_fell=fell,
         accuracy=log.accuracy.mean(0).tolist(),
         final_accuracy=log.final_accuracy(),
         wall_time_s=wall.tolist(), plain_equal=True)
    return counts


def dither_matches_cpu(trials, n, d, rounds):
    """The threefry dither made on the card against the CPU's, bit for
    bit (the tests tie the CPU stream to JAX's)."""
    import torch
    from repro_torch.core import rngstream
    keys = [rngstream.dither_base_key(0, tr) for tr in range(trials)]
    for t in rounds:
        card = rngstream.dither_blocks(keys, t, n, d, device="cuda")
        cpu = rngstream.dither_blocks(keys, t, n, d, device="cpu")
        check(torch.equal(card.cpu(), cpu),
              f"dither on the card != CPU at round {t}, ({trials}, {n}, {d})")
    emit(phase="dither_vs_cpu", shape=[trials, n, d], rounds=list(rounds),
         bit_equal=True)


def ota_suite(dep, consts):
    """Fig. 2's OTA baselines (``repro/api/schemes.py:26-28`` without the
    proposed and ideal ones), from the port's constructors."""
    from repro_torch.core import baselines as B
    return (B.OPCOTAFL(*consts), B.OPCOTAComp(*consts),
            B.LCPCOTAComp(dep, *consts), B.BBFLInterior(dep, *consts),
            B.BBFLAlternative(dep, *consts))


def digital_suite(dep, dconsts, k=4):
    """Fig. 2's digital baselines (``repro/api/schemes.py:30-32``), K = 4
    (``repro/api/spec.py:86``), the constructors' other defaults."""
    from repro_torch.core import baselines as B
    return tuple(cls(dep, *dconsts, k=k) for cls in (
        B.BestChannel, B.BestChannelNorm, B.PropFairness, B.UQOS, B.QML,
        B.FedTOE))


def small_matches_cpu():
    """The port at a small size on the card against its CPU run, for
    every scheme of the main path (the tests tie the CPU run to the JAX
    reference): 8x8 images (d = 650), 6 devices; the proposed schemes on
    parameters the card designed (``design_*_batch``) and on the
    closed-form anchors."""
    import numpy as np
    from repro_torch.core import baselines as B
    from repro_torch.core import digital_design, ota_design
    from repro_torch.core.bounds import ObjectiveWeights
    from repro_torch.core.channel import WirelessConfig, make_deployment
    from repro_torch.data import (FLDataset, SyntheticSpec,
                                  make_classification_dataset,
                                  partition_by_class)
    from repro_torch.fl import FLTrainer, SoftmaxRegressionTask
    x, y, xt, yt = make_classification_dataset(SyntheticSpec(
        image_shape=(8, 8, 1), n_train_per_class=200, n_test_per_class=50,
        noise_sigma=1.5))
    ds = FLDataset.from_shards(partition_by_class(x, y, 6, 1, 200, seed=3),
                               xt, yt)
    task = SoftmaxRegressionTask(n_features=64)
    dep = make_deployment(WirelessConfig(n_devices=6, seed=1))
    cfg = dep.cfg
    eta = 0.5 / (task.mu + task.smooth_l)
    w = ObjectiveWeights.strongly_convex(eta, task.mu, 3.0, 6)
    ospec = ota_design.OTADesignSpec(
        lambdas=dep.lambdas, dim=task.dim, g_max=task.g_max,
        e_s=cfg.energy_per_symbol, n0=cfg.noise_power, weights=w)
    dspec = digital_design.DigitalDesignSpec(
        lambdas=dep.lambdas, dim=task.dim, g_max=task.g_max,
        e_s=cfg.energy_per_symbol, n0=cfg.noise_power,
        bandwidth_hz=cfg.bandwidth_hz, t_max_s=0.2, weights=w)
    # f32 gradients on the card and on the CPU differ in the last ulps:
    # the reference's engine-vs-oracle slack for OTA; for digital those
    # ulps may flip a dither code, the tests' port-vs-JAX slack. The
    # capacity-rate latencies go through log, whose last bit may differ
    # between the card and the CPU: their wall-clocks are held within
    # 8 ulps, as the tests hold them against the reference
    consts = (task.dim, task.g_max, cfg.energy_per_symbol, cfg.noise_power)
    dconsts = consts + (cfg.bandwidth_hz,)
    card_t = FLTrainer(task, ds, dep, eta)
    cpu_t = FLTrainer(task, ds, dep, eta, device="cpu")
    (ota_designed,), _ = ota_design.design_ota_batch([ospec])
    (dig_designed,), _ = digital_design.design_digital_batch([dspec])
    for agg, rel_tol, wall_ulps in (
            (B.ProposedOTA(ota_designed, label="Proposed OTA-FL (designed "
                                               "on the card)"), 1e-5, 0),
            (B.ProposedDigital(dig_designed, label="Proposed Digital FL "
                                                   "(designed on the card)"),
             1e-3, 0),
            (B.ProposedOTA(ota_design.params_from_gamma(
                ospec, ota_design.anchor_min_noise(ospec)),
                label="Proposed OTA-FL (min-noise anchor)"), 1e-5, 0),
            (B.ProposedDigital(digital_design.finalize(
                dspec, *digital_design.anchor_uniform(dspec)),
                label="Proposed Digital FL (uniform anchor)"), 1e-3, 0),
            *[(agg, 1e-5, 0) for agg in ota_suite(dep, consts)],
            *[(agg, 1e-3, 8) for agg in digital_suite(dep, dconsts)]):
        run = dict(rounds=20, trials=2, eval_every=10, seed=5)
        card = card_t.run(agg, **run)
        cpu = cpu_t.run(agg, **run)
        rel = float(np.max(np.abs(card.global_loss - cpu.global_loss)
                           / np.abs(cpu.global_loss)))
        ulps = float(np.max(np.abs(card.wall_time_s - cpu.wall_time_s)
                            / np.spacing(np.maximum(cpu.wall_time_s,
                                                    1e-300))))
        check(rel <= rel_tol and ulps <= wall_ulps,
              f"{card.scheme}: card vs CPU loss differs by {rel} relative "
              f"(limit {rel_tol}) or wall-clock by {ulps} ulps (limit "
              f"{wall_ulps})")
        emit(phase="small_vs_cpu", scheme=card.scheme, max_rel_loss_diff=rel,
             limit=rel_tol, wall_time_max_ulps=ulps, wall_limit=wall_ulps)


def fig3_matches_cpu():
    """Both Fig. 3 schemes at full width on the card against the port's
    CPU run (which the tests tie to the JAX reference): 1 trial, 6 rounds.
    This is the fused payload route's card-vs-CPU check."""
    import numpy as np
    from repro_torch.core import baselines as B
    from repro_torch.fl import FLTrainer
    task, ds, dep, eta, ota_p, dig_p = fig3_setup()
    card_t = FLTrainer(task, ds, dep, eta)
    cpu_t = FLTrainer(task, ds, dep, eta, device="cpu")
    for agg, rel_tol in (
            (B.ProposedOTA(ota_p, label="Proposed OTA-FL (min-noise "
                                        "anchor)"), 1e-5),
            (B.ProposedDigital(dig_p, label="Proposed Digital FL (uniform "
                                            "anchor)"), 1e-3)):
        run = dict(rounds=6, trials=1, eval_every=2, seed=9)
        card = card_t.run(agg, **run)
        cpu = cpu_t.run(agg, **run)
        rel = float(np.max(np.abs(card.global_loss - cpu.global_loss)
                           / np.abs(cpu.global_loss)))
        check(rel <= rel_tol and np.array_equal(card.wall_time_s,
                                                cpu.wall_time_s),
              f"Fig. 3 {card.scheme}: card vs CPU loss differs by {rel} "
              f"relative (limit {rel_tol}) or wall-clock differs")
        emit(phase="fig3_vs_cpu", scheme=card.scheme, d=task.dim,
             rounds=run["rounds"], max_rel_loss_diff=rel, limit=rel_tol,
             loss_card=card.global_loss[0].tolist(),
             wall_time_equal=True)


MAMBA = "falcon-mamba-7b"
RGEMMA = "recurrentgemma-2b"
# each served model: the kernel of its prefill, the layer kind that
# launches it (once a layer), the layers of its full-width cut, the prompt
# tokens of the cut and of the main path (recurrentgemma's exceed its
# 2,048-token window), the scaled-down run's prompt tokens (over the
# scaled-down 64-token window), and its parameters at full size
SERVED = {
    MAMBA: dict(kernel="selective_scan", kind="mamba", cut=2,
                prompt_len=512, small_prompt=64, params=7_272_665_088),
    RGEMMA: dict(kernel="linear_scan", kind="rglru", cut=3,
                 prompt_len=2560, small_prompt=96, params=3_549_934_080),
}


def free_card():
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def recurrent_layers(cfg, kind) -> int:
    return sum(cfg.kind(i) == kind for i in range(cfg.n_layers))


def serve_kernel_vs_plain(arch):
    """The model at full width cut to its first layers: the serve loop
    with the scan kernel, then with its plain version fed the same tokens;
    prefill and decode logits must be bit-equal."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import SERVE_FLAGS, serve
    from repro_torch.models import make_model
    cell = SERVED[arch]
    kname = cell["kernel"]
    cfg = dataclasses.replace(get_config(arch), n_layers=cell["cut"])
    n_rec = recurrent_layers(cfg, cell["kind"])
    model = make_model(cfg, seed=0)
    run = dict(batch=4, prompt_len=cell["prompt_len"], tokens=32,
               keep_logits=True)
    kern = serve(model, **run)
    plain = serve(model, flags={**SERVE_FLAGS, "use_kernel": False},
                  feed=kern.generated, **run)
    check(kern.prefill_launches[kname] == n_rec
          and sum(kern.prefill_launches.values()) == n_rec
          and sum(kern.decode_launches.values()) == 0
          and sum(plain.prefill_launches.values()) == 0,
          f"{arch} {cell['cut']}-layer serve launches: kernel "
          f"{kern.prefill_launches}, plain {plain.prefill_launches}")
    check(bool(torch.isfinite(kern.prefill_logits).all())
          and bool(torch.isfinite(kern.decode_logits).all()),
          f"{arch} {cell['cut']}-layer serve logits not finite")
    diff = max(float((kern.prefill_logits.float()
                      - plain.prefill_logits.float()).abs().max()),
               float((kern.decode_logits.float()
                      - plain.decode_logits.float()).abs().max()))
    check(torch.equal(kern.prefill_logits, plain.prefill_logits)
          and torch.equal(kern.decode_logits, plain.decode_logits),
          f"{arch} {cell['cut']}-layer serve: kernel and plain logits "
          f"differ by {diff}")
    emit(phase="serve_kernel_vs_plain", arch=arch, n_layers=cell["cut"],
         kernel=kname, launches=n_rec, batch=4,
         prompt_len=cell["prompt_len"], tokens=32, dtype="bfloat16",
         bit_equal=True, max_abs_diff=diff,
         prefill_s_kernel=kern.prefill_s, prefill_s_plain=plain.prefill_s)
    del model, kern, plain
    free_card()


def serve_small_vs_cpu(arch):
    """The model at its ``scaled_down()`` sizes (f32) served on the card
    against the port's CPU run with the same weights, prompts and decode
    tokens: logits within the tests' 1e-4 (relative to the largest
    magnitude, plus 1e-4 relative)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import make_model
    cell = SERVED[arch]
    small = get_config(arch).scaled_down()
    cpu_m = make_model(small, seed=0, device="cpu")
    card_m = make_model(small, seed=None)
    card_m.load_state_dict(cpu_m.state_dict())
    run = dict(batch=4, prompt_len=cell["small_prompt"], tokens=8,
               keep_logits=True)
    cpu = serve(cpu_m, **run)
    card = serve(card_m, feed=cpu.generated, **run)
    check(card.prefill_launches[cell["kernel"]]
          == recurrent_layers(small, cell["kind"]),
          f"scaled-down {arch} serve launches {card.prefill_launches}")
    worst = 0.0
    for got, want in ((card.prefill_logits, cpu.prefill_logits),
                      (card.decode_logits, cpu.decode_logits)):
        got = got.cpu().double()
        want = want.double()
        scale = float(want.abs().max())
        gap = (got - want).abs()
        worst = max(worst, float(gap.max()) / scale)
        check(bool((gap <= 1e-4 * want.abs() + 1e-4 * scale).all()),
              f"scaled-down {arch} serve: card vs CPU logits differ by "
              f"{float(gap.max())} (largest logit {scale})")
    emit(phase="serve_small_vs_cpu", arch=small.name, max_rel_diff=worst,
         limit=1e-4, batch=4, prompt_len=cell["small_prompt"], tokens=8)
    del card_m, card
    free_card()


def serve_full(arch):
    """The model's main path at full width and depth, 4 requests and 32
    decoded tokens, after a 2-token warm-up; counts read around the
    measured run: one scan launch a recurrent layer in the prefill, none
    in decode, no other kernel."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import make_model, param_count
    cell = SERVED[arch]
    kname = cell["kernel"]
    cfg = get_config(arch)
    n_rec = recurrent_layers(cfg, cell["kind"])
    free_card()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = make_model(cfg, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = param_count(model)
    check(n_params == cell["params"] and model.embed.dtype == torch.bfloat16,
          f"{arch} has {n_params} parameters")
    run = dict(batch=4, prompt_len=cell["prompt_len"])
    serve(model, tokens=2, **run)                          # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out = serve(model, tokens=32, keep_logits=True, **run)
    counts = kernels.launch_counts()
    check(out.prefill_launches[kname] == n_rec
          and sum(out.decode_launches.values()) == 0
          and counts[kname] == n_rec and sum(counts.values()) == n_rec,
          f"full {arch} serve launches: prefill {out.prefill_launches}, "
          f"decode {out.decode_launches}")
    check(out.generated.shape == (4, 33)
          and bool(((out.generated >= 0)
                    & (out.generated < cfg.vocab_size)).all())
          and bool(torch.isfinite(out.prefill_logits).all())
          and bool(torch.isfinite(out.decode_logits).all()),
          f"full {arch} serve: logits not finite or tokens out of range")
    peak = torch.cuda.max_memory_allocated()
    emit(phase="main_path", run=f"{arch} serve", arch=arch,
         n_layers=cfg.n_layers, params=n_params, dtype="bfloat16",
         launches=counts, batch=4, prompt_len=cell["prompt_len"], tokens=32,
         init_s=init_s, prefill_s=out.prefill_s, decode_s=out.decode_s,
         prefill_tokens_per_s=out.prefill_tokens_per_s,
         decode_tokens_per_s=out.decode_tokens_per_s,
         peak_memory_gb=peak / 1e9,
         first_tokens=out.generated[0, :8].tolist())
    del model, out
    free_card()
    return counts


# ------------------------------------------------ the FL-LM train slice

TINYLLAMA = "tinyllama-1.1b"
TINYLLAMA_PARAMS = 1_100_048_384
QUANT_SOURCE = "src/repro_torch/kernels/csrc/dithered_quant.cu"
TRAIN_RUN = dict(batch=8, seq=128, n_clients=4)


def whole_quant_case(shape, dt, levels, seed, zero=False, timed=False):
    """Kernel 3 (the whole-tensor quantizer) against its plain version,
    bit-equal; timed at the main path's largest leaf."""
    import torch
    from repro_torch.kernels import dithered_quantize, ref
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = torch.randn(shape, generator=gen, device="cuda", dtype=dt) * 3.0
    if zero:
        g.zero_()
    u = torch.rand(shape, generator=gen, device="cuda")
    m = g.abs().amax()
    lv = torch.tensor(float(levels), dtype=dt, device="cuda")
    scal = torch.stack([m, lv])
    out = dithered_quantize(g, u, scal)
    plain = ref.dithered_quantize_ref(g, u, m, lv)
    torch.cuda.synchronize()
    err = float((out - plain).abs().max())
    check(out.shape == g.shape and torch.equal(out, plain),
          f"dithered_quantize != plain at {list(shape)} {dt} L={levels}: "
          f"max err {err}")
    live = bool(m > 0) and levels > 0
    check(live or not bool(out.any()), "degenerate tensor must give 0")
    n = g.numel()
    s = g.element_size()
    nbytes = n * ((s + 4) if live else 0) + n * s + 2 * s
    row = dict(shape=list(shape), dtype=str(dt).split(".")[1],
               levels=levels, max_abs_err=err, ms=None, plain_ms=None,
               library_ms=None, bound_ms=None, bound_by=None)
    if timed:
        iters = 4 if nbytes > 64e6 else 50
        row["ms"] = device_ms(lambda: dithered_quantize(g, u, scal), iters)
        row["plain_ms"] = device_ms(
            lambda: ref.dithered_quantize_ref(g, u, m, lv), iters)
    row["bound_ms"], row["bound_by"] = bound(
        nbytes, 10 * n if live else 0, str(dt).split(".")[1])
    return row


def whole_quant_beyond_2_31():
    """Kernel 3 on one tensor of 2^31 + 4097 f32 entries (int64 indexing),
    checked against the plain version on three slices with the tensor's
    own (m, L) (the quantizer is elementwise given them)."""
    import torch
    from repro_torch.kernels import dithered_quantize, ref
    n = (1 << 31) + 4097
    gen = torch.Generator(device="cuda").manual_seed(31)
    g = torch.randn(n, generator=gen, device="cuda")
    u = torch.rand(n, generator=gen, device="cuda")
    scal = torch.stack([g.abs().amax(), torch.tensor(255.0, device="cuda")])
    out = dithered_quantize(g, u, scal)
    worst = 0.0
    for lo in (0, n // 2 - 777, n - (1 << 20)):
        sl = slice(lo, lo + (1 << 20))
        plain = ref.dithered_quantize_ref(g[sl], u[sl], scal[0], scal[1])
        worst = max(worst, float((out[sl] - plain).abs().max()))
        check(torch.equal(out[sl], plain),
              f"dithered_quantize beyond 2^31: slice at {lo} differs")
    emit(phase="kernel", kernel="dithered_quantize", shape=[n],
         dtype="float32", levels=255.0, max_abs_err=worst,
         checked="three slices of 2^20 entries")
    del g, u, out
    free_card()
    return worst


OTA_SOURCE = "src/repro_torch/kernels/csrc/ota_combine.cu"
KEYED_NOISE_SCALE = 1e-2


def keyed_inputs(shape, dt, seed):
    """The keyed epilogue's inputs: g made on the card from a seed, the
    host-made inv_alpha (1/2.5 in f32, then g's dtype, as ``ops.
    ota_combine`` makes it) and a threefry leaf key."""
    import torch
    from repro_torch.core import rngstream
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = torch.randn(shape, generator=gen, device="cuda", dtype=dt)
    inv = float((1.0 / torch.tensor(2.5, dtype=torch.float32)).to(dt))
    key = rngstream.split(rngstream.prng_key(seed), 12)[seed % 12]
    return g, inv, key


def keyed_case(shape, dt, seed, scale=KEYED_NOISE_SCALE, timed=False):
    """Kernel 1's keyed entry (normals drawn in the kernel) against its
    plain version (``rngstream.normal`` on the card, then the epilogue),
    bit-equal as integers; with ``scale`` 0, also exactly g * inv_alpha.
    Timed at the train path's largest leaf."""
    import torch
    from repro_torch.kernels import ota_combine_keyed, ref
    g, inv, key = keyed_inputs(shape, dt, seed)
    out = ota_combine_keyed(g, inv, scale, key)
    plain = ref.ota_combine_keyed_ref(g, inv, scale, key)
    torch.cuda.synchronize()
    err = float((out - plain).abs().max())
    check(out.shape == g.shape and same_bits(out, plain),
          f"ota_combine_keyed != plain at {list(shape)} {dt}: max err {err}")
    check(bool(torch.isfinite(out).all()),
          f"ota_combine_keyed not finite at {list(shape)}")
    if scale == 0:
        check(same_bits(out, g * inv), "ota_combine_keyed with no noise is "
                                       "not g * inv_alpha")
    del plain
    n = g.numel()
    row = dict(shape=list(shape), dtype=str(dt).split(".")[1], n=n,
               scale=scale, max_abs_err=err, ms=None, plain_ms=None,
               library_ms=None, bound_by="bytes")
    # the bytes alone; the main case's bound takes the larger of this and
    # the integer pipe's floor (keyed_floor)
    row["bytes_ms"], _ = bound(2 * n * g.element_size(), 0, "float32")
    row["bound_ms"] = row["bytes_ms"]
    if timed:
        row["ms"] = device_ms(
            lambda: ota_combine_keyed(g, inv, scale, key),
            5 if n > (1 << 24) else 50)
        row["plain_ms"] = event_ms(
            lambda: ref.ota_combine_keyed_ref(g, inv, scale, key), 3)
    del g, out
    free_card()
    return row


INT32_LANES_AN_SM = 64   # 32-bit integer add, logic and shift results a
                         # clock an SM (CUDA C++ Programming Guide,
                         # arithmetic instruction throughput, cc 9.0)
# 32-bit integer operations one counter's normal needs: threefry2x32's two
# initial key adds, 20 rounds of add, rotate and xor, 5 key injections of
# two adds (the round number folded into the key word), and the xor, shift
# and or that make the uniform's bits
THREEFRY_INT_OPS = 2 + 20 * 3 + 5 * 2 + 3


def keyed_floor(row) -> dict:
    """The keyed entry's floor at ``row``'s case (f32): THREEFRY_INT_OPS an
    entry over the 32-bit integer pipe's 64 lanes on every SM, at the SM
    clock read while it runs and at the card's maximum SM clock (the
    bound). Beside it, from the SASS of the f32 kernel's grid-stride loop
    (cuobjdump; "not measured" where the toolkit has none), the
    instructions an entry over the loop's whole span and their opcodes: a
    count of what the compiler emitted, both of erfinv's branches (the
    rarer taken by 0.7% of entries) and the register moves included, not
    of what issues."""
    import re
    import shutil
    import torch
    from repro_torch.kernels import build, ota_combine_keyed
    sass = "not measured"
    tool = shutil.which("cuobjdump") or str(
        Path(build._nvcc()).parent / "cuobjdump")
    if Path(tool).exists():
        out = subprocess.run(
            [tool, "-sass", str(build._target("ota_combine")[1])],
            capture_output=True, text=True, timeout=120)
        check(out.returncode == 0, f"cuobjdump failed: {out.stderr.strip()}")
        found = [part for part in out.stdout.split("Function : ")[1:]
                 if "ota_combine_keyed_kernelIfLi4E"
                 in part.split(None, 1)[0]]
        check(len(found) == 1, f"{len(found)} SASS functions match the "
                               f"keyed f32 kernel")
        ins = [(int(m[1], 16), m[2]) for m in
               re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", found[0])]
        back = [(int(m[3], 16), a) for a, text in ins
                for m in [re.match(SASS_BRANCH, text)]
                if m and m[3] and int(m[3], 16) < a]
        lo, hi = max(back, key=lambda span: span[1] - span[0])
        opcodes = {}
        for a, text in ins:
            if lo <= a <= hi:
                op = re.sub(r"^@!?U?P\w+\s+", "", text).split()[0]
                op = op.split(".")[0]
                opcodes[op] = opcodes.get(op, 0) + 0.25   # 4 entries a loop
        sass = dict(instructions_an_entry=sum(opcodes.values()),
                    opcodes_an_entry=dict(sorted(opcodes.items(),
                                                 key=lambda kv: -kv[1])))
    g, inv, key = keyed_inputs(row["shape"], torch.float32, seed=7)
    clock = sm_clock_under(
        lambda: ota_combine_keyed(g, inv, KEYED_NOISE_SCALE, key), 800)
    del g
    free_card()
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def floor(mhz):
        return (row["n"] * THREEFRY_INT_OPS
                / (INT32_LANES_AN_SM * sms * mhz * 1e6) * 1e3)
    floor_ms = floor(float(clock["clocks_sm"].split()[0]))
    return dict(shape=row["shape"], ms=row["ms"], sms=sms, **clock,
                int_ops_an_entry=THREEFRY_INT_OPS, floor_ms=floor_ms,
                floor_ms_at_max_clock=floor(
                    float(clock["clocks_max_sm"].split()[0])),
                bytes_ms=row["bytes_ms"], share_of_floor=floor_ms / row["ms"],
                sass=sass)


def keyed_beyond_2_31():
    """The keyed entry on one tensor of 2^31 + 4097 f32 entries (int64
    counters, hi word 0 and then 1), bit-equal to the plain version over
    the whole tensor."""
    import torch
    from repro_torch.kernels import ota_combine_keyed, ref
    n = (1 << 31) + 4097
    g, inv, key = keyed_inputs((n,), torch.float32, seed=31)
    out = ota_combine_keyed(g, inv, KEYED_NOISE_SCALE, key)
    plain = ref.ota_combine_keyed_ref(g, inv, KEYED_NOISE_SCALE, key)
    torch.cuda.synchronize()
    err = float((out - plain).abs().max())
    check(same_bits(out, plain),
          f"ota_combine_keyed beyond 2^31 differs: max err {err}")
    emit(phase="kernel", kernel="ota_combine_keyed", shape=[n],
         dtype="float32", scale=KEYED_NOISE_SCALE, max_abs_err=err,
         checked="the whole tensor")
    del g, out, plain
    free_card()
    return err


def client_grads(model, tokens, n_clients):
    """Each client's gradient leaves (the reference's stacked leaves) for
    one batch, computed once."""
    from repro_torch import interop
    from repro_torch.models import loss_fn
    leaves = interop.reference_leaves(model)
    rows = tokens.shape[0] // n_clients
    out = []
    for m in range(n_clients):
        model.zero_grad(set_to_none=True)
        loss, _ = loss_fn(model, {"tokens": tokens[m * rows:(m + 1) * rows]})
        loss.backward()
        out.append([leaf.value(lambda p: p.grad) for leaf in leaves])
    model.zero_grad(set_to_none=True)
    return out


def psum_kernel_vs_plain():
    """wireless_psum at tinyllama's full width cut to 2 layers (bf16): the
    kernel route and the plain route on the same per-client gradients
    (the embedding's backward accumulates in no fixed order on the card,
    so the gradients are computed once), bit-equal in every mode; one
    epilogue launch a leaf (OTA), one quantizer launch a client and leaf
    (digital)."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core import rngstream
    from repro_torch.core.collectives import WirelessRound, wireless_psum
    from repro_torch.models import make_model
    cfg = dataclasses.replace(get_config(TINYLLAMA), n_layers=2)
    model = make_model(cfg, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (8, 128), generator=gen,
                           device="cuda")
    grads = client_grads(model, tokens, 4)
    rnd = WirelessRound(weight=torch.tensor([0.5, 0.0, 1.5, 1.0]),
                        alpha=torch.tensor(2.5),
                        noise_scale=torch.tensor(1e-3),
                        levels=torch.tensor([255.0, 15.0, 0.0, 65535.0]))
    key = rngstream.prng_key(3)
    n_leaves = len(grads[0])
    result = {}
    for mode, want in (("ideal", {}),
                       ("ota", {"ota_combine_keyed": n_leaves}),
                       ("digital", {"dithered_quantize": 4 * n_leaves})):
        kernels.reset_launch_counts()
        kern = wireless_psum(grads, rnd, key, mode=mode)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        plain = wireless_psum(grads, rnd, key, mode=mode, use_kernel=False)
        after = kernels.launch_counts()
        check(all(counts[k] == want.get(k, 0) for k in counts)
              and after == counts,
              f"wireless_psum {mode} launches {counts}, then {after}")
        diff = max(float((a.float() - b.float()).abs().max())
                   for a, b in zip(kern, plain))
        check(all(a.dtype == torch.bfloat16 and torch.equal(a, b)
                  for a, b in zip(kern, plain)),
              f"wireless_psum {mode}: kernel and plain differ by {diff}")
        check(all(bool(torch.isfinite(a).all()) for a in kern),
              f"wireless_psum {mode}: not finite")
        result[mode] = counts
    emit(phase="psum_kernel_vs_plain", arch=TINYLLAMA, n_layers=2,
         clients=4, leaves=n_leaves, dtype="bfloat16", bit_equal=True,
         launches={m: {k: v for k, v in c.items() if v}
                   for m, c in result.items()})
    del model, grads
    free_card()


def train_small_vs_cpu():
    """tinyllama's ``scaled_down()`` (f32) trained 3 steps on the card and
    on the CPU from the same weights and batches, each aggregator: losses
    within rtol 1e-4, parameters within 1e-4 of the largest magnitude
    (digital: at most 0.1% of entries beyond, none beyond 1e-2: a gradient
    gap of an ulp can flip a code at the dither floor)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train
    from repro_torch.models import make_model
    small = get_config(TINYLLAMA).scaled_down()
    cpu0 = make_model(small, seed=0, device="cpu").state_dict()
    run = dict(steps=3, batch=8, seq=32, n_clients=4, eta=0.5,
               log=lambda s: None)
    for agg in ("ideal", "ota", "digital"):
        cpu_m = make_model(small, seed=None, device="cpu")
        cpu_m.load_state_dict(cpu0)
        card_m = make_model(small, seed=None)
        card_m.load_state_dict(cpu0)
        cpu = train(cpu_m, aggregator=agg, **run)
        card = train(card_m, aggregator=agg, **run)
        want = 3 * {"ideal": 0, "ota": 12, "digital": 48}[agg]
        got = sum(c["ota_combine_keyed"] + c["dithered_quantize"]
                  for c in card.launches)
        check(got == want, f"scaled-down {agg}: {got} launches, not {want}")
        rel = max(abs(a / b - 1) for a, b in zip(card.losses, cpu.losses))
        gaps = torch.cat([(a.cpu() - b).abs().reshape(-1) for a, b in zip(
            card_m.state_dict().values(), cpu_m.state_dict().values())])
        scale = max(float(b.abs().max()) for b in cpu_m.state_dict().values())
        over = float((gaps > 1e-4 * scale).float().mean())
        top = float(gaps.max()) / scale
        check(rel <= 1e-4 and top <= (1e-2 if agg == "digital" else 1e-4)
              and over <= (1e-3 if agg == "digital" else 0.0),
              f"scaled-down {agg}: card vs CPU loss {rel}, parameters "
              f"{top} of the largest ({over} of entries beyond 1e-4)")
        emit(phase="train_small_vs_cpu", arch=small.name, aggregator=agg,
             steps=3, max_rel_loss_diff=rel, max_param_gap=top,
             share_beyond_1e_4=over, loss_card=card.losses,
             loss_cpu=cpu.losses)
        del card_m
    free_card()


def train_full():
    """The slice's main path: tinyllama-1.1b at full width and depth (bf16,
    random weights from seed 0), 3 FL steps of 8 x 128 tokens over 4
    clients under each aggregator through the launcher's ``train``; counts
    read around each run."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train
    from repro_torch.models import make_model, param_count
    sys.path.insert(0, str(ROOT / "scripts"))
    from profile_port import profiled
    cfg = get_config(TINYLLAMA)
    per_step = {"ideal": {}, "ota": {"ota_combine_keyed": 12},
                "digital": {"dithered_quantize": 48}}
    total = {}
    for agg in ("ideal", "ota", "digital"):
        free_card()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = make_model(cfg, seed=0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = param_count(model)
        check(n_params == TINYLLAMA_PARAMS
              and all(p.dtype == torch.bfloat16 for p in model.parameters()),
              f"tinyllama-1.1b has {n_params} parameters")
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        log = train(model, aggregator=agg, steps=3, log=lambda s: None,
                    **TRAIN_RUN)
        seconds = time.perf_counter() - t0
        counts = kernels.launch_counts()
        for step_counts in log.launches:
            check(step_counts == {k: per_step[agg].get(k, 0)
                                  for k in step_counts},
                  f"tinyllama {agg}: step launches {step_counts}")
        check(counts == {k: 3 * per_step[agg].get(k, 0) for k in counts},
              f"tinyllama {agg}: launches {counts}")
        check(all(np.isfinite(log.losses)),
              f"tinyllama {agg}: losses {log.losses}")
        check(all(bool(torch.isfinite(p).all()) for p in model.parameters()),
              f"tinyllama {agg}: parameters not finite")
        # one more step under the profiler, after the counts were read:
        # every launch on the card and its device time, a step
        by_family, step_launches, busy_us, prof_wall = profiled(
            lambda: train(model, aggregator=agg, steps=1, log=lambda s: None,
                          **TRAIN_RUN))
        tokens = TRAIN_RUN["batch"] * TRAIN_RUN["seq"]
        emit(phase="main_path", run=f"tinyllama-1.1b train {agg}",
             arch=TINYLLAMA, n_layers=cfg.n_layers, params=n_params,
             dtype="bfloat16", aggregator=agg, clients=4, steps=3,
             batch=8, seq=128, launches=counts, loss=log.losses,
             step_s=log.step_s, seconds=seconds, init_s=init_s,
             steps_per_s=3 / sum(log.step_s),
             tokens_per_s=3 * tokens / sum(log.step_s),
             steady_steps_per_s=2 / sum(log.step_s[1:]),
             steady_tokens_per_s=2 * tokens / sum(log.step_s[1:]),
             step_launches_profiled=step_launches,
             step_device_ms_profiled=busy_us / 1e3,
             step_wall_ms_profiled=prof_wall * 1e3,
             step_device_ms_by_family={k: v / 1e3 for k, v in sorted(
                 by_family.items(), key=lambda kv: -kv[1])},
             peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        del model
    free_card()
    return total


def main() -> int:
    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found next to this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card "
              "and has no CPU path", file=sys.stderr)
        return 2
    from repro_torch import resolve_device
    from repro_torch.core import baselines as B
    from repro_torch.fl import FLEngine, FLTrainer
    from repro_torch.kernels import build
    t_start = time.perf_counter()

    # 1. device
    resolve_device()
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    emit(phase="device", name=name, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build
    t0 = time.perf_counter()
    logs = build.build()
    ptxas = {k: [ln.strip() for ln in v.splitlines()
                 if "registers" in ln or "spill" in ln]
             for k, v in logs.items()}
    emit(phase="build", seconds=time.perf_counter() - t0, ptxas=ptxas,
         kernels=["ota_combine", "dithered_quantize_rows",
                  "quantize_pack_rows", "unpack_dequant_rows",
                  "packed_weighted_sum", "row_maxabs_sumsq",
                  "selective_scan", "dithered_quantize", "linear_scan",
                  "ota_combine_keyed"])
    # the scans' full tiles in SASS: instructions per (b, t, d, j) of the
    # selective scan at n = 16 (one MUFU.EX2 each) in the body of each of
    # its warps' roles (first, middle, last), per step and channel of the
    # linear scan (one store each)
    sass = dict(
        selective_scan=sass_bodies(build._target("selective_scan")[1],
                                   "selective_scan_kernelILi16E", "MUFU.EX2"),
        linear_scan=sass_bodies(build._target("linear_scan")[1],
                                "linear_scan_kernel", "STG"),
        packed_weighted_sum=sass_bodies(
            build._target("payload")[1],
            "packed_weighted_sum_kernelIdLi8ELb1E", "DMUL"))
    emit(phase="sass", **sass)

    # 3. kernels against their plain versions
    f64, f32, bf16 = torch.float64, torch.float32, torch.bfloat16
    ota_rows, quant_rows = {}, {}
    for shape in ((4, 7850), (4, 147994), (4, 1 << 24)):
        for gdt in (f64, f32, bf16):
            r = ota_case(*shape, gdt, seed=shape[1] % 97)
            emit(phase="kernel", kernel="ota_combine", **r)
            ota_rows[(shape, gdt)] = r
    # the least time one launch takes in this harness: ota_combine on
    # (1, 2) f64, 48 bytes
    emit(phase="launch_floor", kernel="ota_combine", shape=[1, 2],
         dtype="float64", **ota_launch_floor())
    # the two-step quantizer: the main path (40, 7850) and Fig. 2 OTA's
    # width at 50 rows, a large case, rows crossing its 2-entry vectors
    # mid-row (d odd: 1001 and 1003, 1 and 3 mod 4; d = 3), g and u as
    # views off a vector's boundary (offset 1, d odd: entry by entry) and
    # as views that stay on one (d = 1002)
    for shape, offset in (((40, 7850), 0), ((50, 7850), 0),
                          ((64, 1 << 20), 0), ((5, 1001), 0),
                          ((7, 1003), 0), ((9, 3), 0), ((40, 7851), 1),
                          ((5, 1001), 1), ((5, 1002), 1)):
        for dt in (f64, f32):
            r = quant_case(*shape, dt, seed=shape[0], offset=offset)
            emit(phase="kernel", kernel="dithered_quantize_rows", **r)
            quant_rows[(shape, dt, offset)] = r
    # the payload kernels: the Fig. 3 main path (4 trials x 10 devices,
    # f64, 8-bit codes), the other code widths, the payload benchmark's
    # case (BENCH_kernel_payload.json: 256 devices x 10^6, f32), and
    # ragged widths
    # and the weighted sum's edges: Fig. 3 Best Channel's pattern (6 of 10
    # devices a trial out of the round), a trial of silent devices only,
    # 300 devices a trial (five staging chunks, past any prefetch depth),
    # and words read from a view off an 8-byte boundary
    payload_rows = {}
    for rows, d, dt, cb, trials, silent, misaligned, timed in (
            (40, 147994, f64, 8, 4, "one", False, True),
            (40, 147994, f32, 8, 4, "one", False, True),
            (40, 147994, f64, 4, 4, "one", False, True),
            (40, 147994, f64, 16, 4, "one", False, True),
            (256, 1000000, f32, 8, 1, "one", False, True),
            (6, 1000, f64, 8, 2, "one", False, True),
            (6, 1000, f32, 16, 2, "one", False, True),
            (4, 131073, f64, 8, 2, "one", False, True),
            (4, 131073, f32, 4, 2, "one", False, True),
            (40, 147994, f64, 8, 4, "best_channel", False, True),
            (30, 3001, f64, 8, 3, "trial", False, False),
            (30, 3001, f32, 4, 3, "trial", False, False),
            (600, 1000, f64, 8, 2, "one", False, False),
            (600, 1003, f32, 16, 2, "best_channel", False, False),
            (40, 147994, f64, 8, 4, "one", True, False),
            (6, 1001, f32, 4, 2, "one", True, False)):
        rs = payload_case(rows, d, dt, cb, seed=d + cb, trials=trials,
                          silent=silent, misaligned=misaligned, timed=timed)
        for kname, r in rs.items():
            emit(phase="kernel", kernel=kname, **r)
            payload_rows.setdefault(kname, {})[
                (rows, d, dt, cb, silent, misaligned)] = r

    # the per-row statistics: the digital suite's main path (Best
    # Channel-Norm over 4 trials x 10 devices at d = 7850, f64), Fig. 3's
    # width, the payload benchmark's case in f32 and bf16, ragged widths
    # (timed); the edges of the cluster's partition: d below one vector a
    # chunk (1, 7, 15 in f64), either side of rows that fill their 8
    # chunks (C L = 7856 in f64, 7872 in f32), rows off a 16-byte
    # boundary (entry by entry), 70,000 rows (past the grid's y limit, the
    # rows on x), and a row with a NaN entry
    reduce_rows = {}
    for rows, d, dt, timed, nan in (
            (40, 7850, f64, True, False), (40, 147994, f64, True, False),
            (256, 1000000, f32, True, False),
            (256, 1000000, bf16, True, False), (5, 1, f64, True, False),
            (5, 1001, f32, True, False), (5, 1001, bf16, True, False),
            (5, 7, f64, False, False), (5, 15, f64, False, False),
            (5, 7855, f64, False, False), (5, 7857, f64, False, False),
            (5, 7871, f32, False, False), (5, 7873, f32, False, False),
            (40, 7851, f64, False, False), (5, 1003, bf16, False, False),
            (70000, 33, f32, False, False), (70000, 7, f64, False, False),
            (40, 7850, f64, False, True), (5, 1001, f32, False, True),
            (5, 1003, bf16, False, True)):
        r = reduce_case(rows, d, dt, seed=d % 89, timed=timed, nan=nan)
        emit(phase="kernel", kernel="row_maxabs_sumsq", **r)
        reduce_rows[(rows, d, dt, nan)] = r

    # the selective scan: falcon-mamba's prefill (4 x 512 tokens, d_inner
    # 8192, n 16) and the batch-1 long prompt (timed); the reference
    # test's shapes, ragged S and D, n 4/8/16, one step; the edges of the
    # kernel's partitions: n not divisible by its 4 warps (1, 5, 13),
    # D = 33, S = 1, 7 and 9 (either side of its 8-step tile), 17 and 33
    scan_rows = {}
    for shape, timed in (((4, 512, 8192, 16), True),
                         ((1, 4096, 8192, 16), True),
                         ((1, 128, 128, 8), True), ((2, 300, 200, 16), True),
                         ((2, 64, 100, 4), True), ((1, 37, 129, 16), True),
                         ((2, 300, 129, 8), True), ((1, 1, 8192, 16), True),
                         ((2, 300, 129, 1), False), ((2, 300, 129, 5), False),
                         ((2, 300, 129, 13), False), ((2, 64, 33, 16), False),
                         ((2, 1, 33, 5), False), ((2, 7, 100, 16), False),
                         ((2, 9, 100, 16), False), ((1, 9, 33, 13), False),
                         ((1, 17, 33, 5), False), ((2, 33, 33, 16), False)):
        r = scan_case(*shape, seed=sum(shape), timed=timed)
        emit(phase="kernel", kernel="selective_scan", **r)
        scan_rows[shape] = r
    emit(phase="issue_floor", kernel="packed_weighted_sum",
         **wsum_issue_floor(
             payload_rows["packed_weighted_sum"][
                 (40, 147994, f64, 8, "one", False)],
             sass["packed_weighted_sum"]))
    emit(phase="issue_floor", kernel="selective_scan",
         **issue_floor((4, 512, 8192, 16), scan_rows[(4, 512, 8192, 16)],
                       sass["selective_scan"]))
    free_card()

    # the linear scan: recurrentgemma-2b's prefill (4 x 2,560 tokens,
    # lru_width 2560), the reference test's shapes, identity dynamics, one
    # long sequence at batch 1 (timed); the edges of the kernel's ring at
    # D = 33: S = 1, and 31, 33 and 97 (either side of its 32-step tile,
    # one past three)
    lscan_rows = {}
    for shape, identity, timed in (
            ((4, 2560, 2560), False, True), ((1, 16, 8), False, True),
            ((2, 300, 200), False, True), ((3, 256, 128), False, True),
            ((2, 1024, 64), False, True), ((1, 37, 129), False, True),
            ((2, 512, 128), True, True), ((1, 8192, 2560), False, True),
            ((2, 1, 33), False, False), ((2, 31, 33), False, False),
            ((2, 33, 33), False, False), ((2, 97, 33), False, False)):
        r = lscan_case(*shape, seed=sum(shape), identity=identity,
                       timed=timed)
        emit(phase="kernel", kernel="linear_scan", **r)
        lscan_rows[shape + (identity,)] = r
    free_card()

    # the whole-tensor quantizer: tinyllama's largest stacked leaf (22
    # layers of w_gate, f32, 8-bit levels), ragged sizes in f32 and f64,
    # an all-zero tensor, levels 0, and a tensor of more than 2^31 entries
    quant3_rows = {}
    for shape, dt, levels, zero, timed in (
            ((22, 2048, 5632), f32, 255.0, False, True),
            ((1001,), f32, 15.0, False, False),
            ((3, 5, 7777), f64, 1023.0, False, False),
            ((4096, 1001), f32, 255.0, True, False),
            ((1 << 20,), f32, 0.0, False, False)):
        r = whole_quant_case(shape, dt, levels, seed=len(shape) + int(zero),
                             zero=zero, timed=timed)
        emit(phase="kernel", kernel="dithered_quantize", **r)
        quant3_rows[(shape, dt, levels)] = r
    whole_quant_beyond_2_31()
    free_card()

    # kernel 1's keyed entry (normals drawn in the kernel): tinyllama's
    # largest stacked leaf (22 layers of w_gate, f32, timed), one and three
    # entries, either side of the plain draw's 2^24-counter chunk, f64,
    # no noise (exactly g * inv_alpha), and a tensor of more than 2^31
    # entries
    keyed_rows = {}
    for shape, dt, scale, timed in (
            ((22, 2048, 5632), f32, KEYED_NOISE_SCALE, True),
            ((1,), f32, KEYED_NOISE_SCALE, False),
            ((3,), f32, KEYED_NOISE_SCALE, False),
            (((1 << 24) - 1,), f32, KEYED_NOISE_SCALE, False),
            (((1 << 24) + 1,), f32, KEYED_NOISE_SCALE, False),
            ((3, 5, 7777), f64, KEYED_NOISE_SCALE, True),
            ((4096, 1001), f32, 0.0, False)):
        r = keyed_case(shape, dt, seed=len(shape) + shape[-1] % 13,
                       scale=scale, timed=timed)
        emit(phase="kernel", kernel="ota_combine_keyed", **r)
        keyed_rows[(shape, dt, scale)] = r
    keyed_main = keyed_rows[((22, 2048, 5632), f32, KEYED_NOISE_SCALE)]
    floor = keyed_floor(keyed_main)
    emit(phase="issue_floor", kernel="ota_combine_keyed", **floor)
    if floor["floor_ms_at_max_clock"] > keyed_main["bytes_ms"]:
        keyed_main["bound_ms"], keyed_main["bound_by"] = (
            floor["floor_ms_at_max_clock"], "operations")
    keyed_beyond_2_31()

    # 4. the design solver on the card; Fig. 2's designs feed the main path
    ota_p, dig_p = design_phase()
    free_card()

    # 5. the main paths: Fig. 2 and Fig. 3 at full width
    launches = {}

    def main_run(*args, **kw):
        counts = run_path(*args, **kw)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    none = {"quantize_pack_rows": 0, "packed_weighted_sum": 0,
            "unpack_dequant_rows": 0, "row_maxabs_sumsq": 0,
            "selective_scan": 0, "dithered_quantize": 0, "linear_scan": 0,
            "ota_combine_keyed": 0}
    task, ds, dep, eta = fig2_setup(50, 6000)
    trainer = FLTrainer(task, ds, dep, eta)
    plain = FLEngine(task, ds, dep, eta, use_kernel=False)
    main_run("Fig. 2 ProposedOTA", trainer, plain,
             B.ProposedOTA(ota_p, label="Proposed OTA-FL (designed on the "
                                         "card)"),
             {"ota_combine": 30, "dithered_quantize_rows": 0, **none},
             rounds=30, trials=4, eval_every=10, seed=0)
    # Fig. 2's OTA suite: one epilogue a round each, nothing else
    cfg = dep.cfg
    consts = (task.dim, task.g_max, cfg.energy_per_symbol, cfg.noise_power)
    for agg in ota_suite(dep, consts):
        main_run(f"Fig. 2 {agg.name}", trainer, plain, agg,
                 {"ota_combine": 30, "dithered_quantize_rows": 0, **none},
                 must_fall=False, rounds=30, trials=4, eval_every=10, seed=0)
    del trainer, plain
    task, ds, dep, eta = fig2_setup(10, 1200)
    trainer = FLTrainer(task, ds, dep, eta)
    plain = FLEngine(task, ds, dep, eta, use_kernel=False)
    dig = B.ProposedDigital(dig_p, label="Proposed Digital FL (designed on "
                                         "the card)")
    main_run("Fig. 2 ProposedDigital", trainer, plain, dig,
             {"dithered_quantize_rows": 40, "ota_combine": 0, **none},
             rounds=40, trials=4, eval_every=20, seed=0,
             time_budget_s=150.0)
    # the same scheme under a budget that stops every trial by round 12
    # of 20 (a round takes ~0.16 s of simulated airtime on average)
    main_run("Fig. 2 ProposedDigital, budget", trainer, plain, dig,
             {"dithered_quantize_rows": 20, **none}, bites=True,
             rounds=20, trials=4, eval_every=4, seed=0, time_budget_s=1.0)
    # Fig. 2's digital suite under the figure's budget: one two-step
    # quantizer launch a round each; Best Channel-Norm scores its devices
    # with one row-statistics launch a round
    cfg = dep.cfg
    dconsts = (task.dim, task.g_max, cfg.energy_per_symbol, cfg.noise_power,
               cfg.bandwidth_hz)
    for agg in digital_suite(dep, dconsts):
        norm = isinstance(agg, B.BestChannelNorm)
        main_run(f"Fig. 2 {agg.name}", trainer, plain, agg,
                 {"dithered_quantize_rows": 40, "ota_combine": 0,
                  **none, "row_maxabs_sumsq": 40 if norm else 0},
                 bites=None, must_fall=False, rounds=40, trials=4,
                 eval_every=20, seed=0, time_budget_s=150.0)
    del trainer, plain
    task, ds, dep, eta, ota_p, dig_p = fig3_setup()
    trainer = FLTrainer(task, ds, dep, eta)
    plain = FLEngine(task, ds, dep, eta, use_kernel=False)
    main_run("Fig. 3 ProposedOTA", trainer, plain,
             B.ProposedOTA(ota_p, label="Proposed OTA-FL (min-noise "
                                         "anchor)"),
             {"ota_combine": 30, "dithered_quantize_rows": 0, **none},
             rounds=30, trials=4, eval_every=10, seed=9)
    # d = 147,994 >= 2^17 and 7-bit devices: the fused payload route
    main_run("Fig. 3 ProposedDigital", trainer, plain,
             B.ProposedDigital(dig_p, label="Proposed Digital FL (uniform "
                                            "anchor)"),
             {"quantize_pack_rows": 40, "packed_weighted_sum": 40,
              "dithered_quantize_rows": 0, "unpack_dequant_rows": 0,
              "ota_combine": 0, "row_maxabs_sumsq": 0,
              "dithered_quantize": 0, "ota_combine_keyed": 0},
             rounds=40, trials=4, eval_every=20, seed=9)
    # a baseline on the fused route: Best Channel's 6 bits pack as 8-bit
    # codes at d = 147,994
    cfg = dep.cfg
    main_run("Fig. 3 Best Channel", trainer, plain,
             B.BestChannel(dep, task.dim, task.g_max, cfg.energy_per_symbol,
                           cfg.noise_power, cfg.bandwidth_hz, k=4),
             {"quantize_pack_rows": 10, "packed_weighted_sum": 10,
              "dithered_quantize_rows": 0, "unpack_dequant_rows": 0,
              "ota_combine": 0, "row_maxabs_sumsq": 0,
              "dithered_quantize": 0, "ota_combine_keyed": 0},
             must_fall=False, rounds=10, trials=4, eval_every=5, seed=9)
    del trainer, plain
    dither_matches_cpu(4, 10, 7850, (0, 1, 39))
    dither_matches_cpu(4, 10, 147994, (0, 39))
    small_matches_cpu()
    fig3_matches_cpu()
    free_card()

    # 6. serve falcon-mamba-7b, then recurrentgemma-2b: the kernel against
    # its plain version at full width cut to one pattern, the card against
    # the CPU at the reduced sizes, then the main path at full width and
    # depth
    for arch in (MAMBA, RGEMMA):
        serve_kernel_vs_plain(arch)
        serve_small_vs_cpu(arch)
        for k, v in serve_full(arch).items():
            launches[k] = launches.get(k, 0) + v

    # 7. FL-LM training: the collective's kernel route against its plain
    # route at 2 layers of tinyllama's width, the scaled-down train step
    # on the card against the CPU, then the main path at full width and
    # depth
    psum_kernel_vs_plain()
    train_small_vs_cpu()
    for k, v in train_full().items():
        launches[k] = launches.get(k, 0) + v

    # 8. the kernel table at the main path's shapes and types (launches:
    # all main-path runs together; unpack_dequant_rows, the materializing
    # decoder, is on no engine path; row_maxabs_sumsq at Best
    # Channel-Norm's (4 trials x 10 devices, 7850) f64; selective_scan at
    # falcon-mamba-7b's prefill; dithered_quantize at tinyllama's largest
    # leaf; linear_scan at recurrentgemma-2b's prefill)
    main = (40, 147994, f64, 8, "one", False)
    table = []
    for kname, source, replaces, rows, row in (
            ("ota_combine", OTA_SOURCE,
             "src/repro/kernels/ota_combine.py:29", ota_rows,
             ota_rows[((4, 7850), f64)]),
            ("dithered_quantize_rows",
             "src/repro_torch/kernels/csrc/dithered_quant.cu",
             "src/repro/kernels/dithered_quant.py:67", quant_rows,
             quant_rows[((40, 7850), f64, 0)]),
            ("quantize_pack_rows", PAYLOAD_SOURCE,
             "src/repro/kernels/payload.py:159",
             payload_rows["quantize_pack_rows"],
             payload_rows["quantize_pack_rows"][main]),
            ("unpack_dequant_rows", PAYLOAD_SOURCE,
             "src/repro/kernels/payload.py:194",
             payload_rows["unpack_dequant_rows"],
             payload_rows["unpack_dequant_rows"][main]),
            ("packed_weighted_sum", PAYLOAD_SOURCE,
             "src/repro/kernels/payload.py:225",
             payload_rows["packed_weighted_sum"],
             payload_rows["packed_weighted_sum"][main]),
            ("row_maxabs_sumsq",
             "src/repro_torch/kernels/csrc/row_reduce.cu",
             "src/repro/kernels/row_reduce.py:50", reduce_rows,
             reduce_rows[(40, 7850, f64, False)]),
            ("selective_scan", SCAN_SOURCE,
             "src/repro/kernels/selective_scan.py:77", scan_rows,
             scan_rows[(4, 512, 8192, 16)]),
            ("dithered_quantize", QUANT_SOURCE,
             "src/repro/kernels/dithered_quant.py:43", quant3_rows,
             quant3_rows[((22, 2048, 5632), f32, 255.0)]),
            ("linear_scan", LSCAN_SOURCE,
             "src/repro/kernels/linear_scan.py:63", lscan_rows,
             lscan_rows[(4, 2560, 2560, False)]),
            ("ota_combine_keyed", OTA_SOURCE,
             "src/repro/kernels/ota_combine.py:29", keyed_rows, keyed_main)):
        table.append(dict(
            name=kname, route="cuda", source=source, replaces=replaces,
            launches=launches[kname],
            max_abs_err=max(r["max_abs_err"] for r in rows.values()),
            ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"], shape=row["shape"],
            dtype=row["dtype"]))
    emit(phase="done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": table}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
