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
   (N = 10, T_max = 0.2 s) at B = 1, cold (host clock to a
   synchronise), and ``benchmarks/design_bench.py``'s fig2-sized sweep
   (N = 50, a 4 x 4 (omega_var, omega_bias) grid, B = 16) for both
   families, warm, then the kernel launches and device ms of one more
   solve under ``torch.profiler`` (cut: the B = 1 solves are no longer
   timed warm and profiled, nor the sweep cold; a solve is launch-bound
   and takes as long at B = 1 as at B = 16, so one cold, one warm and one
   profiled solve a family remain); every case's objectives must agree
   with the same solve on the CPU within 1e-6 relative (the digital bits
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
6. scenario — the scenario layer (``repro_torch.api.execute``) on the
   card, at the figures' full width with the rounds cut:
   ``fig2_ota_sc(quick=False)`` at 30 rounds (kappa estimated on the
   card over 50,000 samples, one batched OTA design at N = 50 and the
   direct one, 9 schemes x (4 step-size probes + the 4-trial run)),
   ``fig2_digital_sc(quick=False)`` at 40 rounds (N = 10, 8 schemes,
   the 150 s budget) and ``fig3_nonconvex(quick=False)`` at 20 rounds
   (d = 147,994, 7 schemes): the seconds of kappa, of each design and of
   each scheme, the chosen eta and the final loss of each (finite, and
   falling for the proposed schemes), each scheme's launches exactly as
   its route makes them (the counts at 0 before each execute); each
   re-run into its directory comes back all cached, with no launch and
   the same manifest but for timings; ``sweep_smoke`` and a two-scheme
   Fig. 2 digital quick spec (kappa = 3) on the card against the CPU
   within the tests' tolerances; ``python -m repro_torch.api.cli run
   sweep_smoke`` on the card, then ``--expect-cached``, then ``--jobs 2
   --force`` with the serial manifest but for timings;
7. layers — the fault, partial-participation and buffered-async layers
   (``fl.engine``, plain torch on the card; no kernel of their own):
     (a) through ``FLTrainer`` at Fig. 2 / Fig. 3 full width, 4 trials:
     ProposedOTA (N = 50, 30 rounds, the design of phase 4) under the
     fault layer (dropout 0.2, erasure 0.05, stragglers 0.1 x 3, a
     deadline of twice a round's airtime) once for each ``on_missing``
     policy, under sampling of S = 16 (uniform, channel, and the
     probabilities ``solve_participation_batch`` designs on the card),
     under async with K = 4 (zero fill; "stale" on the weights
     ``solve_async_batch`` designs), all three stacked, and with every
     layer at its default, which must give phase 5's run bit for bit;
     ProposedDigital (N = 10, 40 rounds) under faults ("zero") and
     sampling (S = 6); Fig. 3 ProposedDigital (d = 147,994, the fused
     route, 20 rounds) under faults. Each run: launch counts exactly its
     route's (one ``ota_combine``, one ``dithered_quantize_rows``, or one
     ``quantize_pack_rows`` and one ``packed_weighted_sum`` a round,
     nothing else), the plain versions' trajectory to the bit, the CPU
     run within 1e-5 (OTA) or 1e-3 and the 4-sigma gate (digital; Fig.
     3's over 2 trials of 6 rounds), launches and host ms per round, and
     from a profiled run every launch and the device ms per round; the
     layers' uniforms for a whole run made on the card equal the CPU's
     to the bit;
     (b) ``sweep_fault`` (1 of its 9 cells: dropout 0.5 at the base's
     path loss), ``sweep_participation`` (2 of its 8: S = 16 under the
     uniform and the designed policy, N left at the base's 50) and
     ``sweep_async`` (its base cell alone of 27: K = 4, rate spread 3.0,
     discount 0.8, since each cell's designed weights take a co-design
     solve of 9-17 s on the card) at ``quick=False`` widths
     (``SWEEP_AXES``: one cell per distinct route), 20 of 100 rounds,
     through ``execute``: the seconds of data + kappa, of each
     design group and of the schemes; each scheme's launches exactly as derived
     (the counts at 0 before each execute); finite losses, and Proposed
     OTA's falling in each cell or, where the step-size search lets it
     rise, the same cell on the CPU rising with it within 1e-5; each
     re-run all cached, with no launch and the same manifest but for
     timings; then ``python -m repro_torch.api.cli run SPEC.json --jobs
     4`` once, SPEC the quick ``sweep_async`` cut to its buffer axis (2 of
     its 8 cells, one a worker);
8. mini-batches and ``rng="fast"`` (``fl.engine``, plain torch streams
   on the card; no kernel of their own):
     (c) ``rng="fast"`` through ``FLTrainer``, Fig. 2 ProposedOTA (N =
     50, 30 rounds) and ProposedDigital, UQOS, QML and FedTOE (N = 10, 40
     rounds, the 150 s budget), each checked as a phase 7 run (launches
     exactly its route's, plain bit-equal, the CPU within 1e-5 or 1e-3
     and the 4-sigma gate), its host ms, launches and device idle a
     round beside the same run in replay mode;
     (a) the streams made on the card against the CPU's: Fig. 2's (4
     trials, 10 rounds, 50 devices, B) batch blocks for B = 16, 64, 256,
     an n = 1626 block (two sorts), ragged and mixed rows and the fast
     selection rows of UQOS, QML and FedTOE bit for bit; the fast PS
     AWGN, f64 normals and fast |h| within the tests' 3 and 8 ulps;
     (b) ``fig2_batch(quick=False)`` (N = 50, 1000 samples a device, B
     = 16 of its 16, 64, 256 and full: the mini-batch route once, its
     full batch being phase 6's ``fig2_ota_sc`` run; 9 schemes) through
     ``execute`` cut to 20 rounds (30 before, cut for the time limit), as
     a phase 7 sweep (seconds of kappa,
     design and schemes,
     one ``ota_combine`` a round per OTA scheme and nothing else, the
     cached re-run), then the same sweep cut to Proposed OTA at kappa 3
     on the card against the CPU within 1e-5;
9. serve (``repro_torch.launch.serve.serve``), random weights from a
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
   then the MoE models and the chunked (online-softmax) attention, which
   launch no kernel (their reference is jnp code, not Pallas):
     "moe_small_vs_cpu": qwen3-moe-30b-a3b and kimi-k2-1t-a32b at their
     ``scaled_down()`` sizes (f32), 4 x 64 prompt tokens (T·k = 512 > 256:
     the capacity path) and 8 fed decode tokens, on the card against the
     CPU within 1e-4, with each layer's kept and dropped (token, expert)
     assignments on both;
     "chunked_vs_einsum": the two attention routes fed the same tokens,
     qwen3-moe at full width cut to 2 layers in f32 (4 x 512, 8 decoded)
     and gemma3-4b scaled down (4 x 600: two key chunks, the local rows'
     first masked whole), logits within 1e-4 of the largest magnitude;
     the main path "qwen3-moe-30b-a3b serve" at full width and depth (48
     layers, d_model 2048, 32 heads / 4 KV heads of 128, qk_norm, 128
     experts top-8 of d_ff 768, vocab 151,936; 30,532,122,624 bf16
     parameters, 3,353,032,704 active), 4 x 512 prompt tokens and 32
     decoded on the einsum route after a 2-token warm-up, and
     "qwen3-moe-30b-a3b long prompt", 1 x 32,768 (prefill_32k's length,
     its batch cut to 1) on the chunked route and 2 decoded, through the
     first 16 of the 48 layers with all 48 on the card (cut from 48
     layers and 8 decoded, for the time limit: the prefill took 34.7 s
     and a decode step 1.6 s at full depth): no kernel
     launch, finite logits, tokens in range, at 4 x 512 the prefill run
     again giving the same bits; init seconds, tokens/s, peak memory, the
     experts layer 0 routed to, the share of assignments capacity
     dropped and the largest hidden magnitude after the last layer (at
     4 x 512 recorded in the repeated prefill, at 32,768 in the run);
   then the audio and VLM front ends, which launch no kernel either
   (their reference is jnp code):
     the main paths "whisper-tiny serve" (4 encoder and 4 decoder
     layers, d_model 384, 6 heads of 64, d_ff 1536, vocab 51,865;
     61,074,432 bf16 parameters, random; 4 requests of frames (1500,
     384) and 416 prompt tokens, 32 decoded, which reach position 447,
     the decoder's 448 limit) and "internvl2-2b serve" (24 layers,
     d_model 2048, 16 heads / 8 KV heads of 128, d_ff 8192, vocab
     92,553; 1,889,146,880 bf16 parameters; 4 x (256 patches + 256 text
     tokens), 32 decoded) after a 2-token warm-up: no kernel launch,
     finite logits, tokens in range, the decode after the prefix, the
     prefill run again giving the same bits; tokens/s and peak memory;
     "whisper-tiny vs cpu": the same model at full width in f32 on 2 x
     (1500 frames, 64 tokens) and 8 fed decode tokens, within 1e-4 of
     the CPU run's largest logit; "front_ends_small_vs_cpu":
     internvl2-2b at its ``scaled_down()`` sizes, 4 x (8 patches + 56
     tokens) and 8 decoded, the same;
10. FL-LM training (``repro_torch.launch.train``, the wireless collective
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
     every launch on the card and the device time a step, read from the
     profiler's raw events; these train steps, whisper-tiny's below and
     every loss the tests take run with layer-group remat on, as the
     reference's do;
   then whisper-tiny (the audio front end: 27 reference leaves, the
   encoder's and the cross blocks' among them), random weights:
     at full width and depth (bf16), the collective's kernel route
     against its plain route on the same per-client gradients of 8 x 128
     tokens with their frames, bit-equal in the three modes;
     the main path "whisper-tiny train ideal|ota|digital" through
     ``make_train_step`` (the text-only launcher refuses the front ends,
     as the reference's does), 3 steps of 8 x 128 decoder tokens with
     frames (8, 1500, 384) over 4 clients, the rounds made as the
     launcher makes them: exactly 27 ``ota_combine_keyed`` a step on OTA
     and 108 ``dithered_quantize`` on digital, nothing else; finite
     losses and parameters; steps/s, tokens/s and peak memory;
     "optim_vs_cpu": 3 Adam steps (weight decay 0.01) on its bf16
     parameters from one loss's gradients, on the card against the CPU,
     bit-equal, then the projection onto the ball of radius 10: the
     scale within 16 ulps (f32 reductions in other orders), parameters
     within 1 bf16 ulp;
11. layer-group rematerialisation and the three dense archs at full size
   (bf16, random weights from seed 0; no new kernel):
     "remat": tinyllama-1.1b at full width and depth, one client, one
     loss and backward over 1 x 2,048 tokens, twice with ``remat=False``
     (naming any gradient leaf the card does not repeat to the bit), then
     with ``remat=True``: the loss bit-equal, every gradient leaf
     bit-equal, or within the plain pass's own repeat gap on a leaf that
     pass does not repeat; seconds and peak memory of each pass;
     "<arch> serve" and "<arch> serve chunked" for llama3.2-1b (16
     layers, d_model 2048, 32 heads / 8 KV heads of 64, d_ff 8192, vocab
     128,256; 1,498,482,688 parameters) and qwen3-8b (36 layers, d_model
     4096, 32 / 8 heads of 128, qk_norm, d_ff 12288, vocab 151,936;
     8,190,735,360), 4 x 512 prompt tokens, and gemma3-4b (34 layers,
     five local of window 1,024 to one global, d_model 2560, 8 / 4 heads
     of 256, d_ff 10240, vocab 262,144; 4,551,013,888), 4 x 1,536 (past
     its window), each with 32 decoded after a 2-token warm-up on the
     einsum route, then on the chunked route: no kernel launch, finite
     logits, tokens in range, the prefill run again giving the same bits;
     init seconds, tokens/s, peak memory; then the same weights in f32 at
     full depth: the chunked route's prefill logits within 1e-4 of the
     einsum route's largest magnitude (in bf16 the routes differ by about
     1e-2 of it, recorded: the chunked route rounds its unnormalised
     probabilities to bf16);
     "<arch> train ideal|ota|digital" for llama3.2-1b (12 reference
     leaves) and gemma3-4b (113: five groups of six layers and four tail
     layers) through the launcher's ``train``: 2 steps of 8 x 128 tokens
     over 4 clients, exactly one ``ota_combine_keyed`` a leaf a step on
     OTA and one ``dithered_quantize`` a client and leaf on digital,
     nothing else; finite losses and parameters; step seconds, tokens/s,
     peak memory; qwen3-8b's FL step does not fit one card (its
     gradients, their stacked leaves and the f32 client sums beside 16.4
     GB of weights) and waits for multi-card clients;
12. the cost report (``repro_torch.launch.analysis``, no kernel, no
   weights on the card): phase 11's cells reckoned on the meta device,
   one "cost_report" line each with the reckoned peak beside the card's
   reading, the matmul FLOPs by dtype, the bytes accessed and the three
   time terms on an H100:
     "<arch> serve" for the three dense archs: 4 x the prompt prefilled
     into caches of prompt + 33 slots and one decode step on the einsum
     route, the peak within 5% of the einsum serve line's; for
     llama3.2-1b also the prefill's matmul FLOPs, equal to what
     ``torch.utils.flop_counter.FlopCounterMode`` counted over the same
     prefill on the card in phase 11;
     "remat": the remat line's three passes (the second beside the
     first's gradients, the third beside both passes'), each peak within
     10% of the card's;
13. mesh — FL clients and Monte-Carlo trials across ranks
   (``repro_torch.launch.distributed``, ``launch.mesh``, the mesh forms
   of ``wireless_psum`` and ``make_train_step``, ``FLEngine(
   shard_trials=True)``; no kernel of their own): the kernels are built
   first, then 2 ranks fork from the fork server started before phase 1
   (``distributed.prestart``) on the cards present (sharing card 0 under
   gloo on a one-card machine, NCCL with a card each), one FL client a
   rank; "mesh_ranks" gives each rank's backend, world size and device.
   Each rank: the collective on fed leaves (bf16 and f32, 2 clients drawn
   from a seed) against the one-card form over both clients, bit-equal in
   the ideal, OTA and digital modes; (a) llama3.2-1b at full size (bf16,
   random weights from seed 0), one ideal, one OTA and one digital mesh
   step of 8 x 128 tokens from the same weights, batch and key, each
   rank keeping its client's 4 rows: exactly 12 ``ota_combine_keyed``
   (OTA) and 12 ``dithered_quantize`` (digital, its own client) a rank,
   nothing else; the ranks' parameters identical by a fingerprint of
   their bits and their losses equal; before them the one-card 2-client
   step from the same weights (rank 0 the ideal and OTA ones, rank 1 the
   digital one, at once): loss and every parameter compared, any
   difference reported with its size; (b) Fig. 2
   ProposedOTA (N = 50) and ProposedDigital (N = 10, the 150 s budget)
   at d = 7850 on phase 4's designs, 4 trials over the 2 ranks with
   ``shard_trials=True``, 40 rounds, every round evaluated: exactly 40
   ``ota_combine`` / 40 ``dithered_quantize_rows`` a rank, every rank
   the same run, held against rank 0's one-rank run (OTA within 1e-5 a
   trial and round; digital to the bit). The lines say that seconds of
   ranks sharing one card are not multi-card speeds;
14. the seconds of each numbered phase, the kernel table, nvidia-smi's
   line, and the result line.
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
    ints = {8: torch.int64, 4: torch.int32, 2: torch.int16}[a.element_size()]
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


def design_case(family, specs, run, oracle_iters=None, timed=False):
    """Solve ``specs`` with the port's batched solver on the card, host
    clock to a synchronise: cold, or with ``timed`` warm (the family has
    solved once already, at B = 1) and once more under the profiler; the
    same solve with ``device="cpu"`` must give the same
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
    line["warm_s" if timed else "cold_s"] = time.perf_counter() - t0
    if timed:
        t0 = time.perf_counter()
        kernels, copies, device_ms = launches_of(lambda: batch(specs))
        line.update(launches=kernels, copies=copies, device_ms=device_ms,
                    device_idle=1.0 - device_ms / 1e3 / line["warm_s"],
                    profiled_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    cpu_params, cpu_objs = batch(specs, device="cpu")
    line["cpu_s"] = time.perf_counter() - t0
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
    Fig. 2's two designs at B = 1, which the main path then runs on,
    cold; the design bench's fig2-sized sweep (N = 50, 4 x 4 weights, B =
    16) for both families, warm and profiled (a solve is launch-bound and
    takes as long at B = 1 as at B = 16, so one cold, one warm and one
    profiled solve a family); its quick grid (N = 20, 2 x 2,
    SCA oracle at 4 iterations) against the port's SciPy SCA oracle."""
    *_, ospec, _ = fig2_problem(50)
    *_, dspec = fig2_problem(10)
    (ota_p,) = design_case("ota", [ospec], "Fig. 2 OTA, N = 50")
    (dig_p,) = design_case("digital", [dspec],
                           "Fig. 2 digital, N = 10, T_max = 0.2 s")
    for family, specs in zip(("ota", "digital"), bench_specs(50, (4, 4))):
        design_case(family, specs, "design bench sweep, N = 50, 4 x 4",
                    timed=True)
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
    only be finite. Returns (launches, log)."""
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
    return counts, log


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


# ------------------------------------------------------------ scenario

SCENARIO_OUT = ROOT / "experiments" / "results_torch" / "chip_smoke"
SCENARIO_OTA_RTOL = 1e-5     # OTA trajectories, card against the CPU
SCENARIO_DIG_RTOL = 1e-3     # digital trajectories (dither code flips)
SCENARIO_OBJ_RTOL = 1e-6     # design objectives


def engine_rounds(rounds, eval_every):
    """The rounds one ``FLEngine.run`` computes: up to its last eval."""
    return (rounds // eval_every) * eval_every


def scheme_launches(key, spec):
    """The launches one scheme's tuned run makes (``materialize.
    tune_and_run``: a probe a step size when there are several, then the
    final run), each kernel once a computed round on its route: every
    OTA scheme but Ideal FedAvg combines through ``ota_combine``; the
    digital ones quantize through ``dithered_quantize_rows`` below the
    fused route's width, through ``quantize_pack_rows`` and
    ``packed_weighted_sum`` at or above it, and Best Channel-Norm scores
    its devices with one ``row_maxabs_sumsq``."""
    from repro_torch.api import schemes
    from repro_torch.kernels import launch_counts, ops
    from repro_torch.api.materialize import build_task
    r = spec.run
    rounds = engine_rounds(r.rounds, r.eval_every)
    if len(r.etas) > 1:
        rounds += len(r.etas) * engine_rounds(r.rounds, max(r.rounds // 4, 1))
    expect = dict.fromkeys(launch_counts(), 0)
    ota = key in schemes.SUITES["fig2_ota"] + schemes.SUITES["fig3_ota"]
    if ota and key != "ideal":
        expect["ota_combine"] = rounds
    elif not ota:
        if build_task(spec).dim >= ops.FUSED_MIN_DIM:
            expect["quantize_pack_rows"] = rounds
            expect["packed_weighted_sum"] = rounds
        else:
            expect["dithered_quantize_rows"] = rounds
        if key == "best_channel_norm":
            expect["row_maxabs_sumsq"] = rounds
    return expect


class ScenarioClock:
    """Times and launch counts of one ``execute`` by step: the kappa
    estimate inside ``materialize``, each design group and each scheme's
    tuned run, read by wrapping the module functions ``execute`` calls
    (the card synchronised at each reading)."""

    def __init__(self):
        self.materialize_s, self.design_s, self.schemes = 0.0, [], []

    def __enter__(self):
        import importlib
        import torch
        from repro_torch import kernels
        ex = importlib.import_module("repro_torch.api.execute")
        mat = importlib.import_module("repro_torch.api.materialize")
        self._saved = [(mat, "materialize", mat.materialize),
                       (ex, "_solve_group", ex._solve_group),
                       (mat, "run_cell_scheme", mat.run_cell_scheme)]
        (_, _, materialize), (_, _, solve), (_, _, run) = self._saved

        def timed(fn, sink):
            def wrapped(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                before = kernels.launch_counts()
                out = fn(*a, **k)
                torch.cuda.synchronize()
                after = kernels.launch_counts()
                sink(time.perf_counter() - t0, a,
                     {n: after[n] - before[n] for n in after}, out)
                return out
            return wrapped

        def on_mat(s, a, launches, out):
            self.materialize_s += s

        def on_design(s, a, launches, out):
            self.design_s.append(dict(family=a[0].family, solver=a[0].solver,
                                      points=len(a[0].cell_indices),
                                      direct=len(a[0].needs_direct),
                                      seconds=s))

        def on_scheme(s, a, launches, out):
            self.schemes.append(dict(scheme=a[1].name, seconds=s,
                                     launches={k: v for k, v in
                                               launches.items() if v},
                                     all_launches=launches, eta=out[1],
                                     cell_hash=a[0].scenario.spec_hash()))

        mat.materialize = timed(materialize, on_mat)
        ex._solve_group = timed(solve, on_design)
        mat.run_cell_scheme = timed(run, on_scheme)
        return self

    def __exit__(self, *exc):
        for module, name, fn in self._saved:
            setattr(module, name, fn)


def manifest_sans_timings(manifest):
    """A manifest without its wall-clock fields and cell statuses."""
    m = {k: v for k, v in manifest.items() if k not in ("elapsed_s",)}
    m["cells"] = [{k: v for k, v in c.items()
                   if k not in ("elapsed_s", "status")}
                  for c in manifest["cells"]]
    return m


def scenario_run(name, spec, proposed):
    """Execute ``spec`` on the card into a fresh directory with the launch
    counts at 0, read them just after; check each scheme's launches
    exactly, finite losses (falling for the ``proposed`` keys); then run
    it again into the same directory: every cell cached, no launch, the
    same manifest but for timings. Returns the first run's launches."""
    import shutil
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.api import execute, schemes
    from repro_torch.api.materialize import build_task
    out = SCENARIO_OUT / name
    shutil.rmtree(out, ignore_errors=True)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with ScenarioClock() as clock:
        rs = execute(spec, out_dir=out)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    check([c.status for c in rs] == ["computed"],
          f"scenario {name}: statuses {[c.status for c in rs]}")
    keys = schemes.expand_schemes(spec.schemes)
    check(len(clock.schemes) == len(keys),
          f"scenario {name}: {len(clock.schemes)} scheme runs for "
          f"{len(keys)} keys")
    total = dict.fromkeys(counts, 0)
    rows = []
    for key, timed, log in zip(keys, clock.schemes, rs.cell(0).logs):
        expect = scheme_launches(key, spec)
        check(timed["all_launches"] == expect,
              f"scenario {name} {key}: launches {timed['launches']}, "
              f"expected {expect}")
        for k, v in expect.items():
            total[k] += v
        loss = np.asarray(log["loss_mean"])
        fell = bool(loss[-1] < loss[0])
        check(np.all(np.isfinite(loss)) and (fell or key not in proposed),
              f"scenario {name} {key}: loss {loss.tolist()}")
        rows.append(dict(key=key, scheme=log["scheme"], eta=log["eta"],
                         seconds=timed["seconds"], launches=timed["launches"],
                         loss_first=float(loss[0]), loss_final=float(loss[-1]),
                         loss_fell=fell, final_accuracy=log["acc_mean"][-1]))
    check(counts == total, f"scenario {name}: launches {counts} against the "
          f"schemes' {total}")
    payload = rs.cell(0).payload
    emit(phase="scenario", run=name, cell_hash=rs.cell(0).cell_hash,
         n_devices=spec.n_devices, d=build_task(spec).dim,
         rounds=spec.run.rounds, trials=spec.run.trials,
         etas=list(spec.run.etas), kappa=payload["kappa"],
         design=payload["design"], seconds=seconds,
         materialize_s=clock.materialize_s, design_s=clock.design_s,
         schemes=rows, launches={k: v for k, v in counts.items() if v})
    # the same spec again into the same directory: a cache no-op
    manifest = json.loads((out / "manifest.json").read_text())
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    again = execute(spec, out_dir=out)
    rerun_s = time.perf_counter() - t0
    relaunched = {k: v for k, v in kernels.launch_counts().items() if v}
    check(again.all_cached and not relaunched,
          f"scenario {name} re-run: statuses "
          f"{[c.status for c in again]}, launches {relaunched}")
    check(manifest_sans_timings(json.loads(
        (out / "manifest.json").read_text()))
          == manifest_sans_timings(manifest),
          f"scenario {name} re-run: the manifest changed")
    emit(phase="scenario_cached", run=name, seconds=rerun_s, all_cached=True,
         launches=0, manifest_equal=True)
    return counts


def logs_agree(name, card, cpu, rtol, gate):
    """Card and CPU results of one executed spec: the same hashes, eta
    and wall-clocks (within 8 ulps: the digital latencies go through log),
    design objectives within SCENARIO_OBJ_RTOL, loss and accuracy
    trajectories within ``rtol``; with ``gate`` also the mean loss within
    4 combined standard errors of the trial means (a floor of ceil(log2 n)
    f32 ulps where no trial spreads). Returns the largest gaps."""
    import numpy as np
    worst = {"loss": 0.0, "objective": 0.0}
    for ca, cb in zip(card, cpu):
        check(ca.cell_hash == cb.cell_hash, f"{name}: cell hashes differ")
        for fam, d in ca.payload["design"].items():
            for k in ("objective", "objective_direct"):
                if k in d:
                    rel = abs(d[k] - cb.payload["design"][fam][k]) / abs(
                        cb.payload["design"][fam][k])
                    worst["objective"] = max(worst["objective"], rel)
                    check(rel <= SCENARIO_OBJ_RTOL,
                          f"{name}: {fam} {k} differs by {rel}")
        spec = ca.payload["scenario"]
        n = spec["wireless"]["n_devices"] * spec["data"]["samples_per_device"]
        trials = spec["run"]["trials"]
        for la, lb in zip(ca.logs, cb.logs):
            wa, wb = np.asarray(la["wall_time_s"]), np.asarray(
                lb["wall_time_s"])
            ulps = float(np.max(np.abs(wa - wb) / np.spacing(
                np.maximum(wb, 1e-300))))
            check(la["eta"] == lb["eta"] and ulps <= 8,
                  f"{name} {la['scheme_key']}: eta {la['eta']} vs "
                  f"{lb['eta']}, wall-clocks {ulps} ulps apart")
            for k in ("loss_mean", "acc_mean"):
                a, b = np.asarray(la[k]), np.asarray(lb[k])
                rel = float(np.max(np.abs(a - b) / np.abs(b)))
                check(rel <= rtol, f"{name} {la['scheme_key']}: {k} "
                      f"differs by {rel} relative (limit {rtol})")
                if k == "loss_mean":
                    worst["loss"] = max(worst["loss"], rel)
            if gate:
                sa, sb = np.asarray(la["loss_std"]), np.asarray(lb["loss_std"])
                a, b = np.asarray(la["loss_mean"]), np.asarray(lb["loss_mean"])
                stderr = np.sqrt((sa ** 2 + sb ** 2) / (trials - 1))
                floor = np.ceil(np.log2(n)) * np.spacing(
                    np.float32(b)).astype(np.float64)
                check(np.all(np.abs(a - b) <= 4 * stderr + floor),
                      f"{name} {la['scheme_key']}: outside the 4-sigma "
                      f"gate: {np.abs(a - b).tolist()} vs "
                      f"{stderr.tolist()}")
    return worst


def scenario_vs_cpu():
    """``sweep_smoke`` and a two-scheme Fig. 2 digital quick spec (kappa
    fixed at 3, where the batched digital design is well conditioned;
    rounds cut to 40) on the card against the CPU, within the tests'
    tolerances."""
    from repro_torch.api import execute, scenarios
    digital = scenarios.fig2_digital_sc(quick=True)
    for path, value in (("run.rounds", 40), ("design.kappa", 3.0),
                        ("schemes", ("proposed_digital", "best_channel"))):
        digital = digital.override(path, value)
    for name, spec, rtol, gate in (
            ("sweep_smoke", scenarios.sweep_smoke(), SCENARIO_OTA_RTOL,
             False),
            ("fig2_digital_sc quick, kappa 3", digital, SCENARIO_DIG_RTOL,
             True)):
        t0 = time.perf_counter()
        card = execute(spec, save=False, force=True)
        card_s = time.perf_counter() - t0
        cpu = execute(spec, save=False, force=True, device="cpu")
        worst = logs_agree(name, card, cpu, rtol, gate)
        emit(phase="scenario_vs_cpu", run=name, cells=len(card),
             card_s=card_s, max_rel_loss_diff=worst["loss"],
             max_rel_objective_diff=worst["objective"], limit=rtol,
             objective_limit=SCENARIO_OBJ_RTOL, four_sigma_gate=gate)


def scenario_cli():
    """The command line on the card: ``run sweep_smoke --out DIR`` exits
    0, then ``--expect-cached`` exits 0, then ``--jobs 2 --force`` gives
    the serial manifest but for timings."""
    import os
    import shutil
    out = SCENARIO_OUT / "cli_sweep_smoke"
    shutil.rmtree(out, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                               if p]))
    lines = {}
    manifests = {}
    for step, extra in (("serial", []), ("expect_cached",
                                         ["--expect-cached"]),
                        ("jobs_2", ["--jobs", "2", "--force"])):
        t0 = time.perf_counter()
        done = subprocess.run(
            [sys.executable, "-m", "repro_torch.api.cli", "run",
             "sweep_smoke", "--out", str(out), *extra], capture_output=True,
            text=True, env=env, timeout=600)
        check(done.returncode == 0,
              f"cli {step}: exit {done.returncode}\n{done.stdout[-2000:]}\n"
              f"{done.stderr[-4000:]}")
        lines[step] = dict(seconds=time.perf_counter() - t0,
                           summary=done.stdout.strip().splitlines()[-1])
        manifests[step] = json.loads((out / "manifest.json").read_text())
    check("4 computed" in lines["serial"]["summary"]
          and "4 cached" in lines["expect_cached"]["summary"]
          and "4 computed" in lines["jobs_2"]["summary"],
          f"cli summaries {lines}")
    same = (manifest_sans_timings(manifests["jobs_2"])
            == manifest_sans_timings(manifests["serial"]))
    check(same, "cli: --jobs 2 gave another manifest than the serial run")
    emit(phase="scenario_cli", steps=lines, jobs_2_manifest_equal=True)


def scenario_phase():
    """The scenario layer on the card (``repro_torch.api.execute``): the
    paper's Fig. 2 OTA (N = 50, 30 rounds), Fig. 2 digital (N = 10, 40
    rounds) and Fig. 3 (d = 147,994, 20 rounds) at full width as
    ``ScenarioSpec``s, each with a cached re-run; then the card against
    the CPU and the command line. Returns the three runs' launches."""
    from repro_torch.api import scenarios
    launches = {}
    for name, spec, proposed in (
            ("fig2_ota_sc", scenarios.fig2_ota_sc(quick=False).override(
                "run.rounds", 30), ("proposed_ota", "proposed_ota_direct")),
            ("fig2_digital_sc", scenarios.fig2_digital_sc(
                quick=False).override("run.rounds", 40),
             ("proposed_digital", "proposed_digital_direct")),
            ("fig3_nonconvex", scenarios.fig3_nonconvex(
                quick=False).override("run.rounds", 20), ("proposed_ota",))):
        for k, v in scenario_run(name, spec, proposed).items():
            launches[k] = launches.get(k, 0) + v
        free_card()
    scenario_vs_cpu()
    scenario_cli()
    return launches


# --------------------------------------------------------------- layers

LAYER_FAULT = dict(dropout_prob=0.2, erasure_prob=0.05, straggler_prob=0.1,
                   straggler_mult=3.0)
LAYER_OTA_RTOL = 1e-5        # OTA trajectories, card against the CPU
LAYER_DIG_RTOL = 1e-3        # digital trajectories (dither code flips)


def layer_streams_match_cpu(seed, trials, rounds, n):
    """The three layers' uniforms for a whole run made on the card against
    the CPU's, bit for bit (the tests tie the CPU streams to JAX's)."""
    import torch
    from repro_torch.core import rngstream
    for name, blocks, base in (
            ("fault", rngstream.fault_blocks, rngstream.fault_base_key),
            ("participation", rngstream.participation_blocks,
             rngstream.participate_base_key),
            ("arrival", rngstream.arrival_blocks,
             rngstream.arrival_base_key)):
        keys = [base(seed, tr) for tr in range(trials)]
        card = blocks(keys, rounds, n, device="cuda")
        cpu = blocks(keys, rounds, n, device="cpu")
        check(torch.equal(card.cpu(), cpu),
              f"{name} uniforms on the card != CPU, ({trials}, {rounds}, {n})")
    emit(phase="layer_streams_vs_cpu", seed=seed, trials=trials,
         rounds=rounds, n_devices=n, bit_equal=True)


def describe_layers(kw) -> dict:
    """A run's layer options as JSON."""
    out = {}
    for k, v in kw.items():
        if dataclasses.is_dataclass(v):
            v = dataclasses.asdict(v)
        elif hasattr(v, "tolist"):
            v = v.tolist()
        out[k] = v
    return out


def layers_run(name, setup, agg, layer_kw, expect, run, rtol, gate,
               cpu_run=None, phase="layers"):
    """One scheme under layer options ``layer_kw`` through ``FLTrainer``
    on the card: the launch counts at 0 before the run and exactly
    ``expect`` (every kernel) after it, finite losses, the same run on
    the plain versions bit-equal, and the same run (or ``cpu_run``) on
    the CPU within ``rtol`` relative (with ``gate`` also the mean loss within 4 combined
    standard errors, a floor of ceil(log2 n) f32 ulps); host ms and launches per round, and from one more
    run under the profiler every launch and the device ms per round (the
    idle share against the unprofiled run's host time). Returns
    (launches, log)."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.fl import FLEngine, FLTrainer
    task, ds, dep, eta = setup
    trainer = FLTrainer(task, ds, dep, eta, **layer_kw)
    trainer.run(agg, **{**run, "rounds": 2, "eval_every": 1})   # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    log = trainer.run(agg, **run)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    want = dict.fromkeys(counts, 0)
    want.update(expect)
    check(counts == want, f"layers {name}: launches {counts}, expected {want}")
    loss = log.global_loss
    check(np.all(np.isfinite(loss)), f"layers {name}: loss not finite")
    # the same run once more under the profiler: every launch on the card
    # (the task, the layers, the scheme, the eval) and the device time
    all_launches, copies, device_ms = launches_of(
        lambda: trainer.run(agg, **run))
    plain = FLEngine(task, ds, dep, eta, use_kernel=False,
                     **layer_kw).run(agg, **run)
    check(np.array_equal(plain.global_loss, loss)
          and np.array_equal(plain.accuracy, log.accuracy)
          and np.array_equal(plain.wall_time_s, log.wall_time_s),
          f"layers {name}: kernel and plain trajectories differ")
    # against the CPU at ``cpu_run`` (a shorter run where the CPU's would
    # take long), the card running it again
    cmp_run = run if cpu_run is None else cpu_run
    card = log if cpu_run is None else trainer.run(agg, **cpu_run)
    cpu = FLTrainer(task, ds, dep, eta, device="cpu",
                    **layer_kw).run(agg, **cmp_run)
    card_loss = card.global_loss
    rel = float(np.max(np.abs(card_loss - cpu.global_loss)
                       / np.abs(cpu.global_loss)))
    ulps = float(np.max(np.abs(card.wall_time_s - cpu.wall_time_s)
                        / np.spacing(np.maximum(cpu.wall_time_s, 1e-300))))
    check(rel <= rtol and ulps <= 8,
          f"layers {name}: card vs CPU loss differs by {rel} relative (limit "
          f"{rtol}) or wall-clock by {ulps} ulps (limit 8)")
    if gate:
        # where no trial spreads (round 0) the floor is the f32 rounding
        # of the loss, a mean over n samples the card and the CPU add in
        # other orders: ceil(log2 n) ulps of it
        n = sum(len(dd) for dd in ds.devices)
        stderr = np.sqrt((card_loss.var(0) + cpu.global_loss.var(0))
                         / (cmp_run["trials"] - 1))
        cpu_mean = cpu.global_loss.mean(0)
        floor = np.ceil(np.log2(n)) * np.spacing(
            np.float32(cpu_mean)).astype(np.float64)
        gap = np.abs(card_loss.mean(0) - cpu_mean)
        check(np.all(gap <= 4.0 * stderr + floor),
              f"layers {name}: outside the 4-sigma gate: {gap.tolist()} vs "
              f"{stderr.tolist()} + {floor.tolist()}")
    T = (run["rounds"] // run["eval_every"]) * run["eval_every"]
    emit(phase=phase, run=name, scheme=log.scheme,
         layers=describe_layers(layer_kw), rounds=run["rounds"],
         trials=run["trials"], launches={k: v for k, v in counts.items() if v},
         launches_per_round={k: v / T for k, v in counts.items() if v},
         seconds=seconds, host_ms_per_round=1e3 * seconds / T,
         profiled_launches_per_round=all_launches / T,
         profiled_copies=copies, device_ms_per_round=device_ms / T,
         device_idle=1.0 - device_ms / (1e3 * seconds),
         loss=loss.mean(0).tolist(),
         loss_fell=bool(loss[:, -1].mean() < loss[:, 0].mean()),
         wall_time_s=log.wall_time_s.tolist(), plain_equal=True,
         max_rel_loss_diff_vs_cpu=rel, limit=rtol,
         wall_time_max_ulps_vs_cpu=ulps, four_sigma_gate=gate,
         vs_cpu_rounds=cmp_run["rounds"], vs_cpu_trials=cmp_run["trials"])
    return counts, log, dict(host_ms_per_round=1e3 * seconds / T,
                             launches_per_round=all_launches / T,
                             device_idle=1.0 - device_ms / (1e3 * seconds))


def layers_engine_runs(ota_p, dig_p, phase5_log):
    """Part (a): the layers on the main path's full-width runs. Fig. 2
    ProposedOTA (N = 50, 30 rounds, the card's design) under the fault
    layer (each ``on_missing`` policy, a deadline), partial participation
    (S = 16: uniform, channel and the card's designed probabilities),
    buffered async (K = 4: zero, stale, designed weights), all three
    stacked and every layer at its default (which must give phase 5's
    run bit for bit); Fig. 2 ProposedDigital (N = 10, 40 rounds) under
    faults and sampling; Fig. 3 ProposedDigital (d = 147,994, 20 rounds,
    the fused route; against the CPU over 2 trials of 6 rounds, since
    the CPU's threefry dither at this width takes a minute for the whole
    run) under faults. Returns the launches."""
    import numpy as np
    from repro_torch.core import async_fl, sca_torch
    from repro_torch.core import baselines as B
    from repro_torch.core.async_fl import AsyncSpec
    from repro_torch.core.faults import FaultSpec
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    setup = fig2_setup(50, 6000)
    task, ds, dep, eta = setup
    n = dep.n_devices
    weights = fig2_problem(n)[3].weights
    ota = B.ProposedOTA(ota_p, label="Proposed OTA-FL (designed on the "
                                     "card)")
    levels = ota_p.participation_levels(dep.lambdas)
    run = dict(rounds=30, trials=4, eval_every=10, seed=0)
    layer_streams_match_cpu(run["seed"], run["trials"], run["rounds"], n)
    # the deadline sits between a round's airtime d/B and a straggler's
    deadline = 2.0 * task.dim / dep.cfg.bandwidth_hz
    pi, _ = sca_torch.solve_participation_batch(
        levels[None], np.ones((1, n)), [16], [weights.omega_var],
        [weights.omega_bias])
    spec_k4 = AsyncSpec(buffer_rounds=4, arrival_rate=0.55,
                        rate_heterogeneity=3.0, staleness_discount=0.8,
                        weighting="designed")
    v, _ = sca_torch.solve_async_batch(
        levels[None], async_fl.delivery_weight(spec_k4, n)[None],
        async_fl.expected_staleness(spec_k4, n)[None], [weights.omega_var],
        [weights.omega_bias])
    emit(phase="layers_design", participation_probs=pi[0].tolist(),
         async_weights=v[0].tolist())
    ota_runs = [
        *[(f"fault {p}", dict(fault=FaultSpec(
            on_missing=p, deadline_s=deadline, **LAYER_FAULT)))
          for p in ("reweight", "zero", "stale")],
        ("participation uniform", dict(clients_per_round=16)),
        ("participation channel", dict(clients_per_round=16,
                                       participation="channel")),
        ("participation designed", dict(
            clients_per_round=16, participation="designed",
            participation_probs=pi[0])),
        ("async zero", dict(mode="async", async_spec=dataclasses.replace(
            spec_k4, weighting="uniform"))),
        ("async stale, designed", dict(
            mode="async", async_weights=v[0],
            async_spec=dataclasses.replace(spec_k4, on_missing="stale"))),
        ("stacked", dict(
            fault=FaultSpec(on_missing="stale", **LAYER_FAULT),
            clients_per_round=16, participation="channel", mode="async",
            async_spec=dataclasses.replace(spec_k4, weighting="uniform",
                                           on_missing="stale"))),
        ("defaults", dict(fault=FaultSpec(), clients_per_round=None,
                          mode="sync"))]
    for name, kw in ota_runs:
        counts, log, _ = layers_run(f"Fig. 2 ProposedOTA, {name}", setup,
                                    ota, kw, {"ota_combine": 30}, run,
                                    LAYER_OTA_RTOL, False)
        add(counts)
    check(np.array_equal(log.global_loss, phase5_log.global_loss)
          and np.array_equal(log.accuracy, phase5_log.accuracy)
          and np.array_equal(log.wall_time_s, phase5_log.wall_time_s),
          "layers at their defaults: not phase 5's ProposedOTA run")
    emit(phase="layers_defaults", equal_to_phase_5=True)
    del setup, task, ds
    free_card()

    setup = fig2_setup(10, 1200)
    dig = B.ProposedDigital(dig_p, label="Proposed Digital FL (designed on "
                                         "the card)")
    counts, _, _ = layers_run(
        "Fig. 2 ProposedDigital, fault zero + participation", setup, dig,
        dict(fault=FaultSpec(on_missing="zero", **LAYER_FAULT),
             clients_per_round=6),
        {"dithered_quantize_rows": 40},
        dict(rounds=40, trials=4, eval_every=20, seed=0,
             time_budget_s=150.0), LAYER_DIG_RTOL, True)
    add(counts)
    del setup
    free_card()

    task, ds, dep, eta, _, dig3 = fig3_setup()
    counts, _, _ = layers_run(
        "Fig. 3 ProposedDigital, fault zero", (task, ds, dep, eta),
        B.ProposedDigital(dig3, label="Proposed Digital FL (uniform "
                                      "anchor)"),
        dict(fault=FaultSpec(on_missing="zero", **LAYER_FAULT)),
        {"quantize_pack_rows": 20, "packed_weighted_sum": 20},
        dict(rounds=20, trials=4, eval_every=10, seed=9), LAYER_DIG_RTOL,
        True, cpu_run=dict(rounds=6, trials=2, eval_every=2, seed=9))
    add(counts)
    free_card()
    return launches


#: each sweep's axes as the card runs them, for the time limit: a subset
#: of each registered axis's values, one cell per distinct route and
#: design group; an axis left out stays at the base spec's value. Every
#: sweep_async cell and every designed sweep_participation cell solves its
#: own co-design problem (9-17 s on the card, launch-bound), so
#: sweep_async runs its base cell alone (K = 4, rate spread 3.0, discount
#: 0.8; 27 cells registered) and sweep_participation S = 16 under the
#: uniform and the designed policy (N = 50, the base's; 8 registered);
#: sweep_fault's nine cells share one route and its path-loss axis makes
#: the design groups, so it runs dropout 0.5 at path loss 2.2, the
#: base's; fig2_batch runs B = 16 (its full-batch cell is phase 6's
#: fig2_ota_sc run, and B = 64, 256 take the same route as 16)
SWEEP_AXES = {
    "sweep_fault": {"fault.dropout_prob": (0.5,)},
    "sweep_participation": {"run.clients_per_round": (16,),
                            "run.participation": ("uniform", "designed")},
    "sweep_async": {},
    "fig2_batch": {"run.batch_size": (16,)},
}


def sweep_cut(name, rounds=20):
    """A registered sweep at ``quick=False`` widths, its rounds cut and
    its axes cut to ``SWEEP_AXES[name]``'s values."""
    from repro_torch.api import scenarios
    from repro_torch.api.spec import SweepSpec
    sweep = scenarios.get(name, quick=False)
    registered = dict(sweep.axes)
    axes = SWEEP_AXES[name]
    check(all(set(v) <= set(registered[k]) for k, v in axes.items()),
          f"sweep {name}: cut axes {axes} not in {registered}")
    return SweepSpec(name=sweep.name, base=sweep.base.override(
        "run.rounds", rounds), axes=axes)


def sweep_run(name, spec):
    """Part (b): one sweep through ``execute`` on the card into a fresh
    directory with the launch counts at 0: the seconds of data + kappa,
    of each design group and of each scheme; each scheme's launches
    exactly as derived; finite losses, and proposed_ota's falling in
    every cell or, where it does not, that cell's proposed_ota run on the
    CPU rising with it within 1e-5 relative (the step-size search's
    choice, not the card's); then the re-run from the cache: all cached,
    no launch, the same manifest but for timings. Returns the launches."""
    import shutil
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.api import execute, schemes
    from repro_torch.api.plan import plan
    out = SCENARIO_OUT / name
    shutil.rmtree(out, ignore_errors=True)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with ScenarioClock() as clock:
        rs = execute(spec, out_dir=out)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    check(all(c.status == "computed" for c in rs),
          f"sweep {name}: statuses {[c.status for c in rs]}")
    by_cell = {}
    for timed in clock.schemes:
        by_cell.setdefault(timed["cell_hash"], []).append(timed)
    total = dict.fromkeys(counts, 0)
    cells, rose = [], []
    planned = plan(spec).cells
    for cell in rs:
        scenario = planned[cell.index].scenario
        keys = schemes.expand_schemes(scenario.schemes)
        timed_runs = by_cell[cell.cell_hash]
        check(len(timed_runs) == len(keys),
              f"sweep {name} cell {cell.index}: {len(timed_runs)} runs")
        rows = []
        for key, timed, log in zip(keys, timed_runs, cell.logs):
            expect = scheme_launches(key, scenario)
            check(timed["all_launches"] == expect,
                  f"sweep {name} cell {cell.index} {key}: launches "
                  f"{timed['launches']}, expected {expect}")
            for k, v in expect.items():
                total[k] += v
            loss = np.asarray(log["loss_mean"])
            check(np.all(np.isfinite(loss)),
                  f"sweep {name} cell {cell.index} {key}: loss not finite")
            fell = bool(loss[-1] < loss[0])
            if key == "proposed_ota" and not fell:
                rose.append((cell, scenario, log))
            rows.append(dict(key=key, eta=log["eta"],
                             seconds=timed["seconds"],
                             loss_first=float(loss[0]),
                             loss_final=float(loss[-1]), loss_fell=fell))
        cells.append(dict(index=cell.index, overrides=cell.overrides,
                          kappa=cell.payload["kappa"],
                          objective=cell.payload["design"]["ota"][
                              "objective"], schemes=rows))
    check(counts == total, f"sweep {name}: launches {counts} against the "
          f"schemes' {total}")
    cpu_checked = []
    for cell, scenario, log in rose:
        alone = scenario.replace(schemes=("proposed_ota",))
        cpu = execute(alone, save=False, force=True, device="cpu").cell(0)
        lc = cpu.logs[0]
        a, b = np.asarray(log["loss_mean"]), np.asarray(lc["loss_mean"])
        rel = float(np.max(np.abs(a - b) / np.abs(b)))
        check(lc["eta"] == log["eta"] and rel <= LAYER_OTA_RTOL,
              f"sweep {name} cell {cell.index}: proposed_ota's loss rose "
              f"({a[0]} -> {a[-1]}) and the CPU's differs: eta "
              f"{lc['eta']} vs {log['eta']}, {rel} relative")
        cpu_checked.append(dict(index=cell.index, max_rel_loss_diff=rel,
                                eta=log["eta"], loss_final=float(a[-1])))
    emit(phase="sweep", run=name, cells=len(rs), seconds=seconds,
         rounds=spec.base.run.rounds, trials=spec.base.run.trials,
         etas=list(spec.base.run.etas),
         materialize_s=clock.materialize_s, design_s=clock.design_s,
         schemes_s=sum(s["seconds"] for s in clock.schemes),
         launches={k: v for k, v in counts.items() if v},
         proposed_rose_cpu_checked=cpu_checked, per_cell=cells)
    manifest = json.loads((out / "manifest.json").read_text())
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    again = execute(spec, out_dir=out)
    rerun_s = time.perf_counter() - t0
    relaunched = {k: v for k, v in kernels.launch_counts().items() if v}
    check(again.all_cached and not relaunched,
          f"sweep {name} re-run: statuses {[c.status for c in again]}, "
          f"launches {relaunched}")
    check(manifest_sans_timings(json.loads(
        (out / "manifest.json").read_text()))
          == manifest_sans_timings(manifest),
          f"sweep {name} re-run: the manifest changed")
    emit(phase="sweep_cached", run=name, seconds=rerun_s, all_cached=True,
         launches=0, manifest_equal=True)
    return counts


def sweep_cli():
    """``python -m repro_torch.api.cli run SPEC.json --jobs 4`` on the
    card, once, for the quick ``sweep_async`` cut to its buffer axis, the
    rate spread and discount left at the base's 3.0 and 0.8 (2 of its 8
    cells, one a worker): exit 0 and every cell computed. The workers
    share the card: each cell's co-design solve is bound by its launches,
    so they overlap."""
    import os
    import shutil
    from repro_torch.api import scenarios
    from repro_torch.api.spec import SweepSpec
    out = SCENARIO_OUT / "cli_sweep_async"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    quick = scenarios.sweep_async(quick=True)
    spec = SweepSpec(name=quick.name, base=quick.base, axes={
        k: v for k, v in quick.axes if k == "async_.buffer_rounds"})
    path = out.parent / "cli_sweep_async.json"
    path.write_text(json.dumps(spec.to_dict()))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                               if p]))
    t0 = time.perf_counter()
    done = subprocess.run(
        [sys.executable, "-m", "repro_torch.api.cli", "run", str(path),
         "--out", str(out), "--jobs", "4"], capture_output=True, text=True,
        env=env, timeout=600)
    check(done.returncode == 0,
          f"cli sweep_async: exit {done.returncode}\n{done.stdout[-2000:]}\n"
          f"{done.stderr[-4000:]}")
    summary = done.stdout.strip().splitlines()[-1]
    check(f"{spec.n_points} computed" in summary,
          f"cli sweep_async: {summary}")
    emit(phase="sweep_cli", run="sweep_async", cells=spec.n_points,
         seconds=time.perf_counter() - t0, summary=summary)


def layers_phase(ota_p, dig_p, phase5_log):
    """The fault, participation and async layers on the card: the engine
    runs of part (a), then ``sweep_fault``, ``sweep_participation`` and
    ``sweep_async`` at full width (20 of 100 rounds) through ``execute``,
    each re-run from its cache, and the command line. Returns the
    launches."""
    launches = layers_engine_runs(ota_p, dig_p, phase5_log)
    for name in ("sweep_fault", "sweep_participation", "sweep_async"):
        for k, v in sweep_run(name, sweep_cut(name)).items():
            launches[k] = launches.get(k, 0) + v
        free_card()
    sweep_cli()
    return launches


# ------------------------------------------ mini-batches and fast streams

STREAM_SIZES = (1000, 800, 1626, 300, 1000, 150)   # ragged / mixed rows
FAST_NORMAL_ULPS = 3       # f32 and f64 normals, the tests' bound
FAST_FADING_ULPS = 8       # |h|, the tests' bound


def max_ulps(a, b) -> float:
    """The largest gap of two float tensors in ulps of b."""
    import numpy as np
    a, b = a.cpu().numpy(), b.cpu().numpy()
    return float(np.max(np.abs(a - b)
                        / np.spacing(np.maximum(np.abs(b), 1e-300))))


def streams_vs_cpu(dig_ports):
    """Part (a): the batch and fast streams made on the card against the
    CPU's: Fig. 2's (4, 10, 50, B) batch blocks for B = 16, 64, 256, an
    n = 1626 block (two sorts), ragged and mixed rows, the fast selection
    rows of ``dig_ports`` (40 rounds), bit for bit; the fast PS AWGN, the
    f64 normals and the fast |h| within the tests' ulps."""
    import torch
    from repro_torch.core import channel, rngstream
    from repro_torch.core.channel import WirelessConfig, make_deployment
    t0 = time.perf_counter()
    keys = [rngstream.batch_base_key(0, tr) for tr in range(4)]
    rows = []
    for name, sizes, B, mixed in (
            *[(f"Fig. 2 B = {b}", (1000,) * 50, b, False)
              for b in (16, 64, 256)],
            ("n = 1626", (1626,) * 10, 64, False),
            ("ragged", STREAM_SIZES, 150, False),
            ("mixed", STREAM_SIZES, 800, True)):
        args = (keys, 0, 10, sizes, B)
        card = rngstream.batch_blocks(*args, mixed=mixed, device="cuda")
        cpu = rngstream.batch_blocks(*args, mixed=mixed, device="cpu")
        check(torch.equal(card.cpu(), cpu),
              f"batch block {name} on the card != CPU")
        rows.append(dict(block=name, shape=list(card.shape),
                         sorts=rngstream.shuffle_rounds(max(sizes)),
                         bit_equal=True))
    for port in dig_ports:
        sk = [rngstream.stream_base_key(0, tr, rngstream.SELECT_TAG)
              for tr in range(4)]
        card = port.sel_stream_fast(rngstream.round_keys(sk, 40,
                                                         device="cuda"))
        cpu = port.sel_stream_fast(rngstream.round_keys(sk, 40))
        check(torch.equal(card.cpu(), cpu),
              f"fast selection rows of {port.name} on the card != CPU")
        rows.append(dict(block=f"selection {port.name}",
                         shape=list(card.shape), bit_equal=True))
    zk = [rngstream.stream_base_key(0, tr, rngstream.NOISE_TAG)
          for tr in range(4)]
    noise = [rngstream.noise_blocks(zk, 0, 10, 7850, device=dev)
             .to(torch.float32) for dev in ("cuda", "cpu")]
    z64 = [rngstream.normal_f64(rngstream.prng_key(7), (1 << 20,),
                                device=dev) for dev in ("cuda", "cpu")]
    lam = make_deployment(WirelessConfig(n_devices=50, seed=1)).lambdas
    fk = [rngstream.stream_base_key(0, tr, rngstream.FADING_TAG)
          for tr in range(4)]
    habs = [channel.fading_abs_fast(fk, 300, lam, device=dev)
            for dev in ("cuda", "cpu")]
    gaps = dict(noise_f32=max_ulps(*noise), normal_f64=max_ulps(*z64),
                fading_abs=max_ulps(*habs))
    check(gaps["noise_f32"] <= FAST_NORMAL_ULPS
          and gaps["normal_f64"] <= FAST_NORMAL_ULPS
          and gaps["fading_abs"] <= FAST_FADING_ULPS,
          f"fast normals on the card against the CPU: {gaps} ulps")
    emit(phase="streams_vs_cpu", blocks=rows, ulps=gaps,
         limits=dict(normals=FAST_NORMAL_ULPS, fading=FAST_FADING_ULPS),
         noise_f32_equal_share=float(
             (noise[0].cpu() == noise[1]).double().mean()),
         seconds=time.perf_counter() - t0)


def batch_sweep_vs_cpu():
    """Part (b), the card against the CPU: ``fig2_batch(quick=False)``
    cut to 20 rounds, Proposed OTA at one step size and kappa fixed at 3
    (the CPU's kappa estimate over 50,000 samples would take minutes),
    each cell within 1e-5."""
    from repro_torch.api import execute, scenarios
    from repro_torch.api.spec import SweepSpec
    sweep = scenarios.fig2_batch(quick=False)
    base = sweep.base
    for path, value in (("run.rounds", 20), ("run.etas", (0.25,)),
                        ("design.kappa", 3.0),
                        ("schemes", ("proposed_ota",))):
        base = base.override(path, value)
    spec = SweepSpec(name="fig2_batch", base=base,
                     axes=SWEEP_AXES["fig2_batch"])
    t0 = time.perf_counter()
    card = execute(spec, save=False, force=True)
    card_s = time.perf_counter() - t0
    cpu = execute(spec, save=False, force=True, device="cpu")
    worst = logs_agree("fig2_batch", card, cpu, SCENARIO_OTA_RTOL, False)
    emit(phase="scenario_vs_cpu", run="fig2_batch, proposed_ota, kappa 3",
         cells=len(card), card_s=card_s, max_rel_loss_diff=worst["loss"],
         max_rel_objective_diff=worst["objective"],
         limit=SCENARIO_OTA_RTOL, objective_limit=SCENARIO_OBJ_RTOL)


def replay_beside(setup, agg, run):
    """The same run in replay mode, for its host ms, launches and device
    idle beside the fast run's (its trajectory is phase 5's)."""
    import torch
    from repro_torch.fl import FLTrainer
    trainer = FLTrainer(*setup)
    trainer.run(agg, **{**run, "rounds": 2, "eval_every": 1})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.run(agg, **run)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, _, device_ms = launches_of(lambda: trainer.run(agg, **run))
    T = (run["rounds"] // run["eval_every"]) * run["eval_every"]
    return dict(host_ms_per_round=1e3 * seconds / T,
                launches_per_round=launches / T,
                device_idle=1.0 - device_ms / (1e3 * seconds))


def fast_run(name, setup, agg, expect, run, rtol, gate, launches):
    """One ``rng="fast"`` run as a "layers" run (launches exactly
    ``expect``, plain bit-equal, the CPU within ``rtol``, with ``gate``
    the 4-sigma gate), then the same run in replay mode beside it."""
    counts, _, fast = layers_run(f"{name}, fast", setup, agg, {}, expect,
                                 dict(run, rng="fast"), rtol, gate,
                                 phase="fast")
    emit(phase="fast_vs_replay", run=name, fast=fast,
         replay=replay_beside(setup, agg, run))
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v


def fast_runs(ota_p, dig_p):
    """Part (c): ``rng="fast"`` through ``FLTrainer`` on the card, Fig. 2
    ProposedOTA (N = 50, 30 rounds) and ProposedDigital, UQOS, QML and
    FedTOE (N = 10, 40 rounds, the 150 s budget). Returns the launches
    and the three selection schemes."""
    from repro_torch.core import baselines as B
    launches = {}
    fast_run("Fig. 2 ProposedOTA", fig2_setup(50, 6000),
             B.ProposedOTA(ota_p, label="Proposed OTA-FL (designed on the "
                                        "card)"),
             {"ota_combine": 30},
             dict(rounds=30, trials=4, eval_every=10, seed=0),
             LAYER_OTA_RTOL, False, launches)
    free_card()
    setup = fig2_setup(10, 1200)
    task, _, dep, _ = setup
    cfg = dep.cfg
    dconsts = (task.dim, task.g_max, cfg.energy_per_symbol, cfg.noise_power,
               cfg.bandwidth_hz)
    selection = [a for a in digital_suite(dep, dconsts)
                 if isinstance(a, (B.UQOS, B.QML, B.FedTOE))]
    for agg in [B.ProposedDigital(dig_p, label="Proposed Digital FL "
                                               "(designed on the card)"),
                *selection]:
        fast_run(f"Fig. 2 {agg.name}", setup, agg,
                 {"dithered_quantize_rows": 40},
                 dict(rounds=40, trials=4, eval_every=20, seed=0,
                      time_budget_s=150.0), LAYER_DIG_RTOL, True, launches)
    return launches, selection


def streams_phase(ota_p, dig_p):
    """Phase 8: mini-batches and ``rng="fast"`` on the card: (c) the fast
    runs, (a) the streams against the CPU (the selection rows of (c)'s
    schemes), (b) ``fig2_batch(quick=False)`` cut to 20 rounds through
    ``execute`` with its cached re-run, then a cut of it against the CPU.
    Returns the launches."""
    from repro_torch.fl.engine import scheme_port
    t0 = time.perf_counter()
    launches, selection = fast_runs(ota_p, dig_p)
    free_card()
    streams_vs_cpu([scheme_port(a) for a in selection])
    for k, v in sweep_run("fig2_batch", sweep_cut("fig2_batch")).items():
        launches[k] = launches.get(k, 0) + v
    free_card()
    batch_sweep_vs_cpu()
    emit(phase="streams_done", seconds=time.perf_counter() - t0)
    return launches


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


# ------------------------------------------------ MoE and chunked attention

QWEN_MOE = "qwen3-moe-30b-a3b"
KIMI = "kimi-k2-1t-a32b"
QWEN_MOE_PARAMS = 30_532_122_624
QWEN_MOE_ACTIVE = 3_353_032_704
LONG_PROMPT = 32768                  # SHAPES["prefill_32k"].seq_len
LONG_PROMPT_LAYERS = 16              # of 48, for the time limit


class MoeRouting:
    """Records each MoE block's routing while active (it wraps
    ``models.layers._moe_route``): per call, in layer order, the
    (token, expert) assignments kept and dropped by capacity, the
    capacity, and how many experts received a kept token. Reading them
    synchronises, so timed runs go without it."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        import torch
        from repro_torch.models import layers
        self._layers, self._real = layers, layers._moe_route

        def spy(cfg, probs, xf, C):
            out = self._real(cfg, probs, xf, C)
            _, dest, valid, _ = out[1]
            self.calls.append(dict(
                kept=int(valid.sum()), dropped=int((~valid).sum()),
                capacity=C,
                experts=int(torch.unique(dest[valid] // C).numel())))
            return out

        layers._moe_route = spy
        return self

    def __exit__(self, *exc):
        self._layers._moe_route = self._real

    def per_layer(self, key):
        return [c[key] for c in self.calls]


def moe_small_vs_cpu():
    """qwen3-moe and kimi-k2 at their ``scaled_down()`` sizes (f32) served
    on the card against the port's CPU run with the same weights, prompts
    and decode tokens: logits within the tests' 1e-4. 4 x 64 prompt
    tokens at top-2 of 4 experts give T·k = 512 > 256: the capacity path
    (C = 160) runs."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import make_model
    from repro_torch.models.layers import _capacity
    for arch in (QWEN_MOE, KIMI):
        small = get_config(arch).scaled_down()
        cpu_m = make_model(small, seed=0, device="cpu")
        card_m = make_model(small, seed=None)
        card_m.load_state_dict(cpu_m.state_dict())
        run = dict(batch=4, prompt_len=64, tokens=8, keep_logits=True)
        T = 4 * 64
        check(_capacity(small, T) < T * small.n_experts_per_tok,
              f"scaled-down {arch}: 4 x 64 tokens miss the capacity path")
        with MoeRouting() as r_cpu:
            cpu = serve(cpu_m, **run)
        with MoeRouting() as r_card:
            card = serve(card_m, feed=cpu.generated, **run)
        check(sum(card.prefill_launches.values())
              + sum(card.decode_launches.values()) == 0,
              f"scaled-down {arch} serve launched kernels")
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
        n = small.n_layers
        emit(phase="moe_small_vs_cpu", arch=small.name, max_rel_diff=worst,
             limit=1e-4, batch=4, prompt_len=64, tokens=8,
             capacity=_capacity(small, T),
             prefill_kept_card=r_card.per_layer("kept")[:n],
             prefill_dropped_card=r_card.per_layer("dropped")[:n],
             prefill_kept_cpu=r_cpu.per_layer("kept")[:n],
             prefill_dropped_cpu=r_cpu.per_layer("dropped")[:n],
             decode_dropped=sum(r_card.per_layer("dropped")[n:]))
        del card_m, card
        free_card()


def logits_gap(a, b) -> float:
    """The largest gap between two runs' logits over the largest |b|."""
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max())


def chunked_vs_einsum():
    """The two attention routes on the card, fed the same tokens:
    qwen3-moe at full width cut to 2 layers in f32 (4 x 512 prompt tokens,
    8 decoded), and gemma3-4b at its ``scaled_down()`` sizes (4 x 600: two
    key chunks of 512, the local rows' first chunk masked whole past the
    64-token window); prefill and decode logits within 1e-4 of the
    largest magnitude."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import SERVE_FLAGS, serve
    from repro_torch.models import make_model
    chunked = {**SERVE_FLAGS, "attn_impl": "chunked"}
    for arch, cfg, prompt in (
            (QWEN_MOE, dataclasses.replace(get_config(QWEN_MOE), n_layers=2,
                                           dtype=torch.float32), 512),
            ("gemma3-4b", get_config("gemma3-4b").scaled_down(), 600)):
        model = make_model(cfg, seed=0)
        run = dict(batch=4, prompt_len=prompt, tokens=8, keep_logits=True)
        with MoeRouting() as r_e:
            ein = serve(model, **run)
        with MoeRouting() as r_c:
            chk = serve(model, flags=chunked, feed=ein.generated, **run)
        gaps = [logits_gap(chk.prefill_logits, ein.prefill_logits),
                logits_gap(chk.decode_logits, ein.decode_logits)]
        routed_differently = sum(
            a != b for a, b in zip(r_e.calls, r_c.calls))
        check(max(gaps) <= 1e-4,
              f"{cfg.name}: chunked vs einsum logits differ by {gaps} of "
              f"the largest (MoE blocks routed differently: "
              f"{routed_differently})")
        check(bool(torch.isfinite(chk.decode_logits).all()),
              f"{cfg.name}: chunked logits not finite")
        emit(phase="chunked_vs_einsum", arch=arch, model=cfg.name,
             n_layers=cfg.n_layers, dtype=str(cfg.dtype).split(".")[-1],
             batch=4, prompt_len=prompt, tokens=8,
             prefill_rel_gap=gaps[0], decode_rel_gap=gaps[1], limit=1e-4,
             moe_blocks_routed_differently=routed_differently,
             prefill_s_einsum=ein.prefill_s, prefill_s_chunked=chk.prefill_s,
             decode_s_einsum=ein.decode_s, decode_s_chunked=chk.decode_s)
        del model, ein, chk
        free_card()


class Recorded:
    """While active: the MoE routing (``MoeRouting``) and the largest
    |hidden| after the model's last layer in its first call (the
    prefill's). Both synchronise."""

    def __init__(self, model):
        self.model, self.routing, self.hidden_max = model, MoeRouting(), None

    def __enter__(self):
        def hook(mod, args, res):
            if self.hidden_max is None:
                self.hidden_max = float(res[0].float().abs().max())
        self._hook = self.model.layers[-1].register_forward_hook(hook)
        self.routing.__enter__()
        return self

    def __exit__(self, *exc):
        self.routing.__exit__(*exc)
        self._hook.remove()


def moe_serve_run(model, name, batch, prompt_len, tokens, flags, repeat):
    """One main-path serve run of qwen3-moe at full width and depth, the
    counts set to 0 just before and read just after. ``repeat``: the
    prefill runs again on the same prompt, recorded, and must give the
    same bits; otherwise the run itself is recorded (its prefill's 48
    reads of the routing add 48 synchronisations to seconds of work).
    Returns the run's line."""
    import contextlib
    import torch
    from repro_torch import kernels
    from repro_torch.launch.serve import serve
    from repro_torch.models import prefill
    cfg = model.cfg
    free_card()
    torch.cuda.reset_peak_memory_stats()
    rec = Recorded(model)
    kernels.reset_launch_counts()
    with contextlib.nullcontext() if repeat else rec:
        out = serve(model, batch=batch, prompt_len=prompt_len,
                    tokens=tokens, keep_logits=True, flags=flags)
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(sum(counts.values()) == 0,
          f"{name}: the MoE path launched kernels {counts}")
    check(out.generated.shape == (batch, tokens + 1)
          and bool(((out.generated >= 0)
                    & (out.generated < cfg.vocab_size)).all())
          and bool(torch.isfinite(out.prefill_logits).all())
          and bool(torch.isfinite(out.decode_logits).all()),
          f"{name}: logits not finite or tokens out of range")
    if repeat:
        with rec:
            again, _, _ = prefill(model, {"tokens": out.prompt},
                                  prompt_len + tokens + 1, flags)
        gap = float((again.float() - out.prefill_logits.float()).abs().max())
        check(torch.equal(again, out.prefill_logits),
              f"{name}: the prefill run twice gives other logits (max gap "
              f"{gap})")
    calls = rec.routing.calls[:cfg.n_layers]            # the prefill's
    kept = sum(c["kept"] for c in calls)
    dropped = sum(c["dropped"] for c in calls)
    return dict(
        phase="main_path", run=name, arch=cfg.name, n_layers=cfg.n_layers,
        dtype="bfloat16", launches=counts, batch=batch,
        prompt_len=prompt_len, tokens=tokens,
        attn_impl=flags.get("attn_impl", "einsum"),
        capacity=calls[0]["capacity"],
        prefill_s=out.prefill_s, decode_s=out.decode_s,
        prefill_tokens_per_s=out.prefill_tokens_per_s,
        decode_tokens_per_s=out.decode_tokens_per_s,
        peak_memory_gb=peak / 1e9, prefill_repeat_bit_equal=repeat,
        recorded="the prefill again" if repeat else "this run",
        layer0_experts_routed=calls[0]["experts"],
        dropped_share=dropped / (kept + dropped),
        max_abs_hidden_last_layer=rec.hidden_max,
        first_tokens=out.generated[0, :8].tolist())


def moe_full():
    """qwen3-moe-30b-a3b at full width and depth on the card (48 layers,
    d_model 2048, 32 heads / 4 KV heads of 128, qk_norm, 128 experts
    top-8 of d_ff 768, vocab 151,936; 30,532,122,624 bf16 parameters,
    3,353,032,704 active a token): 4 x 512 prompt tokens and 32 decoded
    on the einsum attention after a 2-token warm-up, then 1 x 32,768 on
    the chunked attention and 2 decoded through the first
    ``LONG_PROMPT_LAYERS`` layers, the weights of all 48 staying on the
    card (the einsum route would need 137 GB of f32 scores a layer). No
    kernel is on this path."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import SERVE_FLAGS, serve
    from repro_torch.models import (active_param_count, make_model,
                                    param_count)
    cfg = get_config(QWEN_MOE)
    free_card()
    t0 = time.perf_counter()
    model = make_model(cfg, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params, n_active = param_count(model), active_param_count(cfg, model)
    check(n_params == QWEN_MOE_PARAMS and n_active == QWEN_MOE_ACTIVE
          and model.embed.dtype == torch.bfloat16,
          f"{QWEN_MOE} has {n_params} parameters, {n_active} active")
    serve(model, batch=4, prompt_len=512, tokens=2)           # warm-up
    torch.cuda.synchronize()
    line = moe_serve_run(model, f"{QWEN_MOE} serve", 4, 512, 32,
                         SERVE_FLAGS, repeat=True)
    emit(**line, params=n_params, active_params=n_active, init_s=init_s)
    layers = model.layers
    model.layers = torch.nn.ModuleList(layers[:LONG_PROMPT_LAYERS])
    model.cfg = dataclasses.replace(cfg, n_layers=LONG_PROMPT_LAYERS)
    try:
        line = moe_serve_run(model, f"{QWEN_MOE} long prompt", 1,
                             LONG_PROMPT, 2,
                             {**SERVE_FLAGS, "attn_impl": "chunked"},
                             repeat=False)
    finally:
        model.layers, model.cfg = layers, cfg
    emit(**line, params=n_params, active_params=n_active,
         shape="prefill_32k, batch cut from 32 to 1",
         layers_on_card=cfg.n_layers)
    del model
    free_card()


# ------------------------------------------------ the audio and VLM front ends

WHISPER = "whisper-tiny"
INTERNVL = "internvl2-2b"
# each front end's main-path serve run: parameters at full size, prompt
# tokens (whisper's 416 + 32 decoded reach position 447, the decoder's
# 448 limit; internvl2's 512 are 256 patches + 256 text tokens) and the
# positions a request's prefill fills
FRONT_ENDS = {
    WHISPER: dict(params=61_074_432, prompt_len=416, prefix=416),
    INTERNVL: dict(params=1_889_146_880, prompt_len=512, prefix=512),
}
FRONT_END_REL = 1e-4          # card against the CPU, of the largest logit


def logits_within(name, card, cpu, rel=FRONT_END_REL) -> float:
    """Check each (card, cpu) pair of logits within ``rel`` of the CPU's
    largest magnitude plus ``rel`` relative, as the serve tests hold the
    CPU to the reference; returns the largest gap over the largest."""
    worst = 0.0
    for got, want in ((card.prefill_logits, cpu.prefill_logits),
                      (card.decode_logits, cpu.decode_logits)):
        got, want = got.cpu().double(), want.double()
        scale = float(want.abs().max())
        gap = (got - want).abs()
        worst = max(worst, float(gap.max()) / scale)
        check(bool((gap <= rel * want.abs() + rel * scale).all()),
              f"{name}: card vs CPU logits differ by {float(gap.max())} "
              f"(largest logit {scale})")
    return worst


def front_end_full(arch):
    """The front end's main path at full width and depth (bf16, random
    weights from seed 0): 4 requests of ``FRONT_ENDS[arch]``'s prompt and
    32 decoded tokens after a 2-token warm-up, the counts set to 0 just
    before and read just after: no kernel launch, finite logits, tokens
    in range, the decode positions after the prefix, and the prefill run
    again on the same inputs giving the same bits. Returns the counts."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import SERVE_FLAGS, serve
    from repro_torch.models import make_batch, make_model, param_count, prefill
    cell = FRONT_ENDS[arch]
    cfg = get_config(arch)
    free_card()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = make_model(cfg, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = param_count(model)
    check(n_params == cell["params"] and model.embed.dtype == torch.bfloat16,
          f"{arch} has {n_params} parameters")
    run = dict(batch=4, prompt_len=cell["prompt_len"], flags=SERVE_FLAGS)
    serve(model, tokens=2, **run)                          # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out = serve(model, tokens=32, keep_logits=True, **run)
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(sum(counts.values()) == 0,
          f"{arch} serve launched kernels {counts}")
    check(out.prefix == cell["prefix"] and out.generated.shape == (4, 33)
          and bool(((out.generated >= 0)
                    & (out.generated < cfg.vocab_size)).all())
          and bool(torch.isfinite(out.prefill_logits).all())
          and bool(torch.isfinite(out.decode_logits).all()),
          f"{arch} serve: logits not finite, tokens out of range or "
          f"prefix {out.prefix}")
    # the same inputs serve drew (a CPU generator seeded 1), again
    inputs = {k: v.cuda() for k, v in make_batch(
        cfg, 4, cell["prompt_len"], torch.Generator().manual_seed(1)).items()}
    check(torch.equal(inputs["tokens"], out.prompt),
          f"{arch}: the prompt drawn again differs")
    again, _, memory = prefill(model, inputs,
                               cell["prompt_len"] + cfg.vision_prefix + 33,
                               SERVE_FLAGS)
    gap = float((again.float() - out.prefill_logits.float()).abs().max())
    check(torch.equal(again, out.prefill_logits),
          f"{arch}: the prefill run twice gives other logits (max gap "
          f"{gap})")
    emit(phase="main_path", run=f"{arch} serve", arch=arch,
         n_layers=cfg.n_layers, encoder_layers=cfg.encoder_layers,
         params=n_params, dtype="bfloat16", launches=counts, batch=4,
         prompt_len=cell["prompt_len"], text_tokens=out.prompt.shape[1],
         vision_prefix=cfg.vision_prefix,
         encoder_frames=None if memory is None else memory.shape[1],
         tokens=32, last_position=out.prefix + 31, init_s=init_s,
         prefill_s=out.prefill_s, decode_s=out.decode_s,
         prefill_tokens_per_s=out.prefill_tokens_per_s,
         decode_tokens_per_s=out.decode_tokens_per_s,
         peak_memory_gb=peak / 1e9, prefill_repeat_bit_equal=True,
         first_tokens=out.generated[0, :8].tolist())
    del model, out, again, memory
    free_card()
    return counts


def whisper_vs_cpu():
    """whisper-tiny at full width and depth in f32 served on the card
    against the port's CPU run with the same weights, frames, prompts and
    decode tokens: 2 x (1500 frames, 64 tokens) and 8 fed decode tokens,
    logits within 1e-4 of the CPU's largest (the tests tie the CPU to the
    reference at the scaled-down sizes)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import make_model
    cfg = dataclasses.replace(get_config(WHISPER), dtype=torch.float32)
    cpu_m = make_model(cfg, seed=0, device="cpu")
    card_m = make_model(cfg, seed=None)
    card_m.load_state_dict(cpu_m.state_dict())
    run = dict(batch=2, prompt_len=64, tokens=8, keep_logits=True)
    t0 = time.perf_counter()
    cpu = serve(cpu_m, **run)
    cpu_s = time.perf_counter() - t0
    card = serve(card_m, feed=cpu.generated, **run)
    worst = logits_within("whisper-tiny f32", card, cpu)
    emit(phase="whisper-tiny vs cpu", arch=WHISPER, dtype="float32",
         n_layers=cfg.n_layers, encoder_layers=cfg.encoder_layers,
         batch=2, frames=cfg.encoder_positions, prompt_len=64, tokens=8,
         max_rel_diff=worst, limit=FRONT_END_REL, cpu_s=cpu_s,
         card_prefill_s=card.prefill_s, card_decode_s=card.decode_s)
    del card_m, card
    free_card()


def front_ends_small_vs_cpu():
    """internvl2-2b at its ``scaled_down()`` sizes (f32, 8 patches) served
    on the card against the port's CPU run: 4 x 64 prompt positions (8
    patches + 56 text tokens) and 8 fed decode tokens, logits within
    1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import make_model
    small = get_config(INTERNVL).scaled_down()
    cpu_m = make_model(small, seed=0, device="cpu")
    card_m = make_model(small, seed=None)
    card_m.load_state_dict(cpu_m.state_dict())
    run = dict(batch=4, prompt_len=64, tokens=8, keep_logits=True)
    cpu = serve(cpu_m, **run)
    card = serve(card_m, feed=cpu.generated, **run)
    check(sum(card.prefill_launches.values())
          + sum(card.decode_launches.values()) == 0,
          f"scaled-down {INTERNVL} serve launched kernels")
    worst = logits_within(f"scaled-down {INTERNVL}", card, cpu)
    emit(phase="front_ends_small_vs_cpu", arch=small.name,
         max_rel_diff=worst, limit=FRONT_END_REL, batch=4, prompt_len=64,
         vision_prefix=small.vision_prefix, tokens=8)
    del card_m, card
    free_card()


def front_ends_serve():
    """Phase 9's front-end lines; returns the main-path serve counts."""
    counts = {}
    for arch in (WHISPER, INTERNVL):
        for k, v in front_end_full(arch).items():
            counts[k] = counts.get(k, 0) + v
    whisper_vs_cpu()
    front_ends_small_vs_cpu()
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


def client_grads(model, batch, n_clients):
    """Each client's gradient leaves (the reference's stacked leaves) for
    its rows of every batch leaf, computed once."""
    from repro_torch import interop
    from repro_torch.models import loss_fn
    leaves = interop.reference_leaves(model)
    rows = batch["tokens"].shape[0] // n_clients
    out = []
    for m in range(n_clients):
        model.zero_grad(set_to_none=True)
        loss, _ = loss_fn(model, {k: v[m * rows:(m + 1) * rows]
                                  for k, v in batch.items()})
        loss.backward()
        out.append([leaf.value(lambda p: p.grad) for leaf in leaves])
    model.zero_grad(set_to_none=True)
    return out


def psum_kernel_vs_plain(arch=TINYLLAMA, n_layers=2):
    """wireless_psum at the arch's full width (bf16; tinyllama cut to 2
    layers, whisper-tiny at full depth with its frames): the kernel route
    and the plain route on the same per-client gradients of an 8 x 128
    batch (the embedding's backward accumulates in no fixed order on the
    card, so the gradients are computed once), bit-equal in every mode;
    one epilogue launch a leaf (OTA), one quantizer launch a client and
    leaf (digital)."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core import rngstream
    from repro_torch.core.collectives import WirelessRound, wireless_psum
    from repro_torch.models import make_batch, make_model
    cfg = get_config(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = make_model(cfg, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(5)
    grads = client_grads(model, make_batch(cfg, 8, 128, gen), 4)
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
    emit(phase="psum_kernel_vs_plain", arch=arch, n_layers=cfg.n_layers,
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


def train_lines(arch, params, leaves, steps, profile=False):
    """The arch's FL train step at full width and depth (bf16, random
    weights from seed 0) through the launcher's ``train``, ``steps`` steps
    of 8 x 128 tokens over 4 clients under each aggregator, remat on;
    counts read around each run: exactly one ``ota_combine_keyed`` a
    reference leaf a step on OTA (none of the row entry) and one
    ``dithered_quantize`` a client and leaf on digital, nothing else;
    finite losses and parameters; the loss per step, steps/s, tokens/s,
    peak memory and, with ``profile``, one more step under the profiler
    after the counts were read: every launch on the card and its device
    time. Returns the counts."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train
    from repro_torch.models import make_model, param_count
    sys.path.insert(0, str(ROOT / "scripts"))
    from profile_port import profiled
    cfg = get_config(arch)
    n = TRAIN_RUN["n_clients"]
    per_step = {"ideal": {}, "ota": {"ota_combine_keyed": leaves},
                "digital": {"dithered_quantize": n * leaves}}
    total = {}
    for agg in ("ideal", "ota", "digital"):
        free_card()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = make_model(cfg, seed=0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = param_count(model)
        check(n_params == params
              and all(p.dtype == torch.bfloat16 for p in model.parameters()),
              f"{arch} has {n_params} parameters")
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        log = train(model, aggregator=agg, steps=steps, log=lambda s: None,
                    **TRAIN_RUN)
        seconds = time.perf_counter() - t0
        counts = kernels.launch_counts()
        for step_counts in log.launches:
            check(step_counts == {k: per_step[agg].get(k, 0)
                                  for k in step_counts},
                  f"{arch} {agg}: step launches {step_counts}")
        check(counts == {k: steps * per_step[agg].get(k, 0) for k in counts},
              f"{arch} {agg}: launches {counts}")
        check(all(np.isfinite(log.losses))
              and all(bool(torch.isfinite(p).all())
                      for p in model.parameters()),
              f"{arch} {agg}: losses {log.losses} or parameters not finite")
        extra = {}
        if profile:
            by_family, step_launches, busy_us, prof_wall = profiled(
                lambda: train(model, aggregator=agg, steps=1,
                              log=lambda s: None, **TRAIN_RUN))
            extra = dict(
                step_launches_profiled=step_launches,
                step_device_ms_profiled=busy_us / 1e3,
                step_wall_ms_profiled=prof_wall * 1e3,
                step_device_ms_by_family={k: v / 1e3 for k, v in sorted(
                    by_family.items(), key=lambda kv: -kv[1])})
        tokens = TRAIN_RUN["batch"] * TRAIN_RUN["seq"]
        emit(phase="main_path", run=f"{arch} train {agg}", arch=arch,
             n_layers=cfg.n_layers, params=n_params, leaves=leaves,
             dtype="bfloat16", aggregator=agg, clients=n, steps=steps,
             batch=TRAIN_RUN["batch"], seq=TRAIN_RUN["seq"], remat=True,
             launches=counts, loss=log.losses, step_s=log.step_s,
             seconds=seconds, init_s=init_s,
             steps_per_s=steps / sum(log.step_s),
             tokens_per_s=steps * tokens / sum(log.step_s),
             steady_steps_per_s=(steps - 1) / sum(log.step_s[1:]),
             steady_tokens_per_s=(steps - 1) * tokens / sum(log.step_s[1:]),
             peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, **extra)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        del model
    free_card()
    return total


def train_full():
    """The slice's main path: tinyllama-1.1b at full width and depth, 3
    FL steps under each aggregator (12 keyed epilogues, or 48 quantizer
    launches, a step), each with one more step profiled."""
    return train_lines(TINYLLAMA, TINYLLAMA_PARAMS, 12, steps=3,
                       profile=True)


WHISPER_LEAVES = 27
WHISPER_RUN = dict(batch=8, seq=128, n_clients=4)


def whisper_train():
    """whisper-tiny's FL train step at full width and depth (bf16, random
    weights from seed 0) through ``make_train_step``, which the text-only
    launcher does not drive: 3 steps of 8 x 128 decoder tokens with frames
    (8, 1500, 384) over 4 clients under each aggregator, each step's
    round made as the launcher makes it (its design, fading and weights);
    counts read around each step: exactly 27 ``ota_combine_keyed`` a step
    on OTA, 108 ``dithered_quantize`` (4 clients x 27 leaves) on digital,
    nothing else; finite losses and parameters. Returns the counts."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core import rngstream
    from repro_torch.core.channel import FadingProcess
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.steps import fl_round_arrays, make_train_step
    from repro_torch.models import make_batch, make_model, param_count
    from repro_torch.optim import SGDConfig
    cfg = get_config(WHISPER)
    n = WHISPER_RUN["n_clients"]
    dep, ota_p = train_mod.design(n, eta=1.0, g_max=10.0)
    taus, gam = ota_p.thresholds(), float(np.mean(ota_p.gammas))
    per_step = {"ideal": {}, "ota": {"ota_combine_keyed": WHISPER_LEAVES},
                "digital": {"dithered_quantize": n * WHISPER_LEAVES}}
    total = {}
    for agg in ("ideal", "ota", "digital"):
        free_card()
        torch.cuda.reset_peak_memory_stats()
        model = make_model(cfg, seed=0)
        n_params = param_count(model)
        check(n_params == FRONT_ENDS[WHISPER]["params"],
              f"whisper-tiny has {n_params} parameters")
        step = make_train_step(model, n_clients=n, aggregator=agg,
                               sgd=SGDConfig(eta=1.0),
                               batch=WHISPER_RUN["batch"],
                               seq=WHISPER_RUN["seq"])
        fading = FadingProcess(dep, seed=7)
        gen = torch.Generator(device="cuda").manual_seed(3)
        losses, step_s = [], []
        kernels.reset_launch_counts()
        for t in range(3):
            batch_in = make_batch(cfg, WHISPER_RUN["batch"],
                                  WHISPER_RUN["seq"], gen)
            fl = fl_round_arrays(
                n, gammas=ota_p.gammas / gam,
                chis=(fading.gains(t) >= taus).astype(np.float64),
                alpha=ota_p.alpha / gam,
                noise_scale=np.sqrt(ota_p.noise_psd) / ota_p.alpha * 1e-2,
                levels=255.0)
            torch.cuda.synchronize()
            c0 = kernels.launch_counts()
            ts = time.perf_counter()
            losses.append(float(step(batch_in, fl, rngstream.prng_key(t))))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - ts)
            c1 = kernels.launch_counts()
            got = {k: c1[k] - c0[k] for k in c0}
            check(got == {k: per_step[agg].get(k, 0) for k in got},
                  f"whisper-tiny {agg}: step {t} launches {got}")
        counts = kernels.launch_counts()
        check(counts == {k: 3 * per_step[agg].get(k, 0) for k in counts},
              f"whisper-tiny {agg}: launches {counts}")
        check(all(np.isfinite(losses))
              and all(bool(torch.isfinite(p).all())
                      for p in model.parameters()),
              f"whisper-tiny {agg}: losses {losses} or parameters not "
              f"finite")
        tokens = WHISPER_RUN["batch"] * WHISPER_RUN["seq"]
        emit(phase="main_path", run=f"whisper-tiny train {agg}",
             arch=WHISPER, n_layers=cfg.n_layers,
             encoder_layers=cfg.encoder_layers, params=n_params,
             leaves=WHISPER_LEAVES, dtype="bfloat16", aggregator=agg,
             clients=n, steps=3, batch=WHISPER_RUN["batch"],
             seq=WHISPER_RUN["seq"], frames=cfg.encoder_positions,
             launches=counts, loss=losses, step_s=step_s,
             steps_per_s=3 / sum(step_s),
             tokens_per_s=3 * tokens / sum(step_s),
             steady_steps_per_s=2 / sum(step_s[1:]),
             peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        del model, step
    free_card()
    return total


OPTIM_SCALE_ULPS = 16         # the tests' bound on the projection's scale


def optim_vs_cpu():
    """Adam and the projection on whisper-tiny's bf16 parameters (full
    size, seed 0), on the card against the CPU from the same parameters
    and the same gradients (one loss's, 2 x 128 tokens with frames, taken
    on the card once): 3 Adam steps with weight decay, parameters and
    both moments bit-equal; then the projection onto the ball of radius
    10 in the reference's leaf order: the scale within 16 ulps (its sums
    of squares are reductions, added in other orders on the card and on
    the CPU) and each parameter within 1 bf16 ulp."""
    import numpy as np
    import torch
    from repro_torch import interop
    from repro_torch.configs import get_config
    from repro_torch.models import loss_fn, make_batch, make_model
    from repro_torch.optim import (AdamConfig, adam_init, adam_update,
                                   project_l2_ball)
    cfg = get_config(WHISPER)
    card_m = make_model(cfg, seed=0)
    cpu_m = make_model(cfg, seed=None, device="cpu")
    cpu_m.load_state_dict(card_m.state_dict())
    loss, _ = loss_fn(card_m, make_batch(
        cfg, 2, 128, torch.Generator(device="cuda").manual_seed(11)))
    loss.backward()
    card_p = [p for leaf in interop.reference_leaves(card_m)
              for p in leaf.params]
    cpu_p = [p for leaf in interop.reference_leaves(cpu_m)
             for p in leaf.params]
    card_g = [p.grad for p in card_p]
    cpu_g = [g.cpu() for g in card_g]
    adam = AdamConfig(eta=1e-3, weight_decay=0.01)
    card_s, cpu_s = adam_init(card_p), adam_init(cpu_p)
    t0 = time.perf_counter()
    with torch.no_grad():
        for _ in range(3):
            card_s = adam_update(adam, card_p, card_g, card_s)
        torch.cuda.synchronize()
        card_adam_s = time.perf_counter() - t0
        for _ in range(3):
            cpu_s = adam_update(adam, cpu_p, cpu_g, cpu_s)

    def differing(a, b):
        return sum(int((x.cpu() != y).sum()) for x, y in zip(a, b))

    adam_diff = {"params": differing(card_p, cpu_p),
                 "m": differing(card_s["m"], cpu_s["m"]),
                 "v": differing(card_s["v"], cpu_s["v"])}
    check(sum(adam_diff.values()) == 0
          and int(card_s["step"]) == int(cpu_s["step"]) == 3,
          f"Adam on the card vs the CPU: entries differing {adam_diff}")
    card_scale = project_l2_ball(card_p, 10.0)
    cpu_scale = project_l2_ball(cpu_p, 10.0)

    def bits(t, shift):
        return (t.detach().cpu().float().numpy().view(np.int32)
                .astype(np.int64) >> shift)

    scale_ulps = int(abs(bits(card_scale, 0) - bits(cpu_scale, 0)))
    param_ulps = max(int(np.abs(bits(a, 16) - bits(b, 16)).max())
                     for a, b in zip(card_p, cpu_p))
    flipped = differing(card_p, cpu_p)
    check(float(cpu_scale) < 1.0 and scale_ulps <= OPTIM_SCALE_ULPS
          and param_ulps <= 1,
          f"projection on the card vs the CPU: scale {float(card_scale)} "
          f"against {float(cpu_scale)} ({scale_ulps} ulps), parameters "
          f"{param_ulps} bf16 ulps")
    emit(phase="optim_vs_cpu", arch=WHISPER, dtype="bfloat16",
         params=sum(p.numel() for p in card_p), adam_steps=3,
         weight_decay=0.01, adam_entries_differing=adam_diff,
         adam_bit_equal=True, card_adam_s=card_adam_s,
         projection_radius=10.0, scale_card=float(card_scale),
         scale_cpu=float(cpu_scale), scale_ulps=scale_ulps,
         scale_limit_ulps=OPTIM_SCALE_ULPS, param_max_bf16_ulps=param_ulps,
         params_differing=flipped)
    del card_m, card_p, card_g, card_s
    free_card()


def whisper_train_phase():
    """Phase 10's front-end lines; returns the main-path train counts."""
    psum_kernel_vs_plain(WHISPER, n_layers=None)
    counts = whisper_train()
    optim_vs_cpu()
    return counts


# ------------------------------------------------ remat and the dense archs

REMAT_SEQ = 2048
# each dense arch at full size: its parameters, reference leaves (one
# keyed epilogue a leaf on OTA, one quantizer a client and leaf on
# digital), its serve prompt (gemma3-4b's 1,536 go past its 1,024-token
# window) and whether its FL step fits one card (qwen3-8b's does not:
# PERF.md §4)
DENSE = {
    "llama3.2-1b": dict(params=1_498_482_688, leaves=12, prompt_len=512,
                        train=True),
    "qwen3-8b": dict(params=8_190_735_360, leaves=14, prompt_len=512,
                     train=False),
    "gemma3-4b": dict(params=4_551_013_888, leaves=113, prompt_len=1536,
                      train=True),
}


def remat_pass(model, batch, remat):
    """One loss and backward of ``model`` on ``batch`` with ``forward``'s
    ``remat`` set: (loss, {name: gradient}, seconds, peak bytes)."""
    import functools
    import torch
    from repro_torch.models import loss_fn
    model.zero_grad(set_to_none=True)
    free_card()
    torch.cuda.reset_peak_memory_stats()
    model.forward = functools.partial(type(model).forward, model,
                                      remat=remat)
    t0 = time.perf_counter()
    try:
        loss, _ = loss_fn(model, batch)
        loss.backward()
        torch.cuda.synchronize()
    finally:
        del model.forward
    seconds = time.perf_counter() - t0
    grads = {n: p.grad for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.detach(), grads, seconds, torch.cuda.max_memory_allocated()


def remat_line():
    """tinyllama-1.1b at full width and depth (bf16, seed 0), one client,
    one loss and backward over 1 x 2,048 tokens: twice with ``remat=False``
    (which gradient leaves the card repeats to the bit), then once with
    ``remat=True``: the loss bit-equal, and every gradient leaf bit-equal
    to the first pass, or, on a leaf the plain pass itself does not
    repeat, within its own repeat's largest gap; the seconds and peak
    memory of each pass. Returns the three peaks in bytes (each pass after
    the first runs beside the earlier passes' gradients, which the list
    of passes keeps)."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import make_batch, make_model
    cfg = get_config(TINYLLAMA)
    model = make_model(cfg, seed=0)
    batch = make_batch(cfg, 1, REMAT_SEQ,
                       torch.Generator(device="cuda").manual_seed(13))
    kernels.reset_launch_counts()
    passes = [remat_pass(model, batch, r) for r in (False, False, True)]
    counts = kernels.launch_counts()
    (loss0, g0, s0, p0), (loss1, g1, s1, p1), (loss2, g2, s2, p2) = passes

    def gaps(a, b):
        return {n: float((a[n].float() - b[n].float()).abs().max())
                for n in a if not torch.equal(a[n], b[n])}

    repeat, remat = gaps(g1, g0), gaps(g2, g0)
    check(sum(counts.values()) == 0, f"remat: kernels launched {counts}")
    check(bool(torch.isfinite(loss0)) and torch.equal(loss1, loss0)
          and torch.equal(loss2, loss0),
          f"remat: losses {float(loss0)}, {float(loss1)}, {float(loss2)}")
    check(all(n in repeat and v <= repeat[n] for n, v in remat.items()),
          f"remat: gradient leaves {remat} beyond the plain pass's own "
          f"repeat {repeat}")
    check(all(bool(torch.isfinite(g).all()) for g in g2.values()),
          "remat: gradients not finite")
    size = len(cfg.layer_pattern)
    emit(phase="remat", arch=TINYLLAMA, n_layers=cfg.n_layers,
         groups=cfg.n_layers // size, dtype="bfloat16", batch=1,
         seq=REMAT_SEQ, loss=float(loss0), loss_bit_equal=True,
         grad_leaves=len(g0), plain_repeat_differing=repeat,
         remat_differing=remat, grads_bit_equal=not remat,
         seconds_plain=[s0, s1], seconds_remat=s2,
         peak_memory_gb_plain=[p0 / 1e9, p1 / 1e9],
         peak_memory_gb_remat=p2 / 1e9)
    del model, passes, g0, g1, g2
    free_card()
    return [p0, p1, p2]


CHUNKED_REL = 1e-4            # the chunked route against einsum's, f32


def dense_serve(arch):
    """The dense arch at full width and depth (bf16, random weights from
    seed 0), 4 requests of ``DENSE[arch]``'s prompt and 32 decoded
    tokens after a 2-token warm-up, on the einsum route and then on the
    chunked route, the counts set to 0 just before each and read just
    after: no kernel launch, finite logits, tokens in range, the prefill
    run again giving the same bits. Then the gate of ``chunked_vs_einsum``
    at full width and depth: the same weights in f32, the two routes'
    prefill logits on the same prompt within 1e-4 of the einsum route's
    largest magnitude. In bf16 the routes differ by about 1e-2 of it (the
    chunked route rounds its probabilities to bf16 before dividing by
    their sum, einsum after), which the chunked line records. Returns the
    counts and the reading phase 12 holds its reckoning to: the einsum
    run's peak bytes and, for ``FLOPS_ARCH``, the matmul FLOPs
    ``FlopCounterMode`` counts over one more einsum prefill of the same
    prompt."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import SERVE_FLAGS, serve
    from repro_torch.models import make_model, param_count, prefill
    cell = DENSE[arch]
    cfg = get_config(arch)
    prompt = cell["prompt_len"]
    free_card()
    t0 = time.perf_counter()
    model = make_model(cfg, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = param_count(model)
    check(n_params == cell["params"] and model.embed.dtype == torch.bfloat16,
          f"{arch} has {n_params} parameters")
    total, lines, logits = {}, {}, {}
    for route in ("einsum", "chunked"):
        flags = {**SERVE_FLAGS, "attn_impl": route}
        name = f"{arch} serve" + (" chunked" if route == "chunked" else "")
        serve(model, batch=4, prompt_len=prompt, tokens=2, flags=flags)
        free_card()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        out = serve(model, batch=4, prompt_len=prompt, tokens=32,
                    keep_logits=True, flags=flags)
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        check(sum(counts.values()) == 0,
              f"{name}: the dense path launched kernels {counts}")
        check(out.generated.shape == (4, 33)
              and bool(((out.generated >= 0)
                        & (out.generated < cfg.vocab_size)).all())
              and bool(torch.isfinite(out.prefill_logits).all())
              and bool(torch.isfinite(out.decode_logits).all()),
              f"{name}: logits not finite or tokens out of range")
        again, _, _ = prefill(model, {"tokens": out.prompt}, prompt + 33,
                              flags)
        gap = float((again.float() - out.prefill_logits.float()).abs().max())
        check(torch.equal(again, out.prefill_logits),
              f"{name}: the prefill run twice gives other logits (max gap "
              f"{gap})")
        lines[route] = dict(
            phase="main_path", run=name, arch=arch, n_layers=cfg.n_layers,
            params=n_params, dtype="bfloat16", attn_impl=route,
            launches=counts, batch=4, prompt_len=prompt, tokens=32,
            window=cfg.window_size if "local" in cfg.layer_pattern
            else None, init_s=init_s, prefill_s=out.prefill_s,
            decode_s=out.decode_s,
            prefill_tokens_per_s=out.prefill_tokens_per_s,
            decode_tokens_per_s=out.decode_tokens_per_s,
            peak_memory_gb=peak / 1e9, prefill_repeat_bit_equal=True,
            first_tokens=out.generated[0, :8].tolist())
        logits[route] = out.prefill_logits
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        if route == "einsum":
            emit(**lines[route])
            reading = {"peak_bytes": peak}
            if arch == FLOPS_ARCH:
                from torch.utils.flop_counter import FlopCounterMode
                with FlopCounterMode(display=False) as fc:
                    prefill(model, {"tokens": out.prompt}, prompt + 33,
                            flags)
                reading["prefill_matmul_flops"] = fc.get_total_flops()
        tokens = out.prompt
        del out, again
    bf16_gap = logits_gap(logits["chunked"], logits["einsum"])
    del model, logits
    free_card()
    model = make_model(dataclasses.replace(cfg, dtype=torch.float32), seed=0)
    f32 = {route: prefill(model, {"tokens": tokens}, prompt + 33,
                          {**SERVE_FLAGS, "attn_impl": route})[0]
           for route in ("einsum", "chunked")}
    f32_gap = logits_gap(f32["chunked"], f32["einsum"])
    check(f32_gap <= CHUNKED_REL and bool(torch.isfinite(
        f32["chunked"]).all()),
          f"{arch} f32: chunked vs einsum prefill logits differ by "
          f"{f32_gap} of the largest")
    emit(**lines["chunked"], bf16_prefill_rel_gap_to_einsum=bf16_gap,
         f32_prefill_rel_gap_to_einsum=f32_gap, limit_f32=CHUNKED_REL)
    del model, f32
    free_card()
    return total, reading


def dense_train(arch):
    """The dense arch's FL train step at full size, 2 steps under each
    aggregator, no profiled step (``train_lines``)."""
    cell = DENSE[arch]
    return train_lines(arch, cell["params"], cell["leaves"], steps=2)


def dense_phase():
    """Phase 11's remat and dense-arch lines; returns the main-path
    counts of their serve and train runs, and the readings phase 12
    holds its reckonings to ({"remat": the three peaks, arch: the serve
    reading})."""
    readings = {"remat": remat_line()}
    counts = {}
    for arch, cell in DENSE.items():
        served, readings[arch] = dense_serve(arch)
        runs = [served] + ([dense_train(arch)] if cell["train"] else [])
        for c in runs:
            for k, v in c.items():
                counts[k] = counts.get(k, 0) + v
    return counts, readings


SERVE_PEAK_REL = 0.05         # reckoned serve peak against the card's
REMAT_PEAK_REL = 0.10         # reckoned remat-line peaks against the card's
FLOPS_ARCH = "llama3.2-1b"    # whose prefill FLOPs are counted on both


def reckon_serve(arch, reading):
    """Phase 12's serve cell: ``dense_serve``'s einsum run reckoned on the
    meta device (random-weight shapes, nothing on the card): a prefill of
    4 x the prompt into caches of prompt + 33 slots, then one decode
    step, as ``serve`` runs them. The reckoned peak within
    ``SERVE_PEAK_REL`` of the card's; for ``FLOPS_ARCH`` the prefill's
    matmul FLOPs equal to ``FlopCounterMode``'s on the card."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch import analysis
    from repro_torch.launch.serve import SERVE_FLAGS
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import make_model
    t0 = time.perf_counter()
    cfg = get_config(arch)
    prompt = DENSE[arch]["prompt_len"]
    cache_len = prompt + 33
    flags = {**SERVE_FLAGS, "attn_impl": "einsum"}
    model = make_model(cfg, seed=None, device="meta")
    prefill = make_prefill_step(model, batch=4, seq=prompt,
                                cache_len=cache_len, flags=flags)
    decode = make_decode_step(model, batch=4, cache_len=cache_len,
                              flags=flags)
    inputs = {"tokens": torch.empty(4, prompt, dtype=torch.int64,
                                    device="meta")}
    position = torch.empty(4, dtype=torch.int64, device="meta")

    def run():
        logits, caches, memory = prefill(inputs)
        token = torch.argmax(logits, -1)[:, None]
        return decode(token, position, caches, memory)

    before = kernels.launch_counts()
    out, counter, live = analysis.reckon(
        run, (list(model.parameters()), inputs))
    check(kernels.launch_counts() == before,
          f"{arch} reckoning launched kernels")
    peak, read = live.peak, reading["peak_bytes"]
    gap = (peak - read) / read
    check(abs(gap) <= SERVE_PEAK_REL,
          f"{arch} serve: reckoned peak {peak / 1e9} GB against "
          f"{read / 1e9} GB read, {gap:+.4f}")
    line = dict(phase="cost_report", cell=f"{arch} serve", batch=4,
                prompt_len=prompt, decode_steps=1,
                reckoned_peak_gb=peak / 1e9, read_peak_gb=read / 1e9,
                rel_gap=gap, limit=SERVE_PEAK_REL,
                memory=live.memory_summary(out),
                cost=analysis.cost_summary(counter),
                matmul_flops_by_dtype=dict(counter.matmul_flops),
                time_s=analysis.time_terms(counter))
    if "prefill_matmul_flops" in reading:
        _, pre, _ = analysis.reckon(lambda: prefill(inputs), ())
        flops = sum(pre.matmul_flops.values())
        check(flops == reading["prefill_matmul_flops"],
              f"{arch} prefill: {flops} matmul FLOPs reckoned on meta, "
              f"{reading['prefill_matmul_flops']} counted on the card")
        line.update(prefill_matmul_flops_meta=flops,
                    prefill_matmul_flops_card=reading[
                        "prefill_matmul_flops"], flops_equal=True)
    emit(**line, reckon_s=time.perf_counter() - t0)


def reckon_remat(read):
    """Phase 12's remat cell: ``remat_line``'s three passes (one loss and
    backward of tinyllama-1.1b over 1 x 2,048 tokens: plain, plain beside
    the first pass's gradients, remat beside two passes' gradients)
    reckoned on the meta device, each peak within ``REMAT_PEAK_REL`` of
    the card's."""
    import functools
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import analysis
    from repro_torch.models import loss_fn, make_model
    t0 = time.perf_counter()
    model = make_model(get_config(TINYLLAMA), seed=None, device="meta")
    params = list(model.parameters())
    batch = {"tokens": torch.empty(1, REMAT_SEQ, dtype=torch.int64,
                                   device="meta")}

    def loss_and_backward(remat):
        model.forward = functools.partial(type(model).forward, model,
                                          remat=remat)
        try:
            loss, _ = loss_fn(model, batch)
            loss.backward()
        finally:
            del model.forward
        return loss.detach()

    peaks = []
    for remat, held in ((False, 0), (False, 1), (True, 2)):
        model.zero_grad(set_to_none=True)
        kept = [torch.empty_like(p) for p in params for _ in range(held)]
        _, _, live = analysis.reckon(
            lambda: loss_and_backward(remat), (params, batch, kept),
            count_ops=False)
        peaks.append(live.peak)
    model.zero_grad(set_to_none=True)
    gaps = [(p - r) / r for p, r in zip(peaks, read)]
    check(all(abs(g) <= REMAT_PEAK_REL for g in gaps),
          f"remat: reckoned peaks {[p / 1e9 for p in peaks]} GB against "
          f"{[r / 1e9 for r in read]} GB read")
    emit(phase="cost_report", cell="remat", arch=TINYLLAMA, batch=1,
         seq=REMAT_SEQ, passes=["plain", "plain", "remat"],
         reckoned_peak_gb=[p / 1e9 for p in peaks],
         read_peak_gb=[r / 1e9 for r in read], rel_gap=gaps,
         limit=REMAT_PEAK_REL, reckon_s=time.perf_counter() - t0)


def cost_report_phase(readings):
    """Phase 12: the cells phase 11 has just measured, reckoned on the
    meta device with no weights on the card (``launch/analysis.py``) and
    held to the readings."""
    for arch in DENSE:
        reckon_serve(arch, readings[arch])
    reckon_remat(readings["remat"])


MESH_WORLD = 2                 # ranks of phase 13
MESH_ARCH = "llama3.2-1b"
MESH_LEAVES = 12              # llama3.2-1b's reference leaves
MESH_FIG2_ROUNDS = 40
MESH_OTA_REL = 1e-5           # sharded OTA against one rank, a round
#: the rank that runs each aggregator's one-card 2-client reference step
MESH_REFERENCE_RANK = {"ideal": 0, "ota": 0, "digital": 1}
MESH_NOTE = ("ranks share one card under gloo, their collectives through "
             "host copies: these seconds are not multi-card speeds")
#: fed leaves of the collective check: (shape, dtype name)
MESH_FED = (((16032, 2048), "bfloat16"), ((2048,), "float32"),
            ((16, 2048, 512), "bfloat16"), ((3, 1001), "float32"))


def fingerprint(model):
    """Two int64 sums of every parameter's bits (plain and weighted by
    position), one pair a parameter, on the card: equal parameters give
    equal fingerprints, and any flipped bit changes them."""
    import torch
    out = []
    for p in model.parameters():
        flat = p.detach().reshape(-1)
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        v = flat.view(ints[flat.element_size()]).to(torch.int64)
        w = torch.arange(v.numel(), device=v.device) % 65521 + 1
        out += [v.sum(), (v * w).sum()]
        del v, w
    return torch.stack(out)


def mesh_fed(mesh):
    """The mesh collective on fed leaves (each rank its client's, drawn
    from a seed; every client's drawn here too) against the one-card form
    over both clients, in each mode: (bit-equal, largest gap) a mode."""
    import torch
    from repro_torch.core import rngstream
    from repro_torch.core.collectives import WirelessRound, wireless_psum
    from repro_torch.launch.mesh import client_index, n_clients

    def leaves(m):
        g = torch.Generator(device="cuda").manual_seed(100 + m)
        return [(torch.randn(shape, generator=g, device="cuda") * (m + 1.5)
                 ).to(getattr(torch, dt)) for shape, dt in MESH_FED]

    n, c = n_clients(mesh), client_index(mesh)
    clients = [leaves(m) for m in range(n)]
    rinfo = WirelessRound(weight=torch.tensor([0.7, 1.3][:n]),
                          alpha=torch.tensor(2.5),
                          noise_scale=torch.tensor(1e-2),
                          levels=torch.tensor([255.0, 15.0][:n]))
    key = rngstream.prng_key(11)
    out = {}
    for mode in ("ideal", "ota", "digital"):
        got = wireless_psum(clients[c], rinfo, key, mode=mode, mesh=mesh)
        want = wireless_psum(iter(clients), rinfo, key, mode=mode)
        out[mode] = (all(same_bits(a, b) for a, b in zip(got, want)),
                     max(float((a.float() - b.float()).abs().max())
                         for a, b in zip(got, want)))
    return out


def mesh_train(mesh):
    """(a) llama3.2-1b's FL step at full size with one client a rank, one
    ideal, one OTA and one digital step from the same weights, batch and
    key: each rank's launches, loss, seconds and parameter fingerprint,
    and every parameter held against the one-card 2-client step from the
    same weights. The one-card steps run first, on both ranks at once
    (``MESH_REFERENCE_RANK``: rank 0 the ideal and OTA steps, rank 1 the
    digital one), and hold the first forward and backward of each rank's
    process; each rank compares its own after the mesh steps."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core import dist, rngstream
    from repro_torch.launch.mesh import client_index, n_clients
    from repro_torch.launch.steps import fl_round_arrays, make_train_step
    from repro_torch.launch.train import synthetic_token_batch
    from repro_torch.models import make_model, param_count
    from repro_torch.optim import SGDConfig
    n, c = n_clients(mesh), client_index(mesh)
    model = make_model(get_config(MESH_ARCH), seed=0)
    init = [p.detach().clone() for p in model.parameters()]
    batch = {k: v.cuda() for k, v in synthetic_token_batch(
        np.random.default_rng(0), model.cfg.vocab_size, TRAIN_RUN["batch"],
        TRAIN_RUN["seq"]).items()}
    kw = dict(gammas=np.array([0.8, 1.2]), alpha=1.5, noise_scale=1e-3,
              levels=255.0)
    sgd = SGDConfig(eta=1e-2)
    key = rngstream.prng_key(0)
    out = {"params": param_count(model)}
    aggs = ("ideal", "ota", "digital")

    def reset():
        with torch.no_grad():
            for p, p0 in zip(model.parameters(), init):
                p.copy_(p0)

    refs = {}
    for agg in aggs:
        if MESH_REFERENCE_RANK[agg] == c:
            reset()
            one = make_train_step(model, n_clients=n, aggregator=agg,
                                  sgd=sgd, batch=TRAIN_RUN["batch"],
                                  seq=TRAIN_RUN["seq"])
            refs[agg] = (float(one(batch, fl_round_arrays(n, **kw), key)),
                         [p.detach().clone() for p in model.parameters()])
    for agg in aggs:
        reset()
        step = make_train_step(model, mesh=mesh, aggregator=agg, sgd=sgd,
                               batch=TRAIN_RUN["batch"], seq=TRAIN_RUN["seq"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        loss = float(step(batch, fl_round_arrays(mesh, **kw), key))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = kernels.launch_counts()
        fp = dist.all_gather_cat(fingerprint(model)[None])
        held = sum(t.numel() * t.element_size()
                   for _, kept in refs.values() for t in kept)
        row = dict(loss=loss, seconds=seconds, launches=counts,
                   ranks_identical=bool((fp == fp[0]).all()),
                   finite=all(bool(torch.isfinite(p).all())
                              for p in model.parameters()),
                   peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                   held_reference_gb=held / 1e9)
        if agg in refs:
            one_loss, theirs = refs.pop(agg)
            mine = [p.detach() for p in model.parameters()]
            gaps = [(a.float() - b.float()).abs()
                    for a, b in zip(mine, theirs)]
            row.update(one_card_loss=one_loss,
                       one_card_equal=one_loss == loss and all(
                           same_bits(a, b) for a, b in zip(mine, theirs)),
                       params_differing=int(sum(int((g > 0).sum())
                                                for g in gaps)),
                       max_param_gap=max(float(g.max()) for g in gaps))
            del theirs, gaps
        torch.distributed.barrier()
        out[agg] = row
    del model, init
    free_card()
    return out


def mesh_fig2(mesh, ota_p, dig_p):
    """(b) Fig. 2 ProposedOTA (N = 50) and ProposedDigital (N = 10) at d =
    7850, 4 trials over the ranks with ``shard_trials=True``, 40 rounds:
    each rank's launches, seconds and run; rank 0 also runs the 4 trials
    on its own (one rank) and compares."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.core import baselines as B
    from repro_torch.fl import FLTrainer
    from repro_torch.launch.mesh import client_index
    out = {}
    for name, n_dev, per_class, agg, kw in (
            ("ota", 50, 6000, B.ProposedOTA(ota_p), dict(eval_every=1)),
            ("digital", 10, 1200, B.ProposedDigital(dig_p),
             dict(eval_every=1, time_budget_s=150.0))):
        task, ds, dep, eta = fig2_setup(n_dev, per_class)
        run = dict(rounds=MESH_FIG2_ROUNDS, trials=4, seed=0, **kw)
        trainer = FLTrainer(task, ds, dep, eta, shard_trials=True)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        log = trainer.run(agg, **run)
        torch.cuda.synchronize()
        row = dict(seconds=time.perf_counter() - t0,
                   launches=kernels.launch_counts(),
                   loss=log.global_loss.mean(0).tolist())
        if client_index(mesh) == 0:
            t0 = time.perf_counter()
            one = FLTrainer(task, ds, dep, eta).run(agg, **run)
            row["one_rank_seconds"] = time.perf_counter() - t0
            rel = np.abs(log.global_loss - one.global_loss) / np.abs(
                one.global_loss)
            row.update(
                one_rank_equal=bool(
                    np.array_equal(log.global_loss, one.global_loss)
                    and np.array_equal(log.accuracy, one.accuracy)
                    and np.array_equal(log.wall_time_s, one.wall_time_s)),
                max_rel_gap=float(rel.max()))
        torch.distributed.barrier()
        out[name] = row
    return out


def mesh_rank(rank, ota_p, dig_p):
    """Phase 13 in one rank: its backend, world and device, then the fed
    collective, (a) and (b)."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(device_type="cuda")
    out = dict(rank=rank, world=dist.get_world_size(),
               backend=dist.get_backend(),
               device=f"cuda:{torch.cuda.current_device()}",
               mesh=dict(mesh.shape))
    t0 = time.perf_counter()
    out["fed"] = mesh_fed(mesh)
    out["train"] = mesh_train(mesh)
    out["fig2"] = mesh_fig2(mesh, ota_p, dig_p)
    out["rank_seconds"] = time.perf_counter() - t0
    return out


def mesh_phase(ota_p, dig_p):
    """Phase 13: two ranks on the cards present (sharing card 0 under gloo
    on a one-card machine, NCCL with two cards), one FL client a rank.
    Returns the ranks' main-path launches, summed."""
    import torch
    from repro_torch.launch import distributed
    free_card()
    t0 = time.perf_counter()
    ranks = distributed.spawn(mesh_rank, MESH_WORLD, device="cuda",
                              store_dir=ROOT / "build" / "mesh",
                              args=(ota_p, dig_p))
    seconds = time.perf_counter() - t0
    cards = torch.cuda.device_count()
    want_backend = distributed.backend_for("cuda", MESH_WORLD, cards)
    emit(phase="mesh_ranks", note=MESH_NOTE, world=MESH_WORLD, cards=cards,
         ranks=[{k: r[k] for k in ("rank", "world", "backend", "device",
                                    "mesh", "rank_seconds")}
                for r in ranks])
    check(all(r["backend"] == want_backend and r["world"] == MESH_WORLD
              for r in ranks), f"ranks' backends {[r['backend'] for r in ranks]}")
    for r in ranks:
        for mode, (equal, gap) in r["fed"].items():
            check(equal, f"rank {r['rank']}: the mesh {mode} collective on "
                         f"fed leaves differs from the one-card form by {gap}")
    emit(phase="mesh_fed_vs_one_card", leaves=[list(s) + [dt] for s, dt in
                                               MESH_FED],
         modes={m: ranks[0]["fed"][m][0] for m in ranks[0]["fed"]})
    per_step = {"ideal": {}, "ota": {"ota_combine_keyed": MESH_LEAVES},
                "digital": {"dithered_quantize": MESH_LEAVES}}
    total = {}
    for agg in ("ideal", "ota", "digital"):
        rows = [r["train"][agg] for r in ranks]
        lead = rows[0]
        for r, row in zip(ranks, rows):
            check(row["launches"] == {k: per_step[agg].get(k, 0)
                                      for k in row["launches"]},
                  f"{agg} rank {r['rank']}: launches {row['launches']}")
            check(row["ranks_identical"] and row["finite"],
                  f"{agg}: ranks' parameters differ or are not finite")
            for k, v in row["launches"].items():
                total[k] = total.get(k, 0) + v
        check(all(row["loss"] == lead["loss"] for row in rows),
              f"{agg}: ranks' losses {[row['loss'] for row in rows]}")
        ref = rows[MESH_REFERENCE_RANK[agg]]
        emit(phase="main_path", run=f"{MESH_ARCH} mesh train {agg}",
             note=MESH_NOTE, params=ranks[0]["train"]["params"],
             ranks=MESH_WORLD, clients=MESH_WORLD, batch=TRAIN_RUN["batch"],
             seq=TRAIN_RUN["seq"], loss=lead["loss"],
             one_card_rank=MESH_REFERENCE_RANK[agg],
             one_card_loss=ref["one_card_loss"],
             one_card_equal=ref["one_card_equal"],
             params_differing=ref["params_differing"],
             max_param_gap=ref["max_param_gap"], ranks_identical=True,
             launches_per_rank=[row["launches"] for row in rows],
             step_s_per_rank=[row["seconds"] for row in rows],
             peak_memory_gb_per_rank=[row["peak_memory_gb"]
                                      for row in rows],
             held_reference_gb_per_rank=[row["held_reference_gb"]
                                         for row in rows])
    for name, want in (("ota", {"ota_combine": MESH_FIG2_ROUNDS}),
                       ("digital",
                        {"dithered_quantize_rows": MESH_FIG2_ROUNDS})):
        rows = [r["fig2"][name] for r in ranks]
        lead = rows[0]
        for r, row in zip(ranks, rows):
            check(row["launches"] == {k: want.get(k, 0)
                                      for k in row["launches"]},
                  f"Fig. 2 {name} rank {r['rank']}: launches "
                  f"{row['launches']}")
            check(row["loss"] == lead["loss"],
                  f"Fig. 2 {name}: ranks return different runs")
            for k, v in row["launches"].items():
                total[k] = total.get(k, 0) + v
        if name == "ota":
            check(lead["max_rel_gap"] <= MESH_OTA_REL,
                  f"Fig. 2 ota sharded vs one rank: {lead['max_rel_gap']}")
        else:
            check(lead["one_rank_equal"],
                  f"Fig. 2 digital sharded vs one rank: not bit-equal, "
                  f"largest gap {lead['max_rel_gap']}")
        emit(phase="main_path", run=f"Fig. 2 {name} shard_trials",
             note=MESH_NOTE, ranks=MESH_WORLD, trials=4,
             rounds=MESH_FIG2_ROUNDS, loss=lead["loss"],
             one_rank_equal=lead["one_rank_equal"],
             max_rel_gap=lead["max_rel_gap"],
             one_rank_seconds=lead["one_rank_seconds"],
             launches_per_rank=[row["launches"] for row in rows],
             seconds_per_rank=[row["seconds"] for row in rows])
    emit(phase="mesh_done", note=MESH_NOTE, seconds=seconds)
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
    from repro_torch.launch import distributed
    t_start = time.perf_counter()
    phase_start = {}                # numbered phase: its start
    # phase 13's ranks fork from this server; its imports run beside
    # phases 1-12
    distributed.prestart()

    phase_start[1] = time.perf_counter()
    # 1. device
    resolve_device()
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    emit(phase="device", name=name, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    phase_start[2] = time.perf_counter()
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

    phase_start[3] = time.perf_counter()
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

    phase_start[4] = time.perf_counter()
    # 4. the design solver on the card; Fig. 2's designs feed the main path
    ota_p, dig_p = design_phase()
    designed = (ota_p, dig_p)
    free_card()

    phase_start[5] = time.perf_counter()
    # 5. the main paths: Fig. 2 and Fig. 3 at full width
    launches, main_logs = {}, {}

    def main_run(*args, **kw):
        counts, main_logs[args[0]] = run_path(*args, **kw)
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

    phase_start[6] = time.perf_counter()
    # 6. the scenario layer: Fig. 2 and Fig. 3 as ScenarioSpecs through
    # execute on the card, each re-run from its cache; the card against
    # the CPU; the command line
    for k, v in scenario_phase().items():
        launches[k] = launches.get(k, 0) + v
    free_card()

    phase_start[7] = time.perf_counter()
    # 7. the fault, participation and async layers: the main path's runs
    # under each, then the three robustness sweeps through execute
    for k, v in layers_phase(*designed,
                             main_logs["Fig. 2 ProposedOTA"]).items():
        launches[k] = launches.get(k, 0) + v
    free_card()

    phase_start[8] = time.perf_counter()
    # 8. mini-batches and rng="fast": the fast runs beside replay, the
    # streams on the card against the CPU, fig2_batch through execute
    for k, v in streams_phase(*designed).items():
        launches[k] = launches.get(k, 0) + v
    free_card()

    phase_start[9] = time.perf_counter()
    # 9. serve falcon-mamba-7b, then recurrentgemma-2b: the kernel against
    # its plain version at full width cut to one pattern, the card against
    # the CPU at the reduced sizes, then the main path at full width and
    # depth
    for arch in (MAMBA, RGEMMA):
        serve_kernel_vs_plain(arch)
        serve_small_vs_cpu(arch)
        for k, v in serve_full(arch).items():
            launches[k] = launches.get(k, 0) + v
    # then the MoE models and the chunked attention, which launch no
    # kernel: the scaled-down MoE models on the card against the CPU, the
    # two attention routes against each other, then qwen3-moe-30b-a3b at
    # full width and depth, at 4 x 512 and on a 32,768-token prompt
    free_card()
    moe_small_vs_cpu()
    chunked_vs_einsum()
    moe_full()
    # then the audio and VLM front ends, which launch no kernel either:
    # whisper-tiny and internvl2-2b at full width and depth, whisper-tiny
    # in f32 and internvl2-2b scaled down on the card against the CPU
    for k, v in front_ends_serve().items():
        launches[k] = launches.get(k, 0) + v

    phase_start[10] = time.perf_counter()
    # 10. FL-LM training: the collective's kernel route against its plain
    # route at 2 layers of tinyllama's width, the scaled-down train step
    # on the card against the CPU, then the main path at full width and
    # depth
    psum_kernel_vs_plain()
    train_small_vs_cpu()
    for k, v in train_full().items():
        launches[k] = launches.get(k, 0) + v
    # then whisper-tiny: the collective's two routes on its 27 leaves, its
    # train step at full width through make_train_step, and Adam and the
    # projection on its parameters, card against CPU
    for k, v in whisper_train_phase().items():
        launches[k] = launches.get(k, 0) + v

    phase_start[11] = time.perf_counter()
    # 11. layer-group remat on tinyllama-1.1b at full size, then the three
    # dense archs at full width and depth: llama3.2-1b, qwen3-8b and
    # gemma3-4b served on both attention routes, llama3.2-1b and gemma3-4b
    # FL-trained under each aggregator
    counts, readings = dense_phase()
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v

    phase_start[12] = time.perf_counter()
    # 12. the cost report: phase 11's serve and remat cells reckoned on the
    # meta device (no weights on the card) against what the card read
    cost_report_phase(readings)

    phase_start[13] = time.perf_counter()
    # 13. the client and trial axes across ranks: two ranks on the card(s),
    # llama3.2-1b's FL step with one client a rank and Fig. 2's trials
    # over the ranks
    for k, v in mesh_phase(*designed).items():
        launches[k] = launches.get(k, 0) + v

    phase_start[14] = time.perf_counter()
    # 14. the kernel table at the main path's shapes and types (launches:
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
    ends = sorted(phase_start.items()) + [(None, time.perf_counter())]
    emit(phase="phase_seconds", seconds={
        str(n): end - start for (n, start), (_, end) in zip(ends, ends[1:])},
         before_phase_1=phase_start[1] - T_IMPORT)
    emit(phase="done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": table}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
