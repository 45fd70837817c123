#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. device — the card's name and count, and nvidia-smi's name and power
   limit line;
2. build — nvcc builds the three sources of
   ``src/repro_torch/kernels/csrc`` (one process per source, all started
   together), with ptxas' register report;
3. kernels — each of the five kernels against its plain PyTorch version
   on the card, bit-equal, at the main path's shapes and at large ones,
   with degenerate and ragged rows; the payload decoder ``unpack(pack(g))``
   also bit-equal to the two-step quantizer kernel on the same inputs;
   device times of kernel, plain version and the one PyTorch call
   computing the same function (where there is one), beside the least
   time the card could take (bytes over 3.35 TB/s or operations over the
   peak rate, whichever is larger);
4. main path — the paper's experiments at full width through the port's
   ``FLTrainer`` on the card, parameters from the closed-form design
   anchors:
     Fig. 2 (softmax regression, d = 7850): ProposedOTA (N = 50 devices,
     1000 samples each, 4 trials, 30 rounds) and ProposedDigital (N = 10,
     4 trials, 40 rounds, 150 s budget; then 20 rounds under a 1 s budget
     that stops it mid-run);
     Fig. 3 (MLP 3072 -> 48 -> 10, d = 147,994, N = 10 devices with two
     classes and 100 samples each, 4 trials): ProposedOTA (30 rounds) and
     ProposedDigital (40 rounds), the latter on the fused route (8-bit
     codes packed once a round, one packed weighted sum a round, no
     two-step quantizer).
   Each run's launch counts start at 0 and must be the expected ones;
   the loss must be finite and fall; the same run with the plain versions
   (``use_kernel=False``) must give the same trajectory to the bit; the
   dither stream made on the card must equal the CPU's to the bit; both
   schemes at a small size and at Fig. 3 width must agree with the port's
   CPU run (which the tests tie to the JAX reference);
5. the kernel table, nvidia-smi's line, and the result line.
"""
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


def emit(**kw):
    print(json.dumps(kw), flush=True)


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


def quant_case(rows, d, dt, seed):
    import torch
    from repro_torch.kernels import dithered_quantize_rows, ref
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = torch.randn(rows, d, generator=gen, device="cuda", dtype=dt)
    g = g * (torch.rand(rows, 1, generator=gen, device="cuda", dtype=dt) * 5)
    g[1] = 0.0                                    # m = 0: all-zero row
    u = torch.rand(rows, d, generator=gen, device="cuda")
    bits = torch.randint(1, 17, (rows,), generator=gen, device="cuda")
    levels = (2.0 ** bits.to(dt)) - 1.0
    levels[2] = 0.0                               # a device with no bits
    m = g.abs().amax(1)
    scal = torch.stack([m, levels], 1).contiguous()
    out = dithered_quantize_rows(g, u, scal)
    plain = ref.dithered_quantize_rows_ref(g, u, m, levels)
    torch.cuda.synchronize()
    check(out.shape == (rows, d) and bool(torch.isfinite(out).all()),
          "dithered_quantize_rows output")
    err = float((out - plain).abs().max())
    check(torch.equal(out, plain),
          f"dithered_quantize_rows != plain at ({rows}, {d}) {dt}: "
          f"max err {err}")
    check(bool((out[1:3] == 0).all()), "degenerate rows must quantize to 0")
    # this run's data: invalid rows read nothing and only write zeros
    live = int(((m > 0) & (levels > 0)).sum())
    s = g.element_size()
    nbytes = live * d * (s + 4) + rows * d * s + rows * 2 * s
    iters = 50 if nbytes < 64e6 else 4
    ms = device_ms(lambda: dithered_quantize_rows(g, u, scal), iters)
    plain_ms = device_ms(
        lambda: ref.dithered_quantize_rows_ref(g, u, m, levels), iters)
    b_ms, b_by = bound(nbytes, 10 * live * d, str(dt).split(".")[1])
    return dict(shape=[rows, d], dtype=str(dt).split(".")[1],
                max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=b_ms, bound_by=b_by)


PAYLOAD_SOURCE = "src/repro_torch/kernels/csrc/payload.cu"


def payload_case(rows, d, dt, cb, seed, trials):
    """The three payload kernels on one set of rows, each against its plain
    version; rows = trials x devices for the weighted sum. Row 1 is all
    zero (m = 0), row 2 has no bits (L = 0), and one more device is out of
    the round (weight 0)."""
    import torch
    from repro_torch.kernels import (dithered_quantize_rows,
                                     packed_weighted_sum, quantize_pack_rows,
                                     ref, unpack_dequant_rows)
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
    w[-1, -1] = 0.0
    scal3 = torch.cat([scal.reshape(trials, n, 2), w[..., None]],
                      -1).contiguous()
    tag = f"({rows}, {d}) {dt} code_bits {cb}"

    words = quantize_pack_rows(g, u, scal, cb)
    words_p = ref.quantize_pack_rows_ref(g, u, scal, cb)
    out = unpack_dequant_rows(words, scal, cb, d)
    out_p = ref.unpack_dequant_rows_ref(words, scal, cb, d)
    two_step = dithered_quantize_rows(g, u, scal)
    words4 = words.reshape(trials, n, *words.shape[1:])
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
    check(torch.equal(out, out_p), f"unpack_dequant_rows != plain at {tag}")
    check(torch.equal(out, two_step),
          f"unpack(pack(g)) != dithered_quantize_rows kernel at {tag}")
    check(acc.shape == (trials, d) and bool(torch.isfinite(acc).all()),
          "packed_weighted_sum output")
    check(torch.equal(acc, acc_p), f"packed_weighted_sum != plain at {tag}")

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
            max_abs_err=errs[kname], ms=device_ms(fn, iters),
            plain_ms=device_ms(plain_fn, iters), library_ms=None,
            bound_ms=b_ms, bound_by=b_by)
    return out_rows


# --------------------------------------------------------------- main path

def fig2_setup(n_devices, n_train_per_class, t_max_s=0.2):
    """The Fig. 2 cell at full width: MNIST-like data, one class and 1000
    samples per device, closed-form design anchors."""
    import numpy as np
    from repro_torch.core import ota_design, digital_design
    from repro_torch.core.bounds import ObjectiveWeights
    from repro_torch.core.channel import WirelessConfig, make_deployment
    from repro_torch.data import (FLDataset, SyntheticSpec,
                                  make_classification_dataset,
                                  partition_by_class)
    from repro_torch.fl import SoftmaxRegressionTask
    spec = SyntheticSpec(n_train_per_class=n_train_per_class,
                         n_test_per_class=200, noise_sigma=1.5, seed=0)
    x_tr, y_tr, x_te, y_te = make_classification_dataset(spec)
    ds = FLDataset.from_shards(
        partition_by_class(x_tr, y_tr, n_devices, 1, 1000, seed=3),
        x_te, y_te)
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
    ota_params = ota_design.params_from_gamma(
        ospec, ota_design.anchor_min_noise(ospec))
    # the uniform anchor at a 15% participation target: the higher rates
    # fit 9-bit payloads in the 0.2 s budget; at the default 80% target
    # only 1 bit fits, whose quantization noise swamps the step
    dig_params = digital_design.finalize(
        dspec, *digital_design.anchor_uniform(dspec, beta0=0.15))
    check(np.isfinite(ota_params.alpha) and dig_params.r_bits.min() >= 1,
          "design anchors")
    return task, ds, dep, eta, ota_params, dig_params


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


def run_path(name, trainer, engine_plain, agg, expect, bites=False, **run):
    """Drive one scheme through the trainer with the launch counts at 0,
    read them just after, then the same run on the plain versions; both
    must agree bit for bit. ``expect`` maps kernels to the launches the
    run must make. With ``bites``, the run's ``time_budget_s`` must stop
    it mid-run: the wall-clock and the model freeze over the last eval
    slots."""
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
    check(loss[:, -1].mean() < loss[:, 0].mean(),
          f"{name}: loss did not fall: {loss.mean(0).tolist()}")
    wall = log.wall_time_s
    if bites:
        check(wall[1] < wall[-1] and wall[-1] == wall[-2]
              and wall[-1] >= run["time_budget_s"]
              and np.array_equal(loss[:, -1], loss[:, -2]),
              f"{name}: the budget did not stop the run mid-way: "
              f"wall {wall.tolist()}, loss {loss.mean(0).tolist()}")
    else:
        check(np.all(np.diff(wall) > 0) and wall[-1] < run.get(
            "time_budget_s", np.inf),
              f"{name}: the budget bit: wall {wall.tolist()}")
    plain = engine_plain.run(agg, **run)
    check(np.array_equal(plain.global_loss, log.global_loss)
          and np.array_equal(plain.accuracy, log.accuracy)
          and np.array_equal(plain.wall_time_s, log.wall_time_s),
          f"{name}: kernel and plain trajectories differ: "
          f"{log.global_loss.tolist()} vs {plain.global_loss.tolist()}")
    emit(phase="main_path", run=name, scheme=log.scheme, launches=counts,
         rounds=run["rounds"], trials=run["trials"],
         time_budget_s=run.get("time_budget_s"), budget_bites=bites,
         seconds=seconds, rounds_per_s=run["rounds"] / seconds,
         loss=log.global_loss.mean(0).tolist(),
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


def small_matches_cpu():
    """The port at a small size on the card against its CPU run, for
    both schemes of the main path (the tests tie the CPU run to the JAX
    reference): 8x8 images (d = 650), 6 devices, the closed-form
    anchors."""
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
    # ulps may flip a dither code, the tests' port-vs-JAX slack
    for agg, rel_tol in (
            (B.ProposedOTA(ota_design.params_from_gamma(
                ospec, ota_design.anchor_min_noise(ospec)),
                label="Proposed OTA-FL (min-noise anchor)"), 1e-5),
            (B.ProposedDigital(digital_design.finalize(
                dspec, *digital_design.anchor_uniform(dspec)),
                label="Proposed Digital FL (uniform anchor)"), 1e-3)):
        run = dict(rounds=20, trials=2, eval_every=10, seed=5)
        card = FLTrainer(task, ds, dep, eta).run(agg, **run)
        cpu = FLTrainer(task, ds, dep, eta, device="cpu").run(agg, **run)
        rel = float(np.max(np.abs(card.global_loss - cpu.global_loss)
                           / np.abs(cpu.global_loss)))
        check(rel <= rel_tol and np.array_equal(card.wall_time_s,
                                                cpu.wall_time_s),
              f"{card.scheme}: card vs CPU loss differs by {rel} relative "
              f"(limit {rel_tol}) or wall-clock differs")
        emit(phase="small_vs_cpu", scheme=card.scheme, max_rel_loss_diff=rel,
             limit=rel_tol, wall_time_equal=True)


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
                  "packed_weighted_sum"])

    # 3. kernels against their plain versions
    f64, f32, bf16 = torch.float64, torch.float32, torch.bfloat16
    ota_rows, quant_rows = {}, {}
    for shape in ((4, 7850), (4, 147994), (4, 1 << 24)):
        for gdt in (f64, f32, bf16):
            r = ota_case(*shape, gdt, seed=shape[1] % 97)
            emit(phase="kernel", kernel="ota_combine", **r)
            ota_rows[(shape, gdt)] = r
    for shape in ((40, 7850), (50, 7850), (64, 1 << 20), (5, 1001)):
        for dt in (f64, f32):
            r = quant_case(*shape, dt, seed=shape[0])
            emit(phase="kernel", kernel="dithered_quantize_rows", **r)
            quant_rows[(shape, dt)] = r
    # the payload kernels: the Fig. 3 main path (4 trials x 10 devices,
    # f64, 8-bit codes), the other code widths, the payload benchmark's
    # case (BENCH_kernel_payload.json: 256 devices x 10^6, f32), and
    # ragged widths
    payload_rows = {}
    for rows, d, dt, cb, trials in (
            (40, 147994, f64, 8, 4), (40, 147994, f32, 8, 4),
            (40, 147994, f64, 4, 4), (40, 147994, f64, 16, 4),
            (256, 1000000, f32, 8, 1),
            (6, 1000, f64, 8, 2), (6, 1000, f32, 16, 2),
            (4, 131073, f64, 8, 2), (4, 131073, f32, 4, 2)):
        rs = payload_case(rows, d, dt, cb, seed=d + cb, trials=trials)
        for kname, r in rs.items():
            emit(phase="kernel", kernel=kname, **r)
            payload_rows.setdefault(kname, {})[(rows, d, dt, cb)] = r

    # 4. the main paths: Fig. 2 and Fig. 3 at full width
    launches = {}

    def main_run(*args, **kw):
        counts = run_path(*args, **kw)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    none = {"quantize_pack_rows": 0, "packed_weighted_sum": 0,
            "unpack_dequant_rows": 0}
    task, ds, dep, eta, ota_p, _ = fig2_setup(50, 6000)
    trainer = FLTrainer(task, ds, dep, eta)
    plain = FLEngine(task, ds, dep, eta, use_kernel=False)
    main_run("Fig. 2 ProposedOTA", trainer, plain,
             B.ProposedOTA(ota_p, label="Proposed OTA-FL (min-noise "
                                         "anchor)"),
             {"ota_combine": 30, "dithered_quantize_rows": 0, **none},
             rounds=30, trials=4, eval_every=10, seed=0)
    del trainer, plain
    task, ds, dep, eta, _, dig_p = fig2_setup(10, 1200)
    trainer = FLTrainer(task, ds, dep, eta)
    plain = FLEngine(task, ds, dep, eta, use_kernel=False)
    dig = B.ProposedDigital(dig_p, label="Proposed Digital FL (uniform "
                                         "anchor)")
    main_run("Fig. 2 ProposedDigital", trainer, plain, dig,
             {"dithered_quantize_rows": 40, "ota_combine": 0, **none},
             rounds=40, trials=4, eval_every=20, seed=0,
             time_budget_s=150.0)
    # the same scheme under a budget that stops every trial by round 12
    # of 20 (a round takes ~0.16 s of simulated airtime on average)
    main_run("Fig. 2 ProposedDigital, budget", trainer, plain, dig,
             {"dithered_quantize_rows": 20, **none}, bites=True,
             rounds=20, trials=4, eval_every=4, seed=0, time_budget_s=1.0)
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
              "ota_combine": 0},
             rounds=40, trials=4, eval_every=20, seed=9)
    del trainer, plain
    dither_matches_cpu(4, 10, 7850, (0, 1, 39))
    dither_matches_cpu(4, 10, 147994, (0, 39))
    small_matches_cpu()
    fig3_matches_cpu()

    # 5. the kernel table at the main path's shapes and types (launches:
    # all main-path runs together; unpack_dequant_rows, the materializing
    # decoder, is on no engine path)
    main = (40, 147994, f64, 8)
    table = []
    for kname, source, replaces, rows, row in (
            ("ota_combine", "src/repro_torch/kernels/csrc/ota_combine.cu",
             "src/repro/kernels/ota_combine.py:29", ota_rows,
             ota_rows[((4, 7850), f64)]),
            ("dithered_quantize_rows",
             "src/repro_torch/kernels/csrc/dithered_quant.cu",
             "src/repro/kernels/dithered_quant.py:67", quant_rows,
             quant_rows[((40, 7850), f64)]),
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
             payload_rows["packed_weighted_sum"][main])):
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
