"""The one-card cost and memory report (``repro_torch.launch.analysis`` and
``dryrun``) against the reference's dry run (``repro.launch.dryrun``,
``hlo_cost``) and torch's own counters, on the CPU:

  * each kernel wrapper's meta branch: the plain version's shapes and
    dtypes, its checks kept, a ``reckoned`` count and no launch;
  * matmul FLOPs of a prefill and an ideal train step (``scaled_down()``
    llama3.2-1b, qwen3-moe-30b-a3b, falcon-mamba-7b) against the dot and
    convolution FLOPs of the reference's compiled step, walked with
    ``hlo_cost``'s parser and ``while`` trip counts: within 2%, and equal
    once the products over a contraction of length 1 are set aside (XLA
    rewrites such a dot into a multiply);
  * parameter, active-parameter and cache bytes of every arch at full size
    equal to the reference's; a prefill's argument bytes; the live-bytes
    peak against torch's ``MemTracker``;
  * full-size records of llama3.2-1b's ``prefill_32k`` and ``decode_32k``
    (their ``cut_batch`` fits, twice it does not), whisper-tiny's skipped
    ``long_500k``, and the CLI's refusal of multi-card meshes.
"""
import re

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from _torch_reference import one_thread, ref  # noqa: F401  (fixtures)
from repro_torch import kernels
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import analysis, dryrun
from repro_torch.launch.serve import SERVE_FLAGS
from repro_torch.launch.shapes import SHAPES, config_for
from repro_torch.launch.steps import (fl_round_arrays, make_prefill_step,
                                      make_train_step)
from repro_torch.models import batch_spec, make_batch, make_model

pytestmark = pytest.mark.usefixtures("one_thread")

FLOP_ARCHS = ("llama3.2-1b", "qwen3-moe-30b-a3b", "falcon-mamba-7b")
BATCH, SEQ = 2, 16


# ------------------------------------------------------------ meta branch

def _wrapper_cases():
    """{name: (wrapper, CPU inputs)} for the ten kernel entries."""
    g = torch.Generator().manual_seed(0)

    def rnd(*shape, dtype=torch.float64):
        return torch.randn(*shape, generator=g, dtype=dtype)

    R, d, cb = 3, 37, 8
    scal = torch.stack([rnd(R).abs() + 1, torch.full((R,), 255.0,
                                                     dtype=torch.float64)],
                       dim=1)
    u = torch.rand(R, d, generator=g)
    words = kernels.quantize_pack_rows(rnd(R, d), u, scal, cb)
    scal3 = torch.cat([scal, rnd(R, 1)], dim=1)
    B, S, D, n = 2, 5, 6, 4
    f32 = torch.float32
    return {
        "ota_combine": (kernels.ota_combine, (rnd(R, d), rnd(R), rnd(R, d))),
        "ota_combine_keyed": (kernels.ota_combine_keyed,
                              (rnd(R, d, dtype=f32), 0.5, 0.1, (0, 7))),
        "dithered_quantize_rows": (kernels.dithered_quantize_rows,
                                   (rnd(R, d), u, scal)),
        "dithered_quantize": (kernels.dithered_quantize,
                              (rnd(R, d), u, scal[0].contiguous())),
        "row_maxabs_sumsq": (kernels.row_maxabs_sumsq, (rnd(R, d),)),
        "quantize_pack_rows": (kernels.quantize_pack_rows,
                               (rnd(R, d), u, scal, cb)),
        "unpack_dequant_rows": (kernels.unpack_dequant_rows,
                                (words, scal, cb, d)),
        "packed_weighted_sum": (kernels.packed_weighted_sum,
                                (words[None], scal3[None], cb, d)),
        "selective_scan": (kernels.selective_scan,
                           (rnd(B, S, D, dtype=f32), rnd(B, S, D, dtype=f32),
                            rnd(B, S, n, dtype=f32), rnd(B, S, n, dtype=f32),
                            rnd(D, n, dtype=f32), rnd(B, D, n, dtype=f32))),
        "linear_scan": (kernels.linear_scan,
                        (rnd(B, S, D, dtype=f32), rnd(B, S, D, dtype=f32),
                         rnd(B, D, dtype=f32))),
    }


def _to(args, device):
    return tuple(a.to(device) if torch.is_tensor(a) else a for a in args)


def _outs(x):
    return list(x) if isinstance(x, tuple) else [x]


@pytest.mark.parametrize("name", [k.__name__ for k in kernels.KERNELS])
def test_meta_branch_gives_plain_shapes_and_counts_apart(name):
    fn, args = _wrapper_cases()[name]
    want = _outs(fn(*args))                       # the plain version
    launches = kernels.launch_counts()
    reckoned = kernels.reckoned_counts()
    got = _outs(fn(*_to(args, "meta")))
    assert [(t.shape, t.dtype, t.device.type) for t in got] == \
        [(t.shape, t.dtype, "meta") for t in want]
    assert kernels.launch_counts() == launches
    after = kernels.reckoned_counts()
    assert after[name] == reckoned[name] + 1
    assert {k: v for k, v in after.items() if k != name} == \
        {k: v for k, v in reckoned.items() if k != name}


def test_meta_branch_keeps_the_checks():
    g = torch.empty(3, 8, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="wants g, z"):
        kernels.ota_combine(g, g[:, 0].contiguous(), g[:2])
    with pytest.raises(TypeError, match="dtypes"):
        kernels.ota_combine(g, g[:, 0].contiguous(), g.float())
    with pytest.raises(ValueError, match="contiguous"):
        kernels.ota_combine(g.t().contiguous().t(), g[:, 0].contiguous(), g)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.linear_scan(*(t.transpose(0, 1) for t in
                              (torch.empty(4, 4, 4, device="meta"),) * 2),
                            torch.empty(4, 4, device="meta"))
    with pytest.raises(ValueError, match="code_bits"):
        kernels.quantize_pack_rows(g, g.float(), g[:, :2].contiguous(), 5)


def test_fake_tensors_are_reckoned_not_run():
    from torch._subclasses.fake_tensor import FakeTensorMode
    fn, args = _wrapper_cases()["ota_combine"]
    before = kernels.reckoned_counts()["ota_combine"]
    with FakeTensorMode() as mode:
        fake = tuple(mode.from_tensor(a) for a in args)
        out = fn(*fake)
    assert out.shape == args[2].shape and out.dtype == args[2].dtype
    assert kernels.reckoned_counts()["ota_combine"] == before + 1


def test_reckoned_kernels_in_the_cost():
    """A Mamba prefill on the serve flags reckons one selective scan a
    layer, launches none, and is charged the scan's operand and result
    bytes."""
    cfg = get_config("falcon-mamba-7b").scaled_down()
    model = make_model(cfg, seed=None, device="meta")
    inputs = dryrun._empty(batch_spec(cfg, BATCH, SEQ))
    step = make_prefill_step(model, batch=BATCH, seq=SEQ, flags=SERVE_FLAGS)
    launches = kernels.launch_counts()
    _, counter, _ = analysis.reckon(lambda: step(inputs), ())
    assert kernels.launch_counts() == launches
    assert dict(counter.kernel_calls) == {"selective_scan": cfg.n_layers}
    B, S, D, n = BATCH, SEQ, cfg.d_inner, cfg.ssm_state
    per_call = 4 * (2 * B * S * D + 2 * B * S * n + D * n + B * D * n
                    + B * S * D + B * D * n)
    assert counter.kernel_bytes == cfg.n_layers * per_call


# ------------------------------------------------- FLOPs: the reference

def _reference_dot_flops(hlo_cost, hlo: str) -> float:
    """Dot and convolution FLOPs of the compiled step (``hlo_cost``'s
    ``_dot_flops``/``_conv_flops``), each computation's scaled by the
    ``while`` trip counts and calls on its path, as ``analyze_hlo``
    scales its flops."""
    comps = hlo_cost.parse_computations(hlo)
    entry = [name for name in comps if "main" in name][-1]
    shape_tab = {}
    for comp in comps.values():
        for op in comp.ops:
            m = hlo_cost._SHAPE_RE.search(op.result_text)
            if m:
                shape_tab.setdefault(op.name, [int(x) for x in
                                               m.group(2).split(",")]
                                     if m.group(2) else [])
    local, calls = {}, {}
    for name, comp in comps.items():
        flops, edges = 0.0, []
        for op in comp.ops:
            if op.opcode == "dot":
                flops += hlo_cost._dot_flops(op, shape_tab.get)
            elif op.opcode == "convolution":
                flops += hlo_cost._conv_flops(op, shape_tab.get)
            elif op.opcode == "while":
                body = re.search(r"body=%?([\w\.\-]+)", op.rhs).group(1)
                cond = re.search(r"condition=%?([\w\.\-]+)", op.rhs).group(1)
                tm = hlo_cost._TRIP_RE.search(op.rhs)
                trips = (max(int(tm.group(1)), 1) if tm
                         else hlo_cost._trip_count(comps[cond]))
                edges += [(body, trips), (cond, trips)]
            else:
                edges += [(c, 1) for c in hlo_cost._CALLED_RE.findall(op.rhs)
                          if c in comps]
        local[name], calls[name] = flops, edges
    memo = {}

    def total(name):
        if name not in memo:
            memo[name] = local[name] + sum(m * total(c)
                                           for c, m in calls[name])
        return memo[name]
    return total(entry)


class _ContractOne(TorchDispatchMode):
    """FLOPs of the matrix products that contract over length 1 (outer
    products), which XLA turns into a broadcast multiply."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        p = func._overloadpacket
        lhs = {torch.ops.aten.mm: 0, torch.ops.aten.bmm: 0,
               torch.ops.aten.addmm: 1, torch.ops.aten.baddbmm: 1}.get(p)
        if lhs is not None and args[lhs].shape[-1] == 1:
            from torch.utils.flop_counter import flop_registry
            self.flops += flop_registry[p](*args, **(kwargs or {}),
                                           out_val=out)
        return out


@pytest.fixture(scope="module")
def ref_flops(ref):
    """{(arch, kind): dot FLOPs of the reference's compiled step} for the
    scaled-down FLOP archs (prefill; ideal train step over one client)."""
    import importlib
    hlo_cost = importlib.import_module("repro.launch.hlo_cost")
    mesh = ref.mesh.make_host_mesh(model_axis=1, data_axis=1)
    out = {}
    for arch in FLOP_ARCHS:
        model = ref.api.make_model(ref.configs.get_config(arch).scaled_down())
        bundles = {
            "prefill": ref.steps.make_prefill_step(model, mesh, batch=BATCH,
                                                   seq=SEQ),
            "train": ref.steps.make_train_step(model, mesh,
                                               aggregator="ideal",
                                               batch=BATCH, seq=SEQ,
                                               use_kernel=False)}
        for kind, bundle in bundles.items():
            hlo = bundle.lower().compile().as_text()
            out[arch, kind] = _reference_dot_flops(hlo_cost, hlo)
    return out


@pytest.mark.parametrize("kind", ["prefill", "train"])
@pytest.mark.parametrize("arch", FLOP_ARCHS)
def test_matmul_flops_match_reference_dots(ref_flops, arch, kind):
    cfg = get_config(arch).scaled_down()
    model = make_model(cfg, seed=None, device="meta")
    inputs = dryrun._empty(batch_spec(cfg, BATCH, SEQ))
    if kind == "prefill":
        step = make_prefill_step(model, batch=BATCH, seq=SEQ)
        fn = lambda: step(inputs)                              # noqa: E731
    else:
        step = make_train_step(model, n_clients=1, aggregator="ideal",
                               batch=BATCH, seq=SEQ)
        fn = lambda: step(inputs, fl_round_arrays(1), (0, 0))  # noqa: E731
    outer = _ContractOne()
    with outer:
        _, counter, _ = analysis.reckon(fn, ())
    mine, theirs = sum(counter.matmul_flops.values()), ref_flops[arch, kind]
    assert set(counter.matmul_flops) == {"float32"}
    assert abs(mine - theirs) <= 0.02 * theirs, (mine, theirs)
    # falcon-mamba's train step: the C projection's einsum backward
    # (bcdn,bcn->bcd) takes an outer product a layer, bmm (B*S, di, 1) x
    # (B*S, 1, n), which XLA rewrites to a multiply: 2 B S di n FLOPs
    assert mine - outer.flops == theirs
    if (arch, kind) == ("falcon-mamba-7b", "train"):
        assert outer.flops == (cfg.n_layers * 2 * BATCH * SEQ * cfg.d_inner
                               * cfg.ssm_state)
    else:
        assert outer.flops == 0


def test_matmul_flops_equal_flop_counter_mode():
    """On real CPU tensors the counter's matmul FLOPs are
    ``FlopCounterMode``'s, as on the card (``chip_smoke.py`` phase 12)."""
    cfg = get_config("llama3.2-1b").scaled_down()
    model = make_model(cfg, seed=0, device="cpu")
    inputs = make_batch(cfg, BATCH, SEQ, torch.Generator().manual_seed(1))
    step = make_prefill_step(model, batch=BATCH, seq=SEQ)
    with FlopCounterMode(display=False) as fc:
        step(inputs)
    _, counter, _ = analysis.reckon(lambda: step(inputs), (), device="cpu")
    assert sum(counter.matmul_flops.values()) == fc.get_total_flops() > 0


# --------------------------------------------------- parameters, memory

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_cache_bytes_match_reference(ref, arch):
    jax = ref.jax
    rcfg = ref.configs.get_config(arch)
    rmodel = ref.api.make_model(rcfg)
    aparams = rmodel.abstract_params()
    for shape_id in ("decode_32k", "long_500k"):
        bundle, reason = dryrun.build_bundle(arch, shape_id, batch=2)
        if bundle is None:
            assert arch == "whisper-tiny" and shape_id == "long_500k"
            continue
        assert dryrun.param_count(bundle.model) == \
            ref.api.param_count(aparams)
        assert dryrun.active_param_count(bundle.cfg, bundle.model) == \
            ref.api.active_param_count(rcfg, aparams)
        shape = SHAPES[shape_id]
        rcfg_s = ref.shapes.config_for(rcfg, ref.shapes.SHAPES[shape_id])
        rmodel_s = ref.api.make_model(rcfg_s)
        cache_len = ref.api.effective_seq(rcfg_s, shape.seq_len)
        caches = jax.eval_shape(lambda: rmodel_s.init_cache(
            2, cache_len, dtype=rcfg_s.dtype))
        want = sum(int(np.prod(x.shape)) * x.dtype.itemsize
                   for x in jax.tree.leaves(caches))
        assert bundle.cache_bytes == want


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_prefill_argument_bytes_are_parameters_and_batch(device):
    """Parameters and prompt, each in the card's 512-byte blocks on the
    meta device and as it is on the CPU."""
    cfg = get_config("gemma3-4b").scaled_down()
    if device == "cpu":
        model = make_model(cfg, seed=0, device=device)
        inputs = make_batch(cfg, BATCH, SEQ, torch.Generator().manual_seed(3))
    else:
        model = make_model(cfg, seed=None, device=device)
        inputs = dryrun._empty(batch_spec(cfg, BATCH, SEQ))
    step = make_prefill_step(model, batch=BATCH, seq=SEQ)
    params = list(model.parameters())
    block = analysis.ALLOC_BLOCK if device == "meta" else 1
    out, _, live = analysis.reckon(lambda: step(inputs), (params, inputs),
                                   device=device)
    mem = live.memory_summary(out)

    def size(t):
        return -(-t.numel() * t.element_size() // block) * block
    assert mem["argument_size_in_bytes"] == \
        sum(size(p) for p in params) + sum(size(t) for t in inputs.values())
    assert mem["alias_size_in_bytes"] == 0
    assert mem["peak_bytes"] == (mem["argument_size_in_bytes"]
                                 + mem["output_size_in_bytes"]
                                 + mem["temp_size_in_bytes"])


@pytest.mark.parametrize("kind", ["prefill", "train"])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "falcon-mamba-7b"])
def test_live_peak_matches_mem_tracker(arch, kind):
    """On real CPU tensors (unrounded) the live-bytes peak within 1% of
    ``torch.distributed._tools.mem_tracker.MemTracker``'s (one client:
    MemTracker refuses a module called twice in one step)."""
    from torch.distributed._tools.mem_tracker import MemTracker
    cfg = get_config(arch).scaled_down()
    model = make_model(cfg, seed=0, device="cpu")
    inputs = make_batch(cfg, BATCH, SEQ, torch.Generator().manual_seed(2))
    if kind == "prefill":
        step = make_prefill_step(model, batch=BATCH, seq=SEQ)
        fn = lambda: step(inputs)                              # noqa: E731
    else:
        step = make_train_step(model, n_clients=1, aggregator="ota",
                               batch=BATCH, seq=SEQ)
        fl = fl_round_arrays(1, noise_scale=1e-3)
        fn = lambda: step(inputs, fl, (0, 3))                  # noqa: E731
    tracker = MemTracker()
    tracker.track_external(model, *inputs.values())
    with tracker:
        fn()
    theirs = tracker.get_tracker_snapshot("peak")[torch.device("cpu")][
        "Total"]
    model.zero_grad(set_to_none=True)
    _, _, live = analysis.reckon(fn, (list(model.parameters()), inputs),
                                 count_ops=False, device="cpu")
    assert abs(live.peak - theirs) <= 0.01 * theirs, (live.peak, theirs)


def test_time_terms_name_the_largest():
    counter = analysis.OpCounter()
    counter.matmul_flops.update({"bfloat16": 989e12, "float32": 67e12})
    counter.op_flops = 989e12 + 67e12 + 67e12
    counter.bytes_accessed = 3.35e12 * 2.5
    t = analysis.time_terms(counter)
    assert t["compute_s"] == pytest.approx(3.0)
    assert t["memory_s"] == pytest.approx(2.5)
    assert t["collective_s"] == 0.0
    assert (t["dominant"], t["bound_s"]) == ("compute", t["compute_s"])


# ------------------------------------------------------- records and CLI

@pytest.mark.parametrize("shape_id", ["prefill_32k", "decode_32k"])
def test_full_size_record_and_cut_batch(tmp_path, shape_id):
    rec = dryrun.run_one("llama3.2-1b", shape_id, out_dir=tmp_path)
    assert rec["status"] == "ok", rec.get("traceback")
    assert (tmp_path / f"llama3.2-1b_{shape_id}_1card.json").exists()
    assert rec["param_count"] == rec["active_param_count"] == 1_498_482_688
    assert rec["mesh"] == "1card" and rec["n_devices"] == 1
    assert rec["collectives"]["total_bytes"] == 0.0
    cap, cut, peaks = rec["capacity_bytes"], rec["cut_batch"], \
        rec["batch_peaks"]
    assert not rec["fits_one_card"] and cut is not None
    assert peaks[str(cut)] <= cap < peaks[str(2 * cut)]
    assert rec["peak_bytes"] == peaks[str(SHAPES[shape_id].global_batch)]
    assert rec["time_s"]["dominant"] in ("compute", "memory")
    assert set(rec["matmul_flops_by_dtype"]) == {"bfloat16"}
    assert rec["flags"].get("attn_impl") == (
        "chunked" if shape_id == "prefill_32k" else None)


def test_whisper_long_500k_skipped_with_reference_reason(ref, tmp_path):
    rec = dryrun.run_one("whisper-tiny", "long_500k", out_dir=tmp_path)
    want = ref.shapes.applicable(ref.configs.get_config("whisper-tiny"),
                                 ref.shapes.SHAPES["long_500k"])
    assert (rec["status"], rec["reason"]) == ("skipped", want[1])
    assert config_for(get_config("whisper-tiny"),
                      SHAPES["long_500k"]).max_target_positions == 448


@pytest.mark.parametrize("argv", [["--multi-pod"], ["--both-meshes"],
                                  ["--mesh-data", "4"]])
def test_cli_refuses_multi_card_meshes(argv):
    with pytest.raises(NotImplementedError, match="item 10 step 6"):
        dryrun.main(["--arch", "llama3.2-1b", "--shape", "decode_32k",
                     *argv])
