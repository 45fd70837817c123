"""One-card dry run: build every (architecture x input shape) cell of the
port on the meta device, run its step once under the cost counter and the
live-bytes tracker (``launch/analysis.py``), and write one JSON record a
cell (counterpart of ``repro.launch.dryrun``). No weights, no card:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--out DIR]

A cell runs the step the card would run: train cells the FL train step of
``launch/steps.py`` over the launcher's 4 clients, kernels on
(``use_kernel=True``; each kernel call is reckoned, not launched); serve
cells ``launch/serve.py``'s ``SERVE_FLAGS``, a prefill on the chunked
attention route (a 32,768-token prompt's scores would not fit on einsum),
``--flag`` adding or overriding runtime flags of the serve steps. Each
record holds the reference's keys (``memory``, ``cost``, ``collectives``,
parameter counts, ...; ``mesh`` is ``"1card"``) and the port's: the peak
live bytes, whether they fit the card, the largest batch that does
(``cut_batch``, halving from the shape's batch; null when none does), the
kernel calls, matmul FLOPs by dtype and the three time terms on an H100.
The numbers are reckoned for the card, not measured on it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Callable, Optional

import torch

from ..configs import ARCH_IDS, get_config
from ..core import rngstream
from ..models import (active_param_count, batch_spec, effective_seq,
                      make_model, param_count)
from ..models.common import ModelConfig
from ..models.transformer import Transformer
from . import analysis
from .serve import SERVE_FLAGS
from .sharding import Placement
from .shapes import SHAPE_IDS, SHAPES, applicable, config_for
from .steps import (fl_round_arrays, make_decode_step, make_prefill_step,
                    make_train_step)

DEFAULT_OUT = Path(__file__).resolve().parents[3] / "experiments" / \
    "dryrun_torch"
MESH = "1card"
#: the train launcher's default number of FL clients
N_CLIENTS = 4
MULTI_CARD = ("the dry run's multi-card meshes (--multi-pod, "
              "--both-meshes, --mesh-data) are not ported yet: ROADMAP "
              "Queue 1 item 10 step 6, part B (after the 'model' axis); "
              "scripts/reckon_fl_steps.py --ranks reckons one rank of the "
              "FL step's client mesh, with --moe-impl ep a MoE model's "
              "expert-parallel step")


@dataclasses.dataclass
class Bundle:
    """One cell's step on the meta device: ``fn()`` runs it once on
    ``arguments`` (parameters, batch, caches)."""
    kind: str
    cfg: ModelConfig
    model: Transformer
    batch: int
    flags: dict
    fn: Callable
    arguments: tuple
    cache_bytes: Optional[int] = None


def _empty(spec: dict) -> dict:
    return {k: torch.empty(shape, dtype=dt, device="meta")
            for k, (shape, dt) in spec.items()}


def build_bundle(arch: str, shape_id, *, aggregator: str = "ota",
                 flags: Optional[dict] = None,
                 batch: Optional[int] = None, mesh=None):
    """(Bundle, "") for the cell at ``batch`` (default the shape's), or
    (None, reason) where the shape does not apply to the arch.
    ``shape_id`` names one of ``SHAPES`` or is an ``InputShape``. A train
    cell with a ``mesh`` (``launch.mesh.abstract_mesh``) is one rank's
    step with one client a rank, its collectives reckoned; with
    ``flags={"moe_impl": "ep"}`` there the rank holds its block of the
    expert leaves (``launch.sharding.Placement``) and its MoE blocks
    exchange tokens (reckoned all-to-alls)."""
    shape = SHAPES[shape_id] if isinstance(shape_id, str) else shape_id
    cfg0 = get_config(arch)
    ok, reason = applicable(cfg0, shape)
    if not ok:
        return None, reason
    cfg = config_for(cfg0, shape)
    batch = shape.global_batch if batch is None else batch
    if shape.kind == "train":
        flags = dict(flags or {}) if mesh is not None else {}
        ep = flags.get("moe_impl") == "ep"
        model = make_model(cfg, seed=None, device="meta",
                           placement=Placement(mesh) if ep else None)
        step = make_train_step(model, n_clients=N_CLIENTS, mesh=mesh,
                               aggregator=aggregator, batch=batch,
                               seq=shape.seq_len, flags=flags)
        inputs = _empty(batch_spec(cfg, batch, shape.seq_len))
        fl = fl_round_arrays(N_CLIENTS if mesh is None else mesh)
        return Bundle("train", cfg, model, batch, flags,
                      lambda: step(inputs, fl, rngstream.prng_key(0)),
                      (list(model.parameters()), inputs)), ""
    model = make_model(cfg, seed=None, device="meta")
    params = list(model.parameters())
    flags = {**SERVE_FLAGS,
             **({"attn_impl": "chunked"} if shape.kind == "prefill"
                else {}), **(flags or {})}
    cache_len = effective_seq(cfg, shape.seq_len)
    if shape.kind == "prefill":
        step = make_prefill_step(model, batch=batch, seq=shape.seq_len,
                                 flags=flags)
        inputs = _empty(batch_spec(cfg, batch, shape.seq_len))
        caches = model.init_cache(batch, cache_len)
        return Bundle("prefill", cfg, model, batch, flags,
                      lambda: step(inputs), (params, inputs),
                      analysis.tensor_bytes(caches)), ""
    if shape.kind == "decode":
        step = make_decode_step(model, batch=batch, cache_len=cache_len,
                                flags=flags)
        caches = model.init_cache(batch, cache_len)
        token = torch.empty(batch, 1, dtype=torch.int64, device="meta")
        position = torch.empty(batch, dtype=torch.int64, device="meta")
        memory = (torch.empty(batch, cfg.encoder_positions, cfg.d_model,
                              dtype=cfg.dtype, device="meta")
                  if cfg.arch_type == "audio" else None)
        return Bundle("decode", cfg, model, batch, flags,
                      lambda: step(token, position, caches, memory),
                      (params, token, position, caches, memory),
                      analysis.tensor_bytes(caches)), ""
    raise ValueError(shape.kind)


def card_capacity() -> tuple[int, str]:
    """The bytes a cell must fit in, and where the number comes from: the
    card's ``total_memory`` when one is present, else the H100 80GB
    HBM3's 80 GB of the data sheet."""
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(0)
        return int(props.total_memory), f"total_memory of {props.name}"
    return (analysis.H100.capacity_bytes,
            f"{analysis.H100.name} data sheet (80 GB)")


def _peak_at(arch, shape_id, batch, aggregator, flags) -> int:
    bundle, _ = build_bundle(arch, shape_id, aggregator=aggregator,
                             flags=flags, batch=batch)
    _, _, live = analysis.reckon(bundle.fn, bundle.arguments,
                                 count_ops=False)
    return live.peak


def cut_batch(arch: str, shape_id: str, peak: int, weight_bytes: int,
              capacity: int, *, aggregator: str = "ota",
              flags: Optional[dict] = None):
    """(the largest batch, halving from the shape's, whose peak fits in
    ``capacity`` (None if none does), {batch: peak bytes} of every batch
    reckoned). ``peak`` is the shape's own batch's; ``weight_bytes`` the
    parameters', which every batch holds. A train batch keeps at least
    one row a client."""
    shape = SHAPES[shape_id]
    peaks = {shape.global_batch: peak}
    smallest = N_CLIENTS if shape.kind == "train" else 1
    b = shape.global_batch
    if weight_bytes > capacity:
        return None, peaks
    while peaks[b] > capacity:
        if b // 2 < smallest:
            return None, peaks
        b //= 2
        peaks[b] = _peak_at(arch, shape_id, b, aggregator, flags)
    return b, peaks


def _record_path(out_dir: Path, arch: str, shape_id: str, tag: str) -> Path:
    suffix = f"_{tag}" if tag else ""
    return out_dir / f"{arch}_{shape_id}_{MESH}{suffix}.json"


def run_one(arch: str, shape_id: str, *, aggregator: str = "ota",
            out_dir: Optional[Path] = DEFAULT_OUT,
            flags: Optional[dict] = None, tag: str = "") -> dict:
    """Reckon one cell and write its record to ``out_dir`` (none if None);
    returns the record."""
    shape = SHAPES[shape_id]
    rec = {"arch": arch, "shape": shape_id, "mesh": MESH,
           "aggregator": aggregator, "status": "ok", "tag": tag,
           "flags": dict(flags or {}), "batch": shape.global_batch,
           "seq_len": shape.seq_len, "kind": shape.kind}
    t0 = time.time()
    try:
        bundle, reason = build_bundle(arch, shape_id, aggregator=aggregator,
                                      flags=flags)
        if bundle is None:
            rec["status"] = "skipped"
            rec["reason"] = reason
        else:
            out, counter, live = analysis.reckon(bundle.fn,
                                                 bundle.arguments)
            capacity, source = card_capacity()
            memory = live.memory_summary(out)
            del out
            weights = analysis.tensor_bytes(bundle.arguments[0])
            cut, peaks = cut_batch(arch, shape_id, live.peak, weights,
                                   capacity, aggregator=aggregator,
                                   flags=flags)
            rec.update(
                flags=bundle.flags,
                n_clients=N_CLIENTS if bundle.kind == "train" else None,
                memory=memory, cost=analysis.cost_summary(counter),
                collectives=analysis.collective_stats(counter),
                param_count=param_count(bundle.model),
                active_param_count=active_param_count(bundle.cfg,
                                                      bundle.model),
                n_devices=1, cache_bytes=bundle.cache_bytes,
                peak_bytes=live.peak, capacity_bytes=capacity,
                capacity_source=source,
                fits_one_card=live.peak <= capacity, cut_batch=cut,
                batch_peaks={str(b): p for b, p in sorted(peaks.items())},
                kernel_calls=dict(counter.kernel_calls),
                matmul_flops_by_dtype=dict(counter.matmul_flops),
                time_s=analysis.time_terms(counter),
                device=analysis.H100.name,
                power_limit_w=analysis.H100.power_limit_w)
    except Exception as e:      # one cell's failure is its record's
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["elapsed_s"] = round(time.time() - t0, 1)
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        _record_path(out_dir, arch, shape_id, tag).write_text(
            json.dumps(rec, indent=1, default=str))
    return rec


def _parse_flags(pairs) -> dict:
    flags = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        flags[k] = int(v) if v.isdigit() else (v == "true" if v in
                                               ("true", "false") else v)
    return flags


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=SHAPE_IDS)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--mesh-data", type=int, default=None)
    ap.add_argument("--aggregator", default="ota",
                    choices=("ideal", "ota", "digital"))
    ap.add_argument("--out", type=Path, default=DEFAULT_OUT)
    ap.add_argument("--tag", default="")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--flag", action="append", default=[],
                    help="serve-step flag key=value (e.g. attn_impl=einsum)")
    args = ap.parse_args(argv)
    if args.multi_pod or args.both_meshes or args.mesh_data is not None:
        raise NotImplementedError(MULTI_CARD)
    flags = _parse_flags(args.flag)
    if args.all:
        combos = [(a, s) for a in ARCH_IDS for s in SHAPE_IDS]
    elif args.arch and args.shape:
        combos = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")
    for arch, shape in combos:
        path = _record_path(args.out, arch, shape, args.tag)
        if args.skip_existing and path.exists():
            if json.loads(path.read_text()).get("status") in ("ok",
                                                               "skipped"):
                print(f"[skip] {arch} {shape} {MESH} (cached)")
                continue
        rec = run_one(arch, shape, aggregator=args.aggregator,
                      out_dir=args.out, tag=args.tag, flags=flags or None)
        peak = rec.get("peak_bytes")
        print(f"[{rec['status']:7s}] {arch:22s} {shape:12s} {MESH}"
              f" {rec['elapsed_s']:7.1f}s"
              f" flops={(rec.get('cost') or {}).get('flops')}"
              f" peak_gb={None if peak is None else peak / 1e9}"
              f" cut_batch={rec.get('cut_batch')}"
              + (f" err={rec.get('error', '')[:120]}"
                 if rec["status"] == "error" else ""), flush=True)


if __name__ == "__main__":
    main()
