"""Cost and memory of one step on one card, reckoned on tensors without
data (counterpart of ``repro.launch.analysis`` and ``repro.launch.hlo_cost``).

The reference compiles a step and reads XLA's analyses, re-walking the
optimized HLO because XLA counts a ``while`` body once. Eager PyTorch
runs every layer as it goes, so the step run once on the meta device
(``launch/dryrun.py``) under two dispatch modes counts all of it, and
needs no card and no weights:

* :class:`OpCounter` counts matmul and convolution FLOPs by dtype with the
  formulas ``torch.utils.flop_counter`` registers (so it equals
  ``FlopCounterMode`` over the same ops on the card); "op flops" in
  ``hlo_cost``'s sense (a dot 2·out·K, every other op one a result
  element, views and copies none); ``bytes_accessed``, the operand and
  result bytes of every op that is not a view: eager code fuses nothing,
  so this bounds the HBM traffic from above, the counterpart of
  ``hlo_cost``'s ``hbm_bytes``; the results of transcendental ops; and
  the hand-written kernels' calls by name, each charged the bytes of its
  operands and results (``kernels/reckon.py``).
* :class:`LiveBytes` adds up the live storages, each rounded up to the
  CUDA caching allocator's 512-byte block, the step's arguments
  (parameters, batch, caches) counted from the start, and the workspace
  a CUDA kernel allocates and frees inside an op where it is known
  (:func:`cuda_workspace`); its peak is what
  ``torch.cuda.max_memory_allocated`` reads over the same step, less the
  library workspaces (cuBLAS') allocated once a process.

:func:`time_terms` turns the counts into the three terms of a roofline on
the card's published rates (:data:`H100`). The collective term is the
bytes a rank sends in the collectives ``core/dist.py`` reckons
on tensors without data (a step on an ``abstract_mesh``): a ring
all-reduce of B bytes over W ranks sends 2(W-1)/W B a rank (and receives
as much), an all-to-all (the expert-parallel MoE's exchange) (W-1)/W B,
over the card's NVLink rate in one direction; 0 on one card.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import weakref
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..kernels import reckon as kernel_reckon

aten = torch.ops.aten


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    name: str
    capacity_bytes: int
    hbm_bytes_per_s: float
    matmul_flops_per_s: dict       # dtype name -> dense matmul rate
    vector_flops_per_s: float      # every other op
    power_limit_w: float
    link_bytes_per_s: float        # NVLink, one direction


#: NVIDIA's H100 SXM data sheet, dense rates at the full 700 W: bf16 and
#: f16 matmuls on the tensor cores at 989 TFLOP/s; f32 matmuls at the
#: 67 TFLOP/s of the f32 pipes, since ``device.py`` turns TF32 off; f64
#: matmuls on the f64 tensor cores at 67; 3.35 TB/s of HBM3; 80 GB;
#: NVLink 4 at 900 GB/s both ways, 450 GB/s each way.
H100 = DeviceSpec(
    name="NVIDIA H100 80GB HBM3", capacity_bytes=80 * 10**9,
    hbm_bytes_per_s=3.35e12,
    matmul_flops_per_s={"bfloat16": 989e12, "float16": 989e12,
                        "float32": 67e12, "float64": 67e12},
    vector_flops_per_s=67e12, power_limit_w=700.0, link_bytes_per_s=450e9)

#: the CUDA caching allocator rounds every block up to this many bytes
ALLOC_BLOCK = 512
#: devices whose storages are counted in the card's blocks: the card, and
#: the meta device that stands in for it
CARD_DEVICES = ("cuda", "meta")

# ops that produce a tensor without touching memory
_NO_TRAFFIC = {aten.empty, aten.empty_like, aten.empty_strided,
               aten.new_empty, aten.new_empty_strided}
# views the schema does not mark as aliases
_VIEWS = {aten._unsafe_view}
# copies: bytes, but no flops (``hlo_cost``'s copy); a dtype change is a
# convert, one flop a result element
_COPIES = {aten.clone, aten.copy_, aten.copy, aten._to_copy}
_TRANSCENDENTAL = {aten.exp, aten.exp2, aten.expm1, aten.log, aten.log1p,
                   aten.log2, aten.log10, aten.sin, aten.cos, aten.tan,
                   aten.tanh, aten.sigmoid, aten.rsqrt, aten.sqrt, aten.erf,
                   aten.erfinv, aten.pow, aten._softmax, aten._log_softmax,
                   aten.silu, aten.gelu}


def cuda_workspace(func, args) -> int:
    """Bytes the CUDA kernel of ``func`` allocates and frees inside the op
    beyond its results, which no dispatch mode sees, where known
    (``scripts/hidden_allocations.py`` reads them on the card): the softmax
    backward makes two buffers of its gradient's size when the gradient
    is not contiguous, as the einsum attention's backward hands it."""
    if (func._overloadpacket is aten._softmax_backward_data
            and not args[0].is_contiguous()):
        return 2 * _nbytes(args[0])
    return 0


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tensor_bytes(tree) -> int:
    """Bytes of the tensors in a pytree, each counted as its view."""
    return sum(_nbytes(t) for t in _tensors(tree))


_IS_VIEW: dict = {}


def _is_view(func) -> bool:
    v = _IS_VIEW.get(func)
    if v is None:
        v = func._overloadpacket in _VIEWS or any(
            r.alias_info is not None and not r.alias_info.is_write
            for r in func._schema.returns)
        _IS_VIEW[func] = v
    return v


class OpCounter(TorchDispatchMode):
    """Counts the work of every op dispatched inside the block, and the
    reckoned kernel calls (module docstring)."""

    def __init__(self):
        super().__init__()
        self.matmul_flops = collections.Counter()    # dtype name -> flops
        self.op_flops = 0
        self.bytes_accessed = 0
        self.transcendentals = 0
        self.kernel_calls = collections.Counter()
        self.kernel_bytes = 0
        self.collective_calls = collections.Counter()
        self.collective_bytes = collections.Counter()   # sent a rank
        self._observing = (kernel_reckon.observing(self._on_kernel),
                           kernel_reckon.observing_collectives(
                               self._on_collective))

    def __enter__(self):
        for o in self._observing:
            o.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            for o in reversed(self._observing):
                o.__exit__(None, None, None)

    def _on_collective(self, op, t, ranks):
        # a ring all-reduce sends 2(W-1)/W of the tensor; an all-to-all
        # sends every block but this rank's own, (W-1)/W
        self.collective_calls[op] += 1
        share = 2 if op == "all_reduce" else 1
        self.collective_bytes[op] += share * (ranks - 1) * _nbytes(t) // ranks

    def _on_kernel(self, name, inputs, outputs):
        nbytes = tensor_bytes((inputs, outputs))
        self.kernel_calls[name] += 1
        self.kernel_bytes += nbytes
        self.bytes_accessed += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in _NO_TRAFFIC or _is_view(func):
            return out
        results = _tensors(out)
        self.bytes_accessed += tensor_bytes((args, kwargs, results))
        formula = flop_registry.get(packet)
        if formula is not None:
            flops = formula(*args, **kwargs, out_val=out)
            self.matmul_flops[str(results[0].dtype).removeprefix(
                "torch.")] += flops
            self.op_flops += flops
            return out
        elems = sum(t.numel() for t in results)
        if packet in _TRANSCENDENTAL:
            self.transcendentals += elems
        if packet not in _COPIES or (packet is aten._to_copy and
                                     results[0].dtype != args[0].dtype):
            self.op_flops += elems
        return out


class LiveBytes(TorchDispatchMode):
    """Bytes of the live storages on ``device`` (every device if None)
    while the block runs: every storage an op makes is added until it is
    freed, the storages of ``arguments`` from the start; a storage on the
    card or the meta device in ``ALLOC_BLOCK`` bytes, as the card's
    allocator rounds it, one on the CPU as it is. Host scalars the step
    makes on the CPU stay out of a meta step's count, as they stay off the
    card. On the meta device and the card the peak also holds each op's
    ``cuda_workspace`` beside the storages live after it."""

    def __init__(self, arguments=(), *, device=None):
        super().__init__()
        self.device = None if device is None else torch.device(device)
        self.current = 0
        self.peak = 0
        self._live = {}               # id(storage) -> (weakref, bytes)
        for t in _tensors(arguments):
            self._track(t)
        self._arguments = set(self._live)
        self.argument_bytes = self.current

    @staticmethod
    def _size(storage) -> int:
        n = storage.nbytes()
        if storage.device.type not in CARD_DEVICES:
            return n
        return math.ceil(n / ALLOC_BLOCK) * ALLOC_BLOCK

    def _track(self, t: torch.Tensor) -> None:
        if self.device is not None and t.device.type != self.device.type:
            return
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return
        nbytes = self._size(st)
        self._live[key] = (weakref.ref(st, lambda _, k=key: self._free(k)),
                           nbytes)
        self.current += nbytes
        self.peak = max(self.peak, self.current)

    def _free(self, key) -> None:
        _, nbytes = self._live.pop(key)
        self.current -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            self._track(t)
        if self.device is not None and self.device.type in CARD_DEVICES:
            extra = cuda_workspace(func, args)
            if extra:
                self.peak = max(self.peak, self.current + math.ceil(
                    extra / ALLOC_BLOCK) * ALLOC_BLOCK)
        return out

    def memory_summary(self, outputs) -> dict:
        """``repro.launch.analysis.memory_summary``'s keys where they mean
        the same, from the step's ``outputs`` (still referenced): the
        arguments; the outputs' distinct storages, those among the
        arguments (updated in place) also as ``alias_size_in_bytes``; the
        peak beyond arguments and new outputs as temporaries."""
        seen, out_bytes, alias = set(), 0, 0
        for t in _tensors(outputs):
            st = t.untyped_storage()
            if id(st) in seen:
                continue
            seen.add(id(st))
            out_bytes += self._size(st)
            if id(st) in self._arguments:
                alias += self._size(st)
        return {"argument_size_in_bytes": self.argument_bytes,
                "output_size_in_bytes": out_bytes,
                "alias_size_in_bytes": alias,
                "temp_size_in_bytes": max(self.peak - self.argument_bytes
                                          - (out_bytes - alias), 0),
                "peak_bytes": self.peak}


def reckon(fn, arguments, *, count_ops: bool = True, device="meta"):
    """Run ``fn()`` once under :class:`LiveBytes` (``arguments`` counted
    from the start, storages on ``device``) and, if ``count_ops``,
    :class:`OpCounter`. Returns (fn's result, the counter or None, the
    tracker)."""
    live = LiveBytes(arguments, device=device)
    counter = OpCounter() if count_ops else None
    with live:
        if counter is None:
            out = fn()
        else:
            with counter:
                out = fn()
    return out, counter, live


def cost_summary(counter: OpCounter) -> dict:
    """``repro.launch.analysis.cost_summary``'s keys: op flops, bytes
    accessed and transcendental results of the whole step (every layer
    counted as it ran)."""
    return {"flops": float(counter.op_flops),
            "bytes_accessed": float(counter.bytes_accessed),
            "transcendentals": float(counter.transcendentals)}


def collective_stats(counter: Optional[OpCounter] = None) -> dict:
    """``CollectiveStats.summary()``'s keys: the bytes a rank sends in the
    counted collectives, by op (none on one card)."""
    if counter is None:
        return {"total_bytes": 0.0, "per_op_bytes": {}, "per_op_count": {}}
    return {"total_bytes": float(sum(counter.collective_bytes.values())),
            "per_op_bytes": {k: float(v) for k, v in
                             counter.collective_bytes.items()},
            "per_op_count": dict(counter.collective_calls)}


def time_terms(counter: OpCounter, spec: DeviceSpec = H100) -> dict:
    """The three terms of the step's least time on ``spec``, in seconds:
    compute (each dtype's matmul FLOPs at its matmul rate, the other op
    flops at the vector rate), memory (bytes accessed over the HBM rate)
    and collective (the bytes a rank sends over the link rate; 0 on one
    card); ``bound_s`` is the largest, named by ``dominant``."""
    matmul = sum(counter.matmul_flops.values())
    compute = sum(f / spec.matmul_flops_per_s.get(dt,
                                                   spec.vector_flops_per_s)
                  for dt, f in counter.matmul_flops.items())
    compute += (counter.op_flops - matmul) / spec.vector_flops_per_s
    terms = {"compute": compute,
             "memory": counter.bytes_accessed / spec.hbm_bytes_per_s,
             "collective": sum(counter.collective_bytes.values())
             / spec.link_bytes_per_s}
    dominant = max(terms, key=terms.get)
    return {**{f"{k}_s": v for k, v in terms.items()},
            "bound_s": terms[dominant], "dominant": dominant}
