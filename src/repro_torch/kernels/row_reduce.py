"""Wrapper of the CUDA per-row statistics kernel (``csrc/row_reduce.cu``).

Replaces ``repro/kernels/row_reduce.py::row_maxabs_sumsq_2d``. CPU tensors
take the plain version (``ref.row_maxabs_sumsq_ref``); CUDA tensors launch
the kernel on the current stream or raise; tensors without data (meta,
fake) are reckoned (``reckon.py``).

The sum of squares adds in one fixed order, a function of d and g's type
alone: each row is cut into ``ref.REDUCE_CLUSTER`` = 8 chunks of
``ref.reduce_chunk(d, V)`` entries (one block of a thread-block cluster
each), V = 16 / g's item size; in a chunk, thread t of 256 owns the
16-byte vectors t, t + 256, ..., lane k of each adding into its own
accumulator from +0; the lanes combine in order, a halving tree adds the
threads' partials, and the chunks add in rank order.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, reckon, ref

_ARGS = [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 2 + [ctypes.c_void_p]
_FUNCS = {(torch.float64, torch.float64): "row_maxabs_sumsq_f64",
          (torch.float32, torch.float32): "row_maxabs_sumsq_f32",
          (torch.bfloat16, torch.float32): "row_maxabs_sumsq_bf16_f32"}


def row_maxabs_sumsq(g: torch.Tensor, acc_dtype=None) -> torch.Tensor:
    """Per-row (max |g_r|, sum g_r^2) of g (R, d), d >= 1, as an (R, 2)
    tensor in ``acc_dtype`` (default g's dtype). Type pairs (g, acc):
    f64/f64, f32/f32, bf16/f32. Contiguous on the card.
    """
    acc_dtype = g.dtype if acc_dtype is None else acc_dtype
    fn = _FUNCS.get((g.dtype, acc_dtype))
    if fn is None:
        raise TypeError(f"row_maxabs_sumsq takes (g, acc) dtypes "
                        f"{list(_FUNCS)}, got ({g.dtype}, {acc_dtype})")
    if g.dim() != 2 or g.shape[1] < 1:
        raise ValueError(f"row_maxabs_sumsq wants g (R, d) with d >= 1, "
                         f"got {tuple(g.shape)}")
    abstract = reckon.abstract(g)
    if g.device.type == "cpu" and not abstract:
        return ref.row_maxabs_sumsq_ref(g, acc_dtype)
    if g.device.type != "cuda" and not abstract:
        raise ValueError(f"row_maxabs_sumsq runs on cuda or cpu, not "
                         f"{g.device}")
    if not g.is_contiguous():
        raise ValueError("row_maxabs_sumsq takes a contiguous g")
    out = torch.empty(g.shape[0], 2, dtype=acc_dtype, device=g.device)
    if out.numel() == 0:
        return out
    if abstract:
        return reckon.call(row_maxabs_sumsq, (g,), out)
    lib = build.library("row_reduce", {f: _ARGS for f in _FUNCS.values()})
    with torch.cuda.device(g.device):
        err = getattr(lib, fn)(g.data_ptr(), out.data_ptr(), g.shape[0],
                               g.shape[1],
                               torch.cuda.current_stream().cuda_stream)
    row_maxabs_sumsq.launches += 1
    if err:
        raise RuntimeError(f"row_maxabs_sumsq launch failed: cudaError {err}")
    return out


row_maxabs_sumsq.launches = 0
row_maxabs_sumsq.reckoned = 0
