"""Wrapper of the CUDA per-row dithered quantizer (``csrc/dithered_quant.cu``).

Replaces ``repro/kernels/dithered_quant.py::dithered_quantize_rows_2d``.
CPU tensors take the plain version (``ref.dithered_quantize_rows_ref``);
CUDA tensors launch the kernel on the current stream or raise; tensors
without data (meta, fake) are reckoned (``reckon.py``).
"""
from __future__ import annotations

import ctypes

import torch

from . import build, reckon, ref

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2 + [ctypes.c_void_p]
_FUNCS = {torch.float64: "dithered_quantize_rows_f64",
          torch.float32: "dithered_quantize_rows_f32"}
_TENSOR_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_void_p]
_TENSOR_FUNCS = {torch.float64: "dithered_quantize_f64",
                 torch.float32: "dithered_quantize_f32"}
# every entry of the library, whichever wrapper loads it first
_SIGNATURES = {**{f: _ARGS for f in _FUNCS.values()},
               **{f: _TENSOR_ARGS for f in _TENSOR_FUNCS.values()}}


def dithered_quantize_rows(g: torch.Tensor, u: torch.Tensor,
                           scal: torch.Tensor) -> torch.Tensor:
    """Quantize-dequantize each row r of g with its own (m_r, L_r).

    g: (R, d) f64/f32; u: (R, d) f32 dither; scal: (R, 2) in g's dtype,
    columns (m = ||g_r||_inf, levels = 2^r - 1). All contiguous on one
    device.
    """
    fn = _FUNCS.get(g.dtype)
    if fn is None or u.dtype != torch.float32 or scal.dtype != g.dtype:
        raise TypeError(f"dithered_quantize_rows takes g f64/f32, u f32 and "
                        f"scal in g's dtype; got {g.dtype}, {u.dtype}, "
                        f"{scal.dtype}")
    if g.dim() != 2 or u.shape != g.shape or scal.shape != (g.shape[0], 2):
        raise ValueError(f"dithered_quantize_rows wants g, u (R, d) and "
                         f"scal (R, 2); got {tuple(g.shape)}, "
                         f"{tuple(u.shape)}, {tuple(scal.shape)}")
    if not (g.device == u.device == scal.device):
        raise ValueError("dithered_quantize_rows operands must share one "
                         "device")
    abstract = reckon.abstract(g)
    if g.device.type == "cpu" and not abstract:
        return ref.dithered_quantize_rows_ref(g, u, scal[:, 0], scal[:, 1])
    if g.device.type != "cuda" and not abstract:
        raise ValueError(f"dithered_quantize_rows runs on cuda or cpu, not "
                         f"{g.device}")
    if not all(t.is_contiguous() for t in (g, u, scal)):
        raise ValueError("dithered_quantize_rows takes contiguous tensors")
    out = torch.empty_like(g)
    if out.numel() == 0:
        return out
    if abstract:
        return reckon.call(dithered_quantize_rows, (g, u, scal), out)
    lib = build.library("dithered_quant", _SIGNATURES)
    with torch.cuda.device(g.device):
        err = getattr(lib, fn)(
            g.data_ptr(), u.data_ptr(), scal.data_ptr(), out.data_ptr(),
            g.shape[0], g.shape[1], torch.cuda.current_stream().cuda_stream)
    dithered_quantize_rows.launches += 1
    if err:
        raise RuntimeError(f"dithered_quantize_rows launch failed: "
                           f"cudaError {err}")
    return out


dithered_quantize_rows.launches = 0
dithered_quantize_rows.reckoned = 0


def dithered_quantize(g: torch.Tensor, u: torch.Tensor,
                      scal: torch.Tensor) -> torch.Tensor:
    """Quantize-dequantize the whole tensor g with one (m, L) pair.

    g: any shape, f64/f32; u: g's shape, f32 dither; scal: (2,) in g's
    dtype, (m = ||g||_inf, levels = 2^r - 1), read on the device. All
    contiguous on one device; g may hold 2^31 entries and more.
    """
    fn = _TENSOR_FUNCS.get(g.dtype)
    if fn is None or u.dtype != torch.float32 or scal.dtype != g.dtype:
        raise TypeError(f"dithered_quantize takes g f64/f32, u f32 and scal "
                        f"in g's dtype; got {g.dtype}, {u.dtype}, "
                        f"{scal.dtype}")
    if u.shape != g.shape or scal.shape != (2,):
        raise ValueError(f"dithered_quantize wants u of g's shape and scal "
                         f"(2,); got {tuple(g.shape)}, {tuple(u.shape)}, "
                         f"{tuple(scal.shape)}")
    if not (g.device == u.device == scal.device):
        raise ValueError("dithered_quantize operands must share one device")
    abstract = reckon.abstract(g)
    if g.device.type == "cpu" and not abstract:
        return ref.dithered_quantize_ref(g, u, scal[0], scal[1])
    if g.device.type != "cuda" and not abstract:
        raise ValueError(f"dithered_quantize runs on cuda or cpu, not "
                         f"{g.device}")
    if not all(t.is_contiguous() for t in (g, u, scal)):
        raise ValueError("dithered_quantize takes contiguous tensors")
    out = torch.empty_like(g)
    if out.numel() == 0:
        return out
    if abstract:
        return reckon.call(dithered_quantize, (g, u, scal), out)
    lib = build.library("dithered_quant", _SIGNATURES)
    with torch.cuda.device(g.device):
        err = getattr(lib, fn)(
            g.data_ptr(), u.data_ptr(), scal.data_ptr(), out.data_ptr(),
            g.numel(), torch.cuda.current_stream().cuda_stream)
    dithered_quantize.launches += 1
    if err:
        raise RuntimeError(f"dithered_quantize launch failed: cudaError {err}")
    return out


dithered_quantize.launches = 0
dithered_quantize.reckoned = 0
