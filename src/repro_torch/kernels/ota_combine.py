"""Wrapper of the CUDA OTA-epilogue kernel (``csrc/ota_combine.cu``).

Replaces ``repro/kernels/ota_combine.py::ota_combine_2d``. CPU tensors take
the plain version (``ref.ota_combine_ref``); CUDA tensors launch the
kernel on the current stream or raise.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2 + [ctypes.c_void_p]
_FUNCS = {(torch.float64, torch.float64): "ota_combine_f64",
          (torch.float32, torch.float32): "ota_combine_f32",
          (torch.bfloat16, torch.float32): "ota_combine_bf16_f32"}


def ota_combine(g: torch.Tensor, inv_alpha: torch.Tensor,
                z: torch.Tensor) -> torch.Tensor:
    """``out[r] = g[r] * inv_alpha[r] + z[r]`` in z's dtype.

    g: (R, d) payload; inv_alpha: (R,); z: (R, d) pre-scaled noise. Type
    pairs (g, z): f64/f64, f32/f32, bf16/f32. All contiguous on one
    device; on the card, 16-byte aligned.
    """
    fn = _FUNCS.get((g.dtype, z.dtype))
    if fn is None:
        raise TypeError(f"ota_combine takes (g, z) dtypes {list(_FUNCS)}, "
                        f"got ({g.dtype}, {z.dtype})")
    if g.dim() != 2 or z.shape != g.shape or inv_alpha.shape != g.shape[:1]:
        raise ValueError(f"ota_combine wants g, z (R, d) and inv_alpha (R,); "
                         f"got {tuple(g.shape)}, {tuple(z.shape)}, "
                         f"{tuple(inv_alpha.shape)}")
    if inv_alpha.dtype != z.dtype:
        raise TypeError(f"inv_alpha must be {z.dtype}, got {inv_alpha.dtype}")
    if not (g.device == z.device == inv_alpha.device):
        raise ValueError("ota_combine operands must share one device")
    if g.device.type == "cpu":
        return ref.ota_combine_ref(g, inv_alpha, z)
    if g.device.type != "cuda":
        raise ValueError(f"ota_combine runs on cuda or cpu, not {g.device}")
    ts = (g, inv_alpha, z)
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("ota_combine takes contiguous tensors")
    if any(t.data_ptr() % 16 for t in (g, z)):
        raise ValueError("ota_combine takes 16-byte aligned g and z")
    out = torch.empty_like(z)
    if out.numel() == 0:
        return out
    lib = build.library("ota_combine", {f: _ARGS for f in _FUNCS.values()})
    with torch.cuda.device(g.device):
        err = getattr(lib, fn)(
            g.data_ptr(), inv_alpha.data_ptr(), z.data_ptr(), out.data_ptr(),
            g.shape[0], g.shape[1], torch.cuda.current_stream().cuda_stream)
    ota_combine.launches += 1
    if err:
        raise RuntimeError(f"ota_combine launch failed: cudaError {err}")
    return out


ota_combine.launches = 0
