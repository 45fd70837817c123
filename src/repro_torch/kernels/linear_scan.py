"""Wrapper of the CUDA linear-scan kernel (``csrc/linear_scan.cu``).

Replaces ``repro/kernels/linear_scan.py::linear_scan_fsl``. CPU tensors
take the plain version (``ref.linear_scan_ref``); CUDA tensors launch the
kernel on the current stream or raise; tensors without data (meta, fake)
are reckoned (``reckon.py``).
"""
from __future__ import annotations

import ctypes

import torch

from . import build, reckon, ref

_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 3 + [ctypes.c_void_p]


def linear_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """h_t = a_t * h_{t-1} + b_t along axis 1 (see ``ref.linear_scan_ref``
    for the arithmetic). a, b: (B, S, D), S >= 1; h0: (B, D); all f32,
    contiguous, on one device. Returns (h_all (B, S, D), h_last (B, D))
    in f32."""
    ins = (a, b, h0)
    if any(t.dtype != torch.float32 for t in ins):
        raise TypeError(f"linear_scan takes f32 tensors, got "
                        f"{[t.dtype for t in ins]}")
    if a.dim() != 3 or a.shape[1] < 1:
        raise ValueError(f"linear_scan wants a (B, S, D) with S >= 1, got "
                         f"{tuple(a.shape)}")
    B, S, D = a.shape
    if tuple(b.shape) != (B, S, D) or tuple(h0.shape) != (B, D):
        raise ValueError(f"linear_scan shapes {[tuple(t.shape) for t in ins]}"
                         f" do not match a, b (B, S, D), h0 (B, D)")
    if len({t.device for t in ins}) != 1:
        raise ValueError("linear_scan inputs lie on different devices")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("linear_scan takes contiguous tensors")
    abstract = reckon.abstract(a)
    if a.device.type == "cpu" and not abstract:
        return ref.linear_scan_ref(a, b, h0)
    if a.device.type != "cuda" and not abstract:
        raise ValueError(f"linear_scan runs on cuda or cpu, not {a.device}")
    h_all = torch.empty_like(a)
    h_last = torch.empty_like(h0)
    if abstract:
        return reckon.call(linear_scan, ins, (h_all, h_last))
    lib = build.library("linear_scan", {"linear_scan_f32": _ARGS})
    with torch.cuda.device(a.device):
        err = lib.linear_scan_f32(
            *(t.data_ptr() for t in ins), h_all.data_ptr(),
            h_last.data_ptr(), B, S, D,
            torch.cuda.current_stream().cuda_stream)
    linear_scan.launches += 1
    if err:
        raise RuntimeError(f"linear_scan launch failed: cudaError {err}")
    return h_all, h_last


linear_scan.launches = 0
linear_scan.reckoned = 0
