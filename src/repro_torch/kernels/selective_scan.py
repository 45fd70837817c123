"""Wrapper of the CUDA selective-scan kernel (``csrc/selective_scan.cu``).

Replaces ``repro/kernels/selective_scan.py::selective_scan_bfsn``. CPU
tensors take the plain version (``ref.selective_scan_ref``); CUDA tensors
launch the kernel on the current stream or raise; tensors without data
(meta, fake) are reckoned (``reckon.py``).
"""
from __future__ import annotations

import ctypes

import torch

from . import build, reckon, ref

MAX_STATE = 16
_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 4 + [ctypes.c_void_p]


def selective_scan(dt: torch.Tensor, x: torch.Tensor, bm: torch.Tensor,
                   cm: torch.Tensor, a_w: torch.Tensor, h0: torch.Tensor):
    """Mamba-1 selective scan with the C-projection fused (see
    ``ref.selective_scan_ref`` for the arithmetic).

    dt, x: (B, S, D); bm, cm: (B, S, n); a_w: (D, n); h0: (B, D, n); all
    f32, contiguous, on one device, S >= 1, 1 <= n <= 16. Returns
    (y (B, S, D), h_last (B, D, n)) in f32.
    """
    ins = (dt, x, bm, cm, a_w, h0)
    if any(t.dtype != torch.float32 for t in ins):
        raise TypeError(f"selective_scan takes f32 tensors, got "
                        f"{[t.dtype for t in ins]}")
    if dt.dim() != 3 or dt.shape[1] < 1:
        raise ValueError(f"selective_scan wants dt (B, S, D) with S >= 1, "
                         f"got {tuple(dt.shape)}")
    B, S, D = dt.shape
    n = bm.shape[-1] if bm.dim() == 3 else -1
    want = ((B, S, D), (B, S, D), (B, S, n), (B, S, n), (D, n), (B, D, n))
    if [tuple(t.shape) for t in ins] != [tuple(w) for w in want]:
        raise ValueError(f"selective_scan shapes {[tuple(t.shape) for t in ins]}"
                         f" do not match dt, x (B, S, D), bm, cm (B, S, n), "
                         f"a_w (D, n), h0 (B, D, n)")
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"selective_scan keeps n <= {MAX_STATE} states in "
                         f"registers, got n = {n}")
    if len({t.device for t in ins}) != 1:
        raise ValueError("selective_scan inputs lie on different devices")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("selective_scan takes contiguous tensors")
    abstract = reckon.abstract(dt)
    if dt.device.type == "cpu" and not abstract:
        return ref.selective_scan_ref(dt, x, bm, cm, a_w, h0)
    if dt.device.type != "cuda" and not abstract:
        raise ValueError(f"selective_scan runs on cuda or cpu, not "
                         f"{dt.device}")
    y = torch.empty_like(dt)
    h_last = torch.empty_like(h0)
    if abstract:
        return reckon.call(selective_scan, ins, (y, h_last))
    lib = build.library("selective_scan", {"selective_scan_f32": _ARGS})
    with torch.cuda.device(dt.device):
        err = lib.selective_scan_f32(
            *(t.data_ptr() for t in ins), y.data_ptr(), h_last.data_ptr(),
            B, S, D, n, torch.cuda.current_stream().cuda_stream)
    selective_scan.launches += 1
    if err:
        raise RuntimeError(f"selective_scan launch failed: cudaError {err}")
    return y, h_last


selective_scan.launches = 0
selective_scan.reckoned = 0
