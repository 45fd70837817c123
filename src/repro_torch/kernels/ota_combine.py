"""Wrappers of the CUDA OTA-epilogue kernel's two entries
(``csrc/ota_combine.cu``), each with its own launch count.

Both replace ``repro/kernels/ota_combine.py::ota_combine_2d``:
``ota_combine`` takes the noise z from memory (the FL path's host-made
noise), ``ota_combine_keyed`` draws its f32 normals from a threefry key
inside the kernel (the FL-LM collective). CPU tensors take the plain
versions (``ref.ota_combine_ref``, ``ref.ota_combine_keyed_ref``); CUDA
tensors launch the kernel on the current stream or raise; tensors without
data (meta, fake) are reckoned (``reckon.py``).
"""
from __future__ import annotations

import ctypes

import torch

from . import build, reckon, ref

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2 + [ctypes.c_void_p]
_FUNCS = {(torch.float64, torch.float64): "ota_combine_f64",
          (torch.float32, torch.float32): "ota_combine_f32",
          (torch.bfloat16, torch.float32): "ota_combine_bf16_f32"}
_KEYED_ARGS = ([ctypes.c_void_p] * 2 + [ctypes.c_int64]
               + [ctypes.c_double] * 2 + [ctypes.c_uint32] * 2
               + [ctypes.c_void_p])
_KEYED_FUNCS = {torch.float64: "ota_combine_keyed_f64",
                torch.float32: "ota_combine_keyed_f32"}
# every entry of the library, whichever wrapper loads it first
_SIGNATURES = {**{f: _ARGS for f in _FUNCS.values()},
               **{f: _KEYED_ARGS for f in _KEYED_FUNCS.values()}}


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
    ts = (g, inv_alpha, z)
    abstract = reckon.abstract(g)
    if g.device.type == "cpu" and not abstract:
        return ref.ota_combine_ref(g, inv_alpha, z)
    if g.device.type != "cuda" and not abstract:
        raise ValueError(f"ota_combine runs on cuda or cpu, not {g.device}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("ota_combine takes contiguous tensors")
    if abstract:
        out = torch.empty_like(z)
        return out if out.numel() == 0 else reckon.call(ota_combine, ts, out)
    if any(t.data_ptr() % 16 for t in (g, z)):
        raise ValueError("ota_combine takes 16-byte aligned g and z")
    out = torch.empty_like(z)
    if out.numel() == 0:
        return out
    lib = build.library("ota_combine", _SIGNATURES)
    with torch.cuda.device(g.device):
        err = getattr(lib, fn)(
            g.data_ptr(), inv_alpha.data_ptr(), z.data_ptr(), out.data_ptr(),
            g.shape[0], g.shape[1], torch.cuda.current_stream().cuda_stream)
    ota_combine.launches += 1
    if err:
        raise RuntimeError(f"ota_combine launch failed: cudaError {err}")
    return out


ota_combine.launches = 0
ota_combine.reckoned = 0


def _host_number(x, name: str) -> float:
    """A scalar launch argument: a number, or a one-entry tensor on the
    host (one on the card would have to be read back first)."""
    if torch.is_tensor(x) and (x.device.type != "cpu" or x.numel() != 1):
        raise ValueError(f"ota_combine_keyed takes {name} as a number or a "
                         f"one-entry CPU tensor, got {tuple(x.shape)} on "
                         f"{x.device}")
    return float(x)


def ota_combine_keyed(g: torch.Tensor, inv_alpha, scale,
                      key) -> torch.Tensor:
    """``out = g * inv_alpha + (scale * normal).to(g.dtype)`` for a whole
    tensor g, ``normal = rngstream.normal(key, g.shape)`` drawn in the
    kernel (f32, the counter is g's flat index, bit for bit the plain
    version's draw).

    g: contiguous, f64 or f32, any shape (2^31 entries and more);
    inv_alpha: a number, taken in g's dtype; scale: a number, taken in
    f32; key: a threefry key pair of 32-bit words. The scalars and the key
    are launch arguments.
    """
    fn = _KEYED_FUNCS.get(g.dtype)
    if fn is None:
        raise TypeError(f"ota_combine_keyed takes g {list(_KEYED_FUNCS)}, "
                        f"got {g.dtype}")
    if not g.is_contiguous():
        raise ValueError("ota_combine_keyed takes a contiguous g (its flat "
                         "index is the normal's counter)")
    inv_alpha = _host_number(inv_alpha, "inv_alpha")
    scale = _host_number(scale, "scale")
    k0, k1 = (int(k) for k in key)
    if not (0 <= k0 < 1 << 32 and 0 <= k1 < 1 << 32):
        raise ValueError(f"ota_combine_keyed takes a key of two 32-bit "
                         f"words, got {key}")
    abstract = reckon.abstract(g)
    if g.device.type == "cpu" and not abstract:
        return ref.ota_combine_keyed_ref(g, inv_alpha, scale, (k0, k1))
    if g.device.type != "cuda" and not abstract:
        raise ValueError(f"ota_combine_keyed runs on cuda or cpu, not "
                         f"{g.device}")
    out = torch.empty_like(g)
    if out.numel() == 0:
        return out
    if abstract:
        return reckon.call(ota_combine_keyed, (g,), out)
    lib = build.library("ota_combine", _SIGNATURES)
    with torch.cuda.device(g.device):
        err = getattr(lib, fn)(
            g.data_ptr(), out.data_ptr(), g.numel(), inv_alpha, scale, k0,
            k1, torch.cuda.current_stream().cuda_stream)
    ota_combine_keyed.launches += 1
    if err:
        raise RuntimeError(f"ota_combine_keyed launch failed: cudaError "
                           f"{err}")
    return out


ota_combine_keyed.launches = 0
ota_combine_keyed.reckoned = 0
