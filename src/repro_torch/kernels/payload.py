"""Wrappers of the CUDA payload kernels (``csrc/payload.cu``): the digital
uplink's wire format at gradient scale.

Replace ``repro/kernels/payload.py``'s ``quantize_pack_rows_2d``,
``unpack_dequant_rows_2d`` and ``packed_weighted_sum_2d``. Packed words are
the uint32 bits of the reference's layout kept in int32 tensors, shaped
(rows, W, LANES) with W = ``ref.payload_word_rows(d, code_bits)``. CPU
tensors take the plain versions (``ref.*_ref``); CUDA tensors launch the
kernel on the current stream or raise; tensors without data (meta, fake)
are reckoned (``reckon.py``).
"""
from __future__ import annotations

import ctypes

import torch

from . import build, reckon, ref
from .ref import LANES, payload_word_rows

CODE_BITS_CHOICES = (4, 8, 16)
_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}
_P, _I = ctypes.c_void_p, ctypes.c_int64
# (code_bits, the tensors' pointers, the sizes, the stream) of each
# exported function
_SIGS = {f"{name}_{t}": [ctypes.c_int, *[_P] * n_ptr, *[_I] * n_int, _P]
         for name, n_ptr, n_int in (("quantize_pack_rows", 4, 3),
                                    ("unpack_dequant_rows", 3, 3),
                                    ("packed_weighted_sum", 3, 4))
         for t in _SUFFIX.values()}


def _check(name, dtype, code_bits, tensors, shapes_ok, shapes):
    """Type, code width, shape and device checks shared by the wrappers;
    returns the operands' device and whether they hold no data."""
    if dtype not in _SUFFIX:
        raise TypeError(f"{name} takes f64 or f32 floats, got {dtype}")
    if code_bits not in CODE_BITS_CHOICES:
        raise ValueError(f"{name}: code_bits must be one of "
                         f"{CODE_BITS_CHOICES}, got {code_bits}")
    if not shapes_ok:
        raise ValueError(f"{name}: wrong shapes {shapes}")
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name} operands must share one device")
    abstract = reckon.abstract(tensors[0])
    if dev.type not in ("cpu", "cuda") and not abstract:
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    if ((dev.type == "cuda" or abstract)
            and not all(t.is_contiguous() for t in tensors)):
        raise ValueError(f"{name} takes contiguous tensors")
    return dev, abstract


def _launch(name, dtype, code_bits, dev, *args):
    lib = build.library("payload", _SIGS)
    with torch.cuda.device(dev):
        err = getattr(lib, f"{name}_{_SUFFIX[dtype]}")(
            code_bits, *args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def quantize_pack_rows(g: torch.Tensor, u: torch.Tensor, scal: torch.Tensor,
                       code_bits: int) -> torch.Tensor:
    """Dither, quantize and bit-pack each row r of g with its (m_r, L_r).

    g: (R, d) f64/f32; u: (R, d) f32 dither; scal: (R, 2) in g's dtype,
    columns (m = ||g_r||_inf, levels = 2^r - 1 <= 2^code_bits - 1).
    Returns words (R, W, LANES) int32; entries past d code as the
    reference's zero padding does.
    """
    name = "quantize_pack_rows"
    ok = (g.dim() == 2 and u.shape == g.shape
          and scal.shape == (g.shape[0], 2))
    dev, abstract = _check(name, g.dtype, code_bits, (g, u, scal), ok,
                           [tuple(g.shape), tuple(u.shape),
                            tuple(scal.shape)])
    if u.dtype != torch.float32 or scal.dtype != g.dtype:
        raise TypeError(f"{name} takes u f32 and scal in g's dtype; got "
                        f"{u.dtype}, {scal.dtype}")
    if dev.type == "cpu" and not abstract:
        return ref.quantize_pack_rows_ref(g, u, scal, code_bits)
    R, d = g.shape
    W = payload_word_rows(d, code_bits)
    words = torch.empty(R, W, LANES, dtype=torch.int32, device=dev)
    if words.numel() == 0:
        return words
    if abstract:
        return reckon.call(quantize_pack_rows, (g, u, scal), words)
    _launch(name, g.dtype, code_bits, dev, g.data_ptr(), u.data_ptr(),
            scal.data_ptr(), words.data_ptr(), R, d, W * LANES)
    quantize_pack_rows.launches += 1
    return words


def unpack_dequant_rows(words: torch.Tensor, scal: torch.Tensor,
                        code_bits: int, d: int) -> torch.Tensor:
    """Unpack and dequantize each row: ``-m + (2m/L) * code``, degenerate
    rows (m = 0 or L <= 0) to exact 0.

    words: (R, W, LANES) int32; scal: (R, 2) f64/f32 (m, levels). Returns
    (R, d) in scal's dtype.
    """
    name = "unpack_dequant_rows"
    ok = (words.dim() == 3 and scal.shape == (words.shape[0], 2)
          and words.shape[1:] == (payload_word_rows(d, code_bits), LANES))
    dev, abstract = _check(name, scal.dtype, code_bits, (words, scal), ok,
                           [tuple(words.shape), tuple(scal.shape), d])
    if words.dtype != torch.int32:
        raise TypeError(f"{name} takes int32 words, got {words.dtype}")
    if dev.type == "cpu" and not abstract:
        return ref.unpack_dequant_rows_ref(words, scal, code_bits, d)
    R = words.shape[0]
    out = torch.empty(R, d, dtype=scal.dtype, device=dev)
    if out.numel() == 0:
        return out
    if abstract:
        return reckon.call(unpack_dequant_rows, (words, scal), out)
    _launch(name, scal.dtype, code_bits, dev, words.data_ptr(),
            scal.data_ptr(), out.data_ptr(), R, d, words[0].numel())
    unpack_dequant_rows.launches += 1
    return out


def packed_weighted_sum(words: torch.Tensor, scal: torch.Tensor,
                        code_bits: int, d: int) -> torch.Tensor:
    """out[t] = sum_i w_ti * dequant(unpack(words[t, i])), the devices
    added in index order from zeros, with an O(d) accumulator per trial.

    words: (T, N, W, LANES) int32; scal: (T, N, 3) f64/f32 columns
    (m, levels, w). Returns (T, d) in scal's dtype.
    """
    name = "packed_weighted_sum"
    ok = (words.dim() == 4 and scal.shape == (*words.shape[:2], 3)
          and words.shape[2:] == (payload_word_rows(d, code_bits), LANES))
    dev, abstract = _check(name, scal.dtype, code_bits, (words, scal), ok,
                           [tuple(words.shape), tuple(scal.shape), d])
    if words.dtype != torch.int32:
        raise TypeError(f"{name} takes int32 words, got {words.dtype}")
    if dev.type == "cpu" and not abstract:
        return ref.packed_weighted_sum_ref(words, scal, code_bits, d)
    T, N = scal.shape[:2]
    out = torch.empty(T, d, dtype=scal.dtype, device=dev)
    if out.numel() == 0:
        return out
    if abstract:
        return reckon.call(packed_weighted_sum, (words, scal), out)
    _launch(name, scal.dtype, code_bits, dev, words.data_ptr(),
            scal.data_ptr(), out.data_ptr(), T, N, d, words[0, 0].numel())
    packed_weighted_sum.launches += 1
    return out


quantize_pack_rows.launches = 0
unpack_dequant_rows.launches = 0
packed_weighted_sum.launches = 0
quantize_pack_rows.reckoned = 0
unpack_dequant_rows.reckoned = 0
packed_weighted_sum.reckoned = 0
