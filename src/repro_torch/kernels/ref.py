"""Plain PyTorch versions of the port's kernels (counterparts of
``repro.kernels.ref``).

Each repeats its kernel's arithmetic op for op, with multiply and add kept
separate and the weighted sum's devices in the kernel's order, so on the
card a kernel and its plain version agree bit for bit. They serve CPU
tensors and the tests; with a card present the main path reaches them
only when ``use_kernel=False`` asks for them.
"""
from __future__ import annotations

import torch

from ..core import rngstream


def ota_combine_ref(g: torch.Tensor, inv_alpha: torch.Tensor,
                    z: torch.Tensor) -> torch.Tensor:
    """OTA epilogue (eq. (6)): ``g * inv_alpha + z`` per row.

    g: (R, d) payload (f64, f32 or bf16); inv_alpha: (R,) and z: (R, d)
    (pre-scaled noise) in the accumulate dtype, to which g widens.
    """
    return g.to(z.dtype) * inv_alpha[:, None] + z


def ota_combine_keyed_ref(g: torch.Tensor, inv_alpha: float, scale: float,
                          key) -> torch.Tensor:
    """The keyed OTA epilogue: ``g * inv_alpha + (scale * normal).to(g's
    dtype)`` with ``normal = rngstream.normal(key, g.shape)`` (f32, the
    normal's counter is g's flat index), as ``ota_combine_ref`` on g as
    one row.

    g: any shape, f64 or f32; inv_alpha: a number, taken in g's dtype;
    scale: a number, taken in f32; key: a threefry key pair.
    """
    normal = rngstream.normal(key, g.shape, device=g.device)
    z = (torch.tensor(scale, dtype=torch.float32, device=g.device)
         * normal).to(g.dtype)
    inv = torch.full((1,), inv_alpha, dtype=g.dtype, device=g.device)
    return ota_combine_ref(g.reshape(1, -1), inv,
                           z.reshape(1, -1)).reshape(g.shape)


def dithered_quantize_rows_ref(g: torch.Tensor, u: torch.Tensor,
                               m: torch.Tensor,
                               levels: torch.Tensor) -> torch.Tensor:
    """Per-row dithered stochastic quantize-dequantize.

    g: (R, d) f64/f32; u: (R, d) f32 dither in [0, 1), widened to g's
    dtype (exact); m: (R,) row scale ||g_r||_inf; levels: (R,) 2^r - 1.
    Rows with ``m == 0`` or ``levels <= 0`` quantize to exactly zero.
    """
    m = m[:, None]
    levels = levels[:, None]
    valid = (levels > 0) & (m > 0)
    safe = torch.where(valid, 2.0 * m / torch.where(levels > 0, levels, 1.0),
                       1.0)
    x = (g + m) / safe
    lo = torch.floor(x)
    up = (u.to(g.dtype) < (x - lo)).to(g.dtype)
    q = torch.minimum(torch.clamp(lo + up, min=0.0), levels)
    out = -m + safe * q
    return torch.where(valid, out, torch.zeros_like(g))


def dithered_quantize_ref(g: torch.Tensor, u: torch.Tensor, m: torch.Tensor,
                          levels: torch.Tensor) -> torch.Tensor:
    """The whole tensor g (any shape) quantized with one scalar (m, levels)
    pair (0-dim tensors in g's dtype): the rows version on one row."""
    return dithered_quantize_rows_ref(
        g.reshape(1, -1), u.reshape(1, -1), m.reshape(1),
        levels.reshape(1)).reshape(g.shape)


# ------------------------------------------------- payload (wire format)
#
# Layout of the packed payload (``repro/kernels/payload.py:71-81``): a row
# of d entries, zero-padded (g = 0 and u = 0) to W*K*LANES, is laid out as
# lane-rows of LANES entries; word (w, l) holds the codes of lane-rows
# w*K + k, k = 0..K-1, at bits k*code_bits, K = 32 // code_bits. Words are
# uint32 bits kept in int32 tensors (the CPU build of torch has no uint32
# shifts or ors), so these versions compute in int64 masked to 32 bits.

LANES = 128


def payload_word_rows(d: int, code_bits: int) -> int:
    """W, the word rows of one packed row of d entries."""
    per = (32 // code_bits) * LANES
    return -(-d // per)


def _safe_step(scal: torch.Tensor):
    """(valid, safe = 2m/levels or 1, m, levels) columns of a (R, >=2)
    per-row scal of (m, levels, ...)."""
    m, levels = scal[:, :1], scal[:, 1:2]
    valid = (levels > 0) & (m > 0)
    safe = torch.where(valid, 2.0 * m / torch.where(levels > 0, levels, 1.0),
                       1.0)
    return valid, safe, m, levels


def quantize_pack_rows_ref(g: torch.Tensor, u: torch.Tensor,
                           scal: torch.Tensor, code_bits: int) -> torch.Tensor:
    """Dither -> quantize -> bit-pack each row (``_quantize_codes`` +
    ``_pack_words``).

    g: (R, d) f64/f32; u: (R, d) f32 dither; scal: (R, 2) in g's dtype,
    columns (m = ||g_r||_inf, levels <= 2^code_bits - 1). Returns words
    (R, W, LANES) int32. Rows with m = 0 or levels <= 0 code to 0.
    """
    R, d = g.shape
    K = 32 // code_bits
    W = payload_word_rows(d, code_bits)
    pad = W * K * LANES - d
    gp = torch.nn.functional.pad(g, (0, pad))
    up = torch.nn.functional.pad(u, (0, pad)).to(g.dtype)
    valid, safe, m, levels = _safe_step(scal)
    x = (gp + m) / safe
    lo = torch.floor(x)
    q = torch.minimum(torch.clamp(lo + (up < (x - lo)).to(g.dtype), min=0.0),
                      levels)
    q = torch.where(valid, q, 0.0).to(torch.int64).reshape(R, W, K, LANES)
    word = q[:, :, 0]
    for k in range(1, K):
        word = word | (q[:, :, k] << (k * code_bits))
    return torch.where(word >= 1 << 31, word - (1 << 32), word).to(torch.int32)


def _unpack_codes(words: torch.Tensor, code_bits: int, d: int) -> torch.Tensor:
    """(R, W, LANES) words -> (R, d) int64 codes (``_unpack_words``)."""
    K = 32 // code_bits
    w64 = words.to(torch.int64) & 0xFFFFFFFF
    mask = (1 << code_bits) - 1
    q = torch.stack([(w64 >> (k * code_bits)) & mask for k in range(K)],
                    dim=2)                                  # (R, W, K, LANES)
    return q.reshape(words.shape[0], -1)[:, :d]


def unpack_dequant_rows_ref(words: torch.Tensor, scal: torch.Tensor,
                            code_bits: int, d: int) -> torch.Tensor:
    """Unpack -> dequantize (``_unpack_words`` + ``_dequant``): row r's
    codes q to ``-m + safe*q`` in scal's dtype; degenerate rows to 0.

    words: (R, W, LANES) int32; scal: (R, >=2) columns (m, levels, ...).
    Returns (R, d).
    """
    valid, safe, m, _ = _safe_step(scal)
    qf = _unpack_codes(words, code_bits, d).to(scal.dtype)
    return torch.where(valid, -m + safe * qf, 0.0)


def packed_weighted_sum_ref(words: torch.Tensor, scal: torch.Tensor,
                            code_bits: int, d: int) -> torch.Tensor:
    """sum_i w_i * dequant(unpack(p_i)) per trial, devices added one at a
    time in index order from zeros (``repro/kernels/ref.py:33-52``).

    words: (T, N, W, LANES) int32; scal: (T, N, 3) columns (m, levels, w).
    Returns (T, d) in scal's dtype.
    """
    T, N = scal.shape[:2]
    acc = torch.zeros(T, d, dtype=scal.dtype, device=scal.device)
    for i in range(N):
        deq = unpack_dequant_rows_ref(words[:, i], scal[:, i], code_bits, d)
        acc = acc + scal[:, i, 2:3] * deq
    return acc


def quantized_weighted_sum_ref(g: torch.Tensor, u: torch.Tensor,
                               scal: torch.Tensor) -> torch.Tensor:
    """The fused path's sequential oracle without packing: per trial,
    ``acc + w_i * quantize(g_i)`` over devices 0..N-1 from zeros.

    g: (T, N, d); u: (T, N, d) f32; scal: (T, N, 3) columns (m, levels, w).
    """
    T, N, d = g.shape
    acc = torch.zeros(T, d, dtype=g.dtype, device=g.device)
    for i in range(N):
        gq = dithered_quantize_rows_ref(g[:, i], u[:, i], scal[:, i, 0],
                                        scal[:, i, 1])
        acc = acc + scal[:, i, 2:3] * gq
    return acc


# ------------------------------------------------- per-row statistics

#: The row reduction's order (``csrc/row_reduce.cu``), a function of d and
#: g's type alone: each row is cut into REDUCE_CLUSTER chunks of
#: :func:`reduce_chunk` entries (one block of a thread-block cluster each);
#: in a chunk, thread t of REDUCE_THREADS owns vectors t, t + T, ... of
#: 16 bytes of g (V entries), lane k of each adding into accumulator k.
REDUCE_THREADS = 256
REDUCE_CLUSTER = 8


def reduce_chunk(d: int, vec: int) -> int:
    """Entries in each of a row's REDUCE_CLUSTER chunks: ceil(d / (C V)) V,
    V = ``vec`` entries to a 16-byte vector (2 f64, 4 f32, 8 bf16)."""
    return -(-d // (REDUCE_CLUSTER * vec)) * vec


def _halving_tree(acc: torch.Tensor) -> torch.Tensor:
    """acc (..., w) as the first w of REDUCE_THREADS partials, the rest
    +0: the tree s = T/2, ..., 1 (acc[j] = acc[j] + acc[j + s], j < s),
    with the additions of +0 left out (they change no bit: a sum of
    squares is never -0). Returns (...,)."""
    s = REDUCE_THREADS // 2
    while s:
        w = acc.shape[-1]
        if w > s:
            acc = torch.cat([acc[..., :w - s] + acc[..., s:w],
                             acc[..., w - s:s]], dim=-1)
        s //= 2
    return acc[..., 0]


def row_maxabs_sumsq_ref(g: torch.Tensor, acc_dtype) -> torch.Tensor:
    """Per-row (max |g_r|, sum g_r^2) in ``acc_dtype``, in the kernel's
    order: each row padded with zeros to REDUCE_CLUSTER chunks of
    ``reduce_chunk(d, V)`` entries, each chunk to (steps, T, V); the
    (chunk, thread, lane) accumulators add the steps in turn from 0, the
    V lanes combine in order, a halving tree adds the T threads' partials
    and the chunks add in rank order. Only the threads that hold an entry
    are kept (the others' +0 changes no bit), so a row of a few entries
    needs a few accumulators.

    g: (R, d), d >= 1. Returns (R, 2): columns (maxabs, sumsq).
    """
    R, d = g.shape
    C, T = REDUCE_CLUSTER, REDUCE_THREADS
    V = 16 // g.element_size()
    L = reduce_chunk(d, V)
    n_vec = L // V
    threads = min(T, n_vec)
    steps = -(-n_vec // threads)
    x = torch.nn.functional.pad(g.to(acc_dtype), (0, C * L - d))
    x = torch.nn.functional.pad(x.reshape(R, C, L),
                                (0, (steps * threads - n_vec) * V))
    x = x.reshape(R, C, steps, threads, V)
    acc = torch.zeros(R, C, threads, V, dtype=acc_dtype, device=g.device)
    for k in range(steps):
        acc = acc + x[:, :, k] * x[:, :, k]
    part = acc[..., 0]
    for k in range(1, V):
        part = part + acc[..., k]
    part = _halving_tree(part)
    total = part[:, 0]
    for c in range(1, C):
        total = total + part[:, c]
    return torch.stack([x.abs().amax(dim=(1, 2, 3, 4)), total], dim=1)


#: steps of the plain selective scan's transients at a time (memory only:
#: the bits do not depend on it)
SCAN_CHUNK = 128


def selective_scan_ref(dt: torch.Tensor, x: torch.Tensor, bm: torch.Tensor,
                       cm: torch.Tensor, a_w: torch.Tensor,
                       h0: torch.Tensor):
    """Fused Mamba-1 selective scan, in the kernel's arithmetic:

        h_t = exp(dt_t * A) * h_{t-1} + (dt_t * B_t) * x_t
        y_t = sum_j h_t[:, j] * C_t[j],  j = 0, 1, ..., n - 1 in order

    every product and sum rounded on its own (the kernel's ``_rn``
    intrinsics), ``exp`` the accurate ``expf``. dt, x: (B, S, D), S >= 1;
    bm, cm: (B, S, n); a_w: (D, n); h0: (B, D, n), all f32. Returns
    (y (B, S, D), h_last (B, D, n)).
    """
    S = dt.shape[1]
    h = h0
    ys = []
    for s0 in range(0, S, SCAN_CHUNK):
        sl = slice(s0, s0 + SCAN_CHUNK)
        dt_c = dt[:, sl, :, None]                        # (B, c, D, 1)
        a = torch.exp(dt_c * a_w)                        # (B, c, D, n)
        b = (dt_c * bm[:, sl, None, :]) * x[:, sl, :, None]
        hs = torch.empty_like(a)
        for i in range(a.shape[1]):
            torch.add(a[:, i] * h, b[:, i], out=hs[:, i])
            h = hs[:, i]
        p = hs * cm[:, sl, None, :]
        y = p[..., 0]
        for j in range(1, p.shape[-1]):
            y = y + p[..., j]
        ys.append(y)
    return torch.cat(ys, dim=1), h.clone()


# ------------------------------------------------------------ linear scan

def linear_scan_ref(a: torch.Tensor, b: torch.Tensor,
                    h0: torch.Tensor):
    """h_t = a_t * h_{t-1} + b_t along axis 1, in the kernel's order: one
    step at a time from h0, the product and the sum each rounded on its
    own (the kernel's ``__fmul_rn`` then ``__fadd_rn``, no fused
    multiply-add). a, b: (B, S, D), S >= 1; h0: (B, D). Returns (h_all
    (B, S, D), h_last (B, D)), both in a's dtype."""
    hs = torch.empty_like(a)
    h = h0
    for t in range(a.shape[1]):
        torch.add(a[:, t] * h, b[:, t], out=hs[:, t])
        h = hs[:, t]
    return hs, h.clone()
