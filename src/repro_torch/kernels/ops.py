"""The kernels' callers (counterparts of ``repro.kernels.ops``).

The arithmetic the reference keeps outside its Pallas kernels stays
outside here too: ``inv_alpha = 1/alpha`` and ``z = noise * inv_alpha``
before the OTA epilogue, the row scale ``m = max|g|`` before the
quantizer and the packer, and the ``weights @ gq`` matvec after the
two-step quantizer. ``use_kernel=False`` runs the plain versions
(``kernels/ref.py``) directly, as the reference's flag runs its jnp
oracles.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import rngstream
from . import payload, ref, row_reduce
from .dithered_quant import dithered_quantize_rows
from .dithered_quant import dithered_quantize as dithered_quantize_kernel
from .linear_scan import linear_scan as linear_scan_kernel
from .ota_combine import ota_combine as ota_combine_kernel
from .ota_combine import ota_combine_keyed
from .payload import CODE_BITS_CHOICES
from .selective_scan import selective_scan as selective_scan_kernel

# At this payload dimension the digital aggregate switches from the
# two-step quantize + matvec to the fused quantize -> bit-pack ->
# dequantize-accumulate path, as the reference does.
FUSED_MIN_DIM = 1 << 17


def code_bits_for(r_max) -> int | None:
    """Smallest packable code width covering r_max-bit quantizers."""
    if r_max is None:
        return None
    for cb in CODE_BITS_CHOICES:
        if int(r_max) <= cb:
            return cb
    return None


def fused_route(r_max, d: int) -> bool:
    """Whether the digital aggregate of a d-entry payload quantized at up
    to r_max bits takes the fused pack route: a packable width and
    d >= FUSED_MIN_DIM."""
    return code_bits_for(r_max) is not None and d >= FUSED_MIN_DIM


def ota_combine_with_noise(g: torch.Tensor, alpha, noise: torch.Tensor,
                           *, use_kernel: bool = True,
                           acc_dtype=None) -> torch.Tensor:
    """ghat = g*inv_alpha + noise*inv_alpha with inv_alpha = 1/alpha (eq. (6)).

    g, noise: (..., d), one row per leading index (trials); alpha: a
    scalar or one value per row (Vanilla OTA's per-trial N*gamma_t).
    Within 1 ulp of (g + noise)/alpha, as the reference. ``acc_dtype``
    widens the output above a narrow payload (bf16 g, f32 combine).
    """
    out_dt = g.dtype if acc_dtype is None else acc_dtype
    d = g.shape[-1]
    g2 = g.reshape(-1, d)
    inv_alpha = (1.0 / torch.as_tensor(alpha, dtype=torch.float64,
                                       device=g.device)).to(out_dt)
    inv_alpha = inv_alpha.reshape(-1).expand(g2.shape[0]).contiguous()
    z = noise.to(out_dt).reshape(g2.shape) * inv_alpha[:, None]
    if use_kernel:
        out = ota_combine_kernel(g2.contiguous(), inv_alpha, z)
    else:
        out = ref.ota_combine_ref(g2, inv_alpha, z)
    return out.reshape(g.shape)


def ota_combine(g: torch.Tensor, alpha, noise_scale, key,
                *, use_kernel: bool = True) -> torch.Tensor:
    """ghat = g/alpha + noise_scale * N(0, 1) for a whole tensor g (f32 or
    f64), with the normals drawn from the threefry ``key``
    (``repro/kernels/ops.py:354``): ``noise_scale`` is already divided by
    alpha, so z is not scaled again. inv_alpha = (1/alpha) in f32, then
    g's dtype, and noise_scale in f32 are made on the host (alpha and
    noise_scale are host values on the train path) and passed as numbers;
    one launch of the OTA epilogue's keyed entry, which draws the normals
    itself. ``use_kernel=False`` draws them with ``rngstream.normal`` and
    runs the plain epilogue (``ref.ota_combine_keyed_ref``), same bits."""
    inv_alpha = float((1.0 / torch.as_tensor(alpha, dtype=torch.float32))
                      .to(g.dtype))
    scale = float(torch.as_tensor(noise_scale, dtype=torch.float32))
    if use_kernel:
        return ota_combine_keyed(g.contiguous(), inv_alpha, scale, key)
    return ref.ota_combine_keyed_ref(g, inv_alpha, scale, key)


def row_maxabs_sumsq(gs: torch.Tensor, *, use_kernel: bool = True,
                     acc_dtype=None):
    """Per-device gradient statistics in one pass (one launch for every
    leading index): gs (..., N, d) -> (maxabs (..., N), sumsq (..., N)),
    ``||g||_inf`` and ``sum g^2`` in ``acc_dtype`` (default gs's dtype;
    bf16 payloads take f32). The sum's order is the kernel's, a function
    of d and the dtype alone: 8 chunks of a row (one block of a cluster
    each), 256 threads a chunk striding over its 16-byte vectors with one
    accumulator a lane, the lanes in order, a halving tree over the
    threads, the chunks in rank order (``ref.row_maxabs_sumsq_ref``), so
    ``use_kernel=False`` gives the same bits.
    """
    acc_dtype = gs.dtype if acc_dtype is None else acc_dtype
    g2 = gs.reshape(-1, gs.shape[-1])
    out = (row_reduce.row_maxabs_sumsq(g2.contiguous(), acc_dtype)
           if use_kernel else ref.row_maxabs_sumsq_ref(g2, acc_dtype))
    return (out[:, 0].reshape(gs.shape[:-1]),
            out[:, 1].reshape(gs.shape[:-1]))


def dithered_quantize(g: torch.Tensor, levels, key,
                      *, use_kernel: bool = True) -> torch.Tensor:
    """Dithered stochastic quantize-dequantize of a whole tensor g (f32 or
    f64) with m = max|g| over all of it and f32 dither uniform(key,
    g.shape), whose counter is g's flat index (``repro/kernels/ops.py:102``).
    m = 0 or levels <= 0 gives exactly 0. One launch over the tensor."""
    m = g.abs().amax()
    levels = torch.as_tensor(levels, dtype=g.dtype, device=g.device)
    dither = rngstream.uniform(key, g.shape, device=g.device)
    if not use_kernel:
        return ref.dithered_quantize_ref(g, dither, m, levels)
    return dithered_quantize_kernel(g.contiguous(), dither,
                                    torch.stack([m, levels]))


def dithered_quantize_batch(gs: torch.Tensor, levels: torch.Tensor,
                            dither: torch.Tensor,
                            *, use_kernel: bool = True) -> torch.Tensor:
    """Quantize the rows of gs (R, d), each with its own ||g_r||_inf and
    levels (R,) = 2^{r} - 1, against f32 dither (R, d)."""
    m = gs.abs().amax(dim=1)
    levels = levels.to(gs.dtype)
    if not use_kernel:
        return ref.dithered_quantize_rows_ref(gs, dither, m, levels)
    scal = torch.stack([m, levels], dim=1)
    return dithered_quantize_rows(gs.contiguous(), dither.contiguous(), scal)


@dataclasses.dataclass
class PackedGrads:
    """Bit-packed device payloads (the digital uplink's wire format).

    words holds each row's quantizer codes at ``code_bits`` per entry,
    K = 32/code_bits codes per uint32 word (kept as int32), in the
    reference's layout; scal holds each row's (||g||_inf, levels). Leading
    dimensions are the gradients' (trials, devices).
    """
    words: torch.Tensor       # (..., W, LANES) int32
    scal: torch.Tensor        # (..., 2)
    code_bits: int
    d: int


def quantize_pack(gs: torch.Tensor, levels: torch.Tensor,
                  dither: torch.Tensor, *, code_bits: int) -> PackedGrads:
    """Dither -> quantize -> bit-pack every row of gs (..., d) in one
    launch; levels (...,) = 2^{r} - 1 with r <= code_bits, dither f32."""
    lead, d = gs.shape[:-1], gs.shape[-1]
    g2 = gs.reshape(-1, d).contiguous()
    scal = torch.stack([g2.abs().amax(dim=1),
                        levels.reshape(-1).to(gs.dtype)], dim=1)
    words = payload.quantize_pack_rows(
        g2, dither.reshape(-1, d).contiguous(), scal, code_bits)
    return PackedGrads(words.reshape(*lead, *words.shape[1:]),
                       scal.reshape(*lead, 2), code_bits, d)


def unpack_dequant(pk: PackedGrads) -> torch.Tensor:
    """Decode a packed payload to its (..., d) dequantized floats, the
    bit-exact output of ``dithered_quantize_batch`` on the same inputs."""
    lead = pk.scal.shape[:-1]
    out = payload.unpack_dequant_rows(
        pk.words.reshape(-1, *pk.words.shape[-2:]), pk.scal.reshape(-1, 2),
        pk.code_bits, pk.d)
    return out.reshape(*lead, pk.d)


def packed_weighted_sum(pk: PackedGrads,
                        weights: torch.Tensor) -> torch.Tensor:
    """sum_i w_i * dequant(payload_i) over the device axis (the last
    leading one), devices in index order, with an O(d) accumulator per
    trial: one launch for all trials. weights (..., N) -> (..., d)."""
    lead = pk.scal.shape[:-2]
    n = pk.scal.shape[-2]
    scal3 = torch.cat([pk.scal, weights.to(pk.scal.dtype)[..., None]],
                      dim=-1).reshape(-1, n, 3)
    words = pk.words.reshape(-1, n, *pk.words.shape[-2:])
    return payload.packed_weighted_sum(words, scal3, pk.code_bits,
                                       pk.d).reshape(*lead, pk.d)


def quantized_weighted_sum(gs: torch.Tensor, levels: torch.Tensor,
                           dither: torch.Tensor, weights: torch.Tensor,
                           *, r_max=None, use_kernel: bool = True,
                           fused="auto") -> torch.Tensor:
    """The digital aggregate sum_i w_i * quantize(g_i).

    gs, dither: (..., N, d); levels, weights: (..., N). Two routes, chosen
    as the reference chooses (``repro/kernels/ops.py:265-302``):

      * two-step — quantize-dequantize all rows in one launch, then the
        weighted matvec per leading index;
      * fused — quantize straight into packed codes (one launch over all
        rows), then unpack-dequantize-accumulate (one launch, one output
        row per leading index), devices in index order.

    ``fused="auto"`` fuses iff ``use_kernel`` and ``fused_route(r_max, d)``
    (a packable ``r_max`` <= 16 bits and d >= FUSED_MIN_DIM), as the
    reference; True/False force the route.
    ``use_kernel=False`` with ``fused=True`` runs the sequential plain
    version (same device order as the fused kernel, no packing).
    """
    cb = code_bits_for(r_max)
    d = gs.shape[-1]
    if fused == "auto":
        fused = use_kernel and fused_route(r_max, d)
    if not fused:
        gq = dithered_quantize_batch(gs.reshape(-1, d), levels.reshape(-1),
                                     dither.reshape(-1, d),
                                     use_kernel=use_kernel).reshape(gs.shape)
        w = weights.to(gs.dtype).unsqueeze(-2)
        return (w @ gq).squeeze(-2)
    if not use_kernel:
        n = gs.shape[-2]
        g3 = gs.reshape(-1, n, d)
        scal3 = torch.stack([g3.abs().amax(dim=-1),
                             levels.to(gs.dtype).expand(gs.shape[:-1])
                             .reshape(-1, n),
                             weights.to(gs.dtype).reshape(-1, n)], dim=-1)
        out = ref.quantized_weighted_sum_ref(g3, dither.reshape(-1, n, d),
                                             scal3)
        return out.reshape(*gs.shape[:-2], d)
    if cb is None:
        raise ValueError(f"the fused quantized_weighted_sum needs a static "
                         f"r_max <= {max(CODE_BITS_CHOICES)} (got "
                         f"r_max={r_max})")
    pk = quantize_pack(gs, levels.to(gs.dtype).expand(gs.shape[:-1]),
                       dither, code_bits=cb)
    return packed_weighted_sum(pk, weights)


def selective_scan(dt: torch.Tensor, x: torch.Tensor, bm: torch.Tensor,
                   cm: torch.Tensor, a_w: torch.Tensor, h0: torch.Tensor,
                   *, use_kernel: bool = True):
    """Fused Mamba-1 selective scan. dt, x: (B, S, D); bm, cm: (B, S, n);
    a_w: (D, n); h0: (B, D, n), all f32. Returns (y (B, S, D), h_last
    (B, D, n)). The kernel takes the layout as it is (no padding or
    transpose); ``use_kernel=False`` runs its plain version, which gives
    the same bits."""
    ins = [t.contiguous() for t in (dt, x, bm, cm, a_w, h0)]
    if use_kernel:
        return selective_scan_kernel(*ins)
    return ref.selective_scan_ref(*ins)


def linear_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
                *, use_kernel: bool = True):
    """h_t = a_t h_{t-1} + b_t over axis 1. a, b: (B, S, D); h0: (B, D);
    all f32. Returns (h_all, h_last). The kernel takes the layout as it is:
    the reference pads S to 256 and D to 128 with a = 1, b = 0 for its
    block shape, which changes nothing, so nothing is padded here.
    ``use_kernel=False`` runs its plain version, which gives the same
    bits."""
    ins = [t.contiguous() for t in (a, b, h0)]
    if use_kernel:
        return linear_scan_kernel(*ins)
    return ref.linear_scan_ref(*ins)
