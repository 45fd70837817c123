"""The kernels' callers on the FL path (counterparts of ``repro.kernels.ops``).

The arithmetic the reference keeps outside its Pallas kernels stays
outside here too: ``inv_alpha = 1/alpha`` and ``z = noise * inv_alpha``
before the OTA epilogue, the row scale ``m = max|g|`` before the
quantizer, and the ``weights @ gq`` matvec after it. ``use_kernel=False``
runs the plain versions (``kernels/ref.py``) directly, as the reference's
flag runs its jnp oracles.
"""
from __future__ import annotations

import torch

from . import ref
from .dithered_quant import dithered_quantize_rows
from .ota_combine import ota_combine

# The reference switches the digital aggregate to its fused
# quantize -> bit-pack -> dequantize-accumulate kernels at this payload
# dimension; the port has not ported those kernels yet.
FUSED_MIN_DIM = 1 << 17
CODE_BITS_CHOICES = (4, 8, 16)


def code_bits_for(r_max) -> int | None:
    """Smallest packable code width covering r_max-bit quantizers."""
    if r_max is None:
        return None
    for cb in CODE_BITS_CHOICES:
        if int(r_max) <= cb:
            return cb
    return None


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
        out = ota_combine(g2.contiguous(), inv_alpha, z)
    else:
        out = ref.ota_combine_ref(g2, inv_alpha, z)
    return out.reshape(g.shape)


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


def quantized_weighted_sum(gs: torch.Tensor, levels: torch.Tensor,
                           dither: torch.Tensor, weights: torch.Tensor,
                           *, r_max=None, use_kernel: bool = True,
                           fused="auto") -> torch.Tensor:
    """The digital aggregate sum_i w_i * quantize(g_i), two-step path.

    gs, dither: (..., N, d); levels, weights: (..., N). Quantize-dequantize
    all rows in one launch, then the weighted matvec per leading index.
    The reference's fused pack path (``fused=True``, or ``"auto"`` with a
    packable ``r_max`` at d >= 2^17) is not ported yet and raises.
    """
    d = gs.shape[-1]
    if fused is True or (fused == "auto" and use_kernel
                         and code_bits_for(r_max) is not None
                         and d >= FUSED_MIN_DIM):
        raise NotImplementedError(
            f"the fused quantize-pack digital path (d={d} >= "
            f"{FUSED_MIN_DIM}) needs the payload kernels of ROADMAP "
            "Queue 2 (quantize_pack_rows_2d, packed_weighted_sum_2d)")
    gq = dithered_quantize_batch(gs.reshape(-1, d), levels.reshape(-1),
                                 dither.reshape(-1, d),
                                 use_kernel=use_kernel).reshape(gs.shape)
    w = weights.to(gs.dtype).unsqueeze(-2)
    return (w @ gq).squeeze(-2)
