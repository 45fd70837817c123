"""Plain PyTorch versions of the port's kernels (counterparts of
``repro.kernels.ref``).

Each repeats its kernel's arithmetic op for op, with multiply and add kept
separate, so on the card a kernel and its plain version agree bit for
bit. They serve CPU tensors and the tests; with a card present the main
path reaches them only when ``use_kernel=False`` asks for them.
"""
from __future__ import annotations

import torch


def ota_combine_ref(g: torch.Tensor, inv_alpha: torch.Tensor,
                    z: torch.Tensor) -> torch.Tensor:
    """OTA epilogue (eq. (6)): ``g * inv_alpha + z`` per row.

    g: (R, d) payload (f64, f32 or bf16); inv_alpha: (R,) and z: (R, d)
    (pre-scaled noise) in the accumulate dtype, to which g widens.
    """
    return g.to(z.dtype) * inv_alpha[:, None] + z


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
