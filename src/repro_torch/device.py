"""Device selection for every entry point of the port.

Entry points run on the card unless the caller asks for the CPU: the
default ``device=None`` means ``"cuda"`` and raises when no card is
visible — nothing falls back to the CPU silently. Float32 matrix products
and convolutions are pinned to full float32 (no TF32), so the f32
gradients keep the precision the reference computes them in.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None``/``"cuda"`` -> the current card (raises without one);
    ``"cpu"`` (or any explicit ``torch.device``) is taken as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch path")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
