"""Minimal npz checkpointing (counterpart of ``repro.checkpoint.ckpt``).

A checkpoint is ``ckpt_<step:08d>.npz`` holding the model's parameters as
the reference's tree flattens them: '/'-joined key paths of the stacked
leaves (``groups/b0/attn/wq`` is (n_groups, d, H, hd),
``interop.reference_leaves``), extras under ``__extra__/``. So either
package reads the other's checkpoints. bf16 arrays are stored as the
reference's ``np.savez`` stores them, as raw 2-byte voids (``|V2``).
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import torch

from .. import interop


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:      # bf16 bits
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _flatten(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def save_checkpoint(directory, step: int, model, extra=None) -> Path:
    """Write the model's parameters (and ``extra``, a nested dict of
    tensors or arrays) to ``directory/ckpt_<step>.npz``."""
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    with torch.no_grad():
        payload = {leaf.key: _to_numpy(leaf.value())
                   for leaf in interop.reference_leaves(model)}
    for k, v in _flatten(extra or {}):
        payload[f"__extra__/{k}"] = (_to_numpy(v) if torch.is_tensor(v)
                                     else np.asarray(v))
    path = d / f"ckpt_{step:08d}.npz"
    np.savez(path, **payload)
    return path


def latest_step(directory) -> int:
    d = Path(directory)
    steps = [int(m.group(1)) for f in d.glob("ckpt_*.npz")
             if (m := re.match(r"ckpt_(\d+)\.npz", f.name))]
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    return max(steps)


def restore_checkpoint(directory, step: int, model):
    """Load ``ckpt_<step>.npz`` into the model's parameters in place (each
    cast to its parameter's dtype); every leaf must be there with the
    model's shape. Returns the model."""
    with np.load(Path(directory) / f"ckpt_{step:08d}.npz") as data, \
            torch.no_grad():
        for leaf in interop.reference_leaves(model):
            arr = _to_tensor(data[leaf.key])
            if tuple(arr.shape) != leaf.shape:
                raise ValueError(f"checkpoint leaf {leaf.key} has shape "
                                 f"{tuple(arr.shape)}, the model "
                                 f"{leaf.shape}")
            for p, part in zip(leaf.params, leaf.parts(arr)):
                p.copy_(part)
    return model
