"""Adam on lists of parameter tensors (counterpart of
``repro.optim.adam``, the beyond-paper LM training option).

The moments m and v are f32 whatever the parameters' dtype, the step an
int32 scalar on the host. The update is computed in f32 and cast back to
each parameter's dtype, and written into the parameters in place (the
reference returns a new tree). As in ``sgd.py``, each Python-float
coefficient is rounded to the dtype of the tensor it multiplies (f32
here), as JAX does with a weak-typed scalar: ``1 - b1`` is formed in
double on the host, then rounded. The bias corrections 1 - b ** step are
f32 powers taken on the host, so a run on the card gives the bits of the
same run on the CPU. They divide as 0-dim tensors on the parameters'
device: torch on the card multiplies by the reciprocal of a host scalar
divisor, which is not the division.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    eta: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0


def _f32(x) -> float:
    """x rounded to f32 (a weak-typed scalar against an f32 tensor)."""
    return float(torch.tensor(x, dtype=torch.float32))


def adam_init(params: Sequence[torch.Tensor]) -> dict:
    return {"m": [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                  for p in params],
            "v": [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                  for p in params],
            "step": torch.zeros((), dtype=torch.int32)}


@torch.no_grad()
def adam_update(cfg: AdamConfig, params: Sequence[torch.Tensor],
                grads: Sequence[torch.Tensor], state: dict) -> dict:
    """One Adam step (``repro.optim.adam.adam_update``), op for op:
    g = g.f32 (+ weight_decay * p.f32); m = b1 m + (1 - b1) g;
    v = b2 v + (1 - b2) g g; p = (p.f32 - eta (m / b1t) / (sqrt(v / b2t)
    + eps)).to(p.dtype), with b1t = 1 - b1 ** step in f32. The parameters
    are written in place; returns the new state."""
    step = state["step"] + 1
    stepf = step.float()
    b1t = float(1.0 - torch.pow(torch.tensor(_f32(cfg.b1)), stepf))
    b2t = float(1.0 - torch.pow(torch.tensor(_f32(cfg.b2)), stepf))
    b1, c1 = _f32(cfg.b1), _f32(1 - cfg.b1)
    b2, c2 = _f32(cfg.b2), _f32(1 - cfg.b2)
    wd, eta, eps = _f32(cfg.weight_decay), _f32(cfg.eta), _f32(cfg.eps)
    new_m, new_v = [], []
    divisors = {}
    for p, g, m, v in zip(params, grads, state["m"], state["v"]):
        if p.device not in divisors:
            divisors[p.device] = torch.tensor(
                [b1t, b2t], dtype=torch.float32, device=p.device)
        b1t_d, b2t_d = divisors[p.device]
        g32 = g.float()
        if cfg.weight_decay:
            g32 = g32 + wd * p.float()
        m = b1 * m + c1 * g32
        v = b2 * v + c2 * g32 * g32
        upd = (m / b1t_d) / (torch.sqrt(v / b2t_d) + eps)
        p.copy_((p.float() - eta * upd).to(p.dtype))
        new_m.append(m)
        new_v.append(v)
    return {"m": new_m, "v": new_v, "step": step}
