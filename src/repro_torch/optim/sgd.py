"""SGD (+momentum, weight decay) on lists of parameter tensors (counterpart
of ``repro.optim.sgd``).

The paper's update (13) is plain SGD; momentum and weight decay serve the
LM training launcher. The update is computed in f32 and cast back to each
parameter's dtype, and written into the parameters in place (the
reference returns a new tree). The coefficients are rounded to the dtype
of the tensor they multiply first, as JAX does with a Python scalar
(0.9 is 0.8984375 against a bf16 momentum).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class SGDConfig:
    eta: float = 1e-2
    momentum: float = 0.0
    weight_decay: float = 0.0


def sgd_init(params: Sequence[torch.Tensor]) -> list:
    return [torch.zeros_like(p) for p in params]


@torch.no_grad()
def sgd_update(cfg: SGDConfig, params: Sequence[torch.Tensor],
               grads: Sequence[torch.Tensor],
               mom: Optional[Sequence[torch.Tensor]] = None) -> list:
    """p <- (p.f32 - eta * u.f32).to(p.dtype) for each pair, in place, with
    u = g (+ weight_decay * p), or with momentum u = momentum * mom + g.
    ``mom=None`` is zeros. Returns the new momentum."""
    def coef(x, like):           # x rounded to like's dtype, on the host
        return float(torch.tensor(x, dtype=like.dtype))

    if mom is None:
        mom = [None] * len(params)
    new_mom = []
    for p, g, m in zip(params, grads, mom):
        if cfg.weight_decay:
            g = g + coef(cfg.weight_decay, g) * p.to(g.dtype)
        if cfg.momentum:
            m = torch.zeros_like(p) if m is None else m
            m = coef(cfg.momentum, m) * m + g.to(m.dtype)
            u = m
        else:
            u = g
        new_mom.append(m)
        u32 = u.float()
        p.copy_((p.float() - coef(cfg.eta, u32) * u32).to(p.dtype))
    return new_mom
