"""Projection onto the l2 ball W = {||w|| <= radius} (paper eq. (2) /
(13); counterpart of ``repro.optim.projection``)."""
from __future__ import annotations

from typing import Sequence

import torch


@torch.no_grad()
def project_l2_ball(params: Sequence[torch.Tensor],
                    radius: float) -> torch.Tensor:
    """Scale the parameters, as one flattened vector w, onto ||w|| <=
    radius, in place: each tensor's f32 sum of squares, added tensor by
    tensor in the order given (a model's in the reference's leaf order:
    ``[p for leaf in interop.reference_leaves(model) for p in
    leaf.params]``), then scale = min(1, radius / max(||w||, 1e-30)) in
    f32 and each (p.f32 * scale).to(p.dtype). Returns the scale (a 0-dim
    f32 tensor)."""
    sq = None
    for p in params:
        s = torch.sum(torch.square(p.float()))
        sq = s if sq is None else sq + s
    nrm = torch.sqrt(sq)
    # a division (``float / tensor`` would multiply by a reciprocal)
    scale = torch.clamp_max(torch.div(
        torch.tensor(radius, dtype=torch.float32, device=nrm.device),
        torch.clamp_min(nrm, float(torch.tensor(1e-30,
                                                dtype=torch.float32)))),
        1.0)
    for p in params:
        p.copy_((p.float() * scale).to(p.dtype))
    return scale
