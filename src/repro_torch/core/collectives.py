"""wireless_psum — the paper's biased aggregation as the FL-LM train
step's collective, on one card (counterpart of
``repro.core.collectives``).

The reference runs it inside ``shard_map`` with the FL clients along the
mesh's data axes; here the N clients' gradients arrive one after another
and the "psum" adds them in client order. Per client m and reference leaf
g (a parameter stacked over its layer groups, leaves in the reference's
order, ``interop.reference_leaves``):

    ideal    ghat = sum_m g_m / N
    ota      ghat = ota_combine(sum_m w_m g_m, alpha, noise_scale, k_j)
             (eq. (6): post-scale and AWGN, one launch of the OTA
             epilogue a leaf, k_j = split(key, n_leaves)[j])
    digital  ghat = sum_m w_m Q_m(g_m), Q_m = dithered_quantize with the
             leaf's m = max|g_m|, client m's levels and the key
             split(fold_in(key, m), n_leaves)[j] (one launch of the
             whole-tensor quantizer per client and leaf)

Aggregation is in f32 whatever the model dtype, and the result is cast
back to each leaf's dtype. The torch.distributed form (clients on several
cards) is ROADMAP Queue 1 item 10.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import torch

from ..kernels import ops as kops
from . import rngstream


@dataclasses.dataclass(frozen=True)
class WirelessRound:
    """Per-round aggregation inputs; ``weight`` and ``levels`` have one
    entry per client."""

    weight: torch.Tensor       # (N,) chi_m*gamma_m (OTA) or chi_m/nu_m (digital)
    alpha: torch.Tensor        # scalar post-scaler (OTA; 1.0 for digital)
    noise_scale: torch.Tensor  # scalar: sqrt(N0)/alpha (OTA; 0 for digital)
    levels: torch.Tensor       # (N,) quantizer levels 2^r - 1 (digital)


def wireless_psum(clients: Iterable[Sequence[torch.Tensor]],
                  round_info: WirelessRound, key, *, mode: str = "ota",
                  use_kernel: bool = True) -> list:
    """Biased wireless aggregation of per-client gradient leaves.

    ``clients`` yields, client by client in index order, the list of that
    client's gradient leaves (same shapes and order for every client); it
    may be a generator, so only one client's gradients need be alive at a
    time. ``key`` is a threefry key pair (``rngstream.prng_key(step)`` for
    ``jax.random.key(step)``). Returns the aggregated leaves, each in its
    leaf's dtype.
    """
    if mode not in ("ideal", "ota", "digital"):
        raise ValueError(mode)
    acc, dtypes, n = None, None, 0
    for m, leaves in enumerate(clients):
        if acc is None:
            acc, dtypes = [None] * len(leaves), [g.dtype for g in leaves]
            dev = leaves[0].device
            weight = torch.as_tensor(round_info.weight,
                                     dtype=torch.float32).to(dev)
            levels = torch.as_tensor(round_info.levels,
                                     dtype=torch.float32).to(dev)
        if mode == "digital":
            keys = rngstream.split(rngstream.fold_in(key, m), len(leaves))
        for j, g in enumerate(leaves):
            if mode == "ideal":
                x = g.float()
            elif mode == "ota":
                x = (g * weight[m].to(g.dtype)).float()
            else:
                x = kops.dithered_quantize(g.float(), levels[m], keys[j],
                                           use_kernel=use_kernel) * weight[m]
            acc[j] = x if acc[j] is None else acc[j] + x
        n += 1
    if mode == "ideal":
        acc = [a / n for a in acc]
    elif mode == "ota":
        keys = rngstream.split(key, len(acc))
        acc = [kops.ota_combine(a, round_info.alpha, round_info.noise_scale,
                                k, use_kernel=use_kernel)
               for a, k in zip(acc, keys)]
    return [a.to(dt) for a, dt in zip(acc, dtypes)]
