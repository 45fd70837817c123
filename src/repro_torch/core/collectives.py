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
back to each leaf's dtype.

The mesh form (``mesh=``, :func:`mesh_psum_leaves`) is the reference's
own: one client a rank of a ``launch.mesh.Mesh``, this rank holding only
its client's leaves. Leaf by leaf, in the same order, it casts the leaf
to f32, weighs it (OTA) or quantizes it with the key
split(fold_in(key, c), n_leaves)[j] of its client c = pod |data| + data
(digital), sums it over the client axes with one ``all_reduce`` and
finishes it as above (ideal: / N; OTA: the epilogue with
split(key, n_leaves)[j], the same on every rank), then casts it back
before the next leaf is touched.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, Optional, Sequence

import torch

from ..kernels import ops as kops
from . import dist, rngstream


@dataclasses.dataclass(frozen=True)
class WirelessRound:
    """Per-round aggregation inputs; ``weight`` and ``levels`` have one
    entry per client (in the mesh form they may also be this rank's
    client's own scalar, as the reference's are)."""

    weight: torch.Tensor       # (N,) chi_m*gamma_m (OTA) or chi_m/nu_m (digital)
    alpha: torch.Tensor        # scalar post-scaler (OTA; 1.0 for digital)
    noise_scale: torch.Tensor  # scalar: sqrt(N0)/alpha (OTA; 0 for digital)
    levels: torch.Tensor       # (N,) quantizer levels 2^r - 1 (digital)


def wireless_psum(clients, round_info: WirelessRound, key, *,
                  mode: str = "ota", use_kernel: bool = True, mesh=None,
                  skip_psum: Optional[Sequence[bool]] = None) -> list:
    """Biased wireless aggregation of per-client gradient leaves.

    On one card (``mesh=None``) ``clients`` yields, client by client in
    index order, the list of that client's gradient leaves (same shapes
    and order for every client); it may be a generator, so only one
    client's gradients need be alive at a time. With a ``mesh``,
    ``clients`` is this rank's own list of leaves (:func:`mesh_psum_leaves`).
    ``key`` is a threefry key pair (``rngstream.prng_key(step)`` for
    ``jax.random.key(step)``). Returns the aggregated leaves, each in its
    leaf's dtype.
    """
    if mode not in ("ideal", "ota", "digital"):
        raise ValueError(mode)
    if mesh is not None:
        return list(mesh_psum_leaves(clients, len(clients), round_info, key,
                                     mesh, mode=mode, use_kernel=use_kernel,
                                     skip_psum=skip_psum))
    if skip_psum is not None and any(skip_psum):
        raise ValueError("skip_psum marks leaves already summed over the "
                         "client axes: a mesh form's option")
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
        # this client's leaves go before the next client's are made
        del leaves, g, x
    if mode == "ideal":
        acc = [a / n for a in acc]
    elif mode == "ota":
        keys = rngstream.split(key, len(acc))
        acc = [kops.ota_combine(a, round_info.alpha, round_info.noise_scale,
                                k, use_kernel=use_kernel)
               for a, k in zip(acc, keys)]
    return [a.to(dt) for a, dt in zip(acc, dtypes)]


def _local(x, c: int, dev) -> torch.Tensor:
    """Client ``c``'s entry of a per-client tensor, or the scalar itself."""
    x = torch.as_tensor(x, dtype=torch.float32)
    return (x.reshape(()) if x.numel() == 1 else x.reshape(-1)[c]).to(dev)


def mesh_psum_leaves(leaves: Iterable[torch.Tensor], n_leaves: int,
                     round_info: WirelessRound, key, mesh, *,
                     mode: str = "ota", use_kernel: bool = True,
                     skip_psum: Optional[Sequence[bool]] = None
                     ) -> Iterator[torch.Tensor]:
    """The mesh form, one leaf at a time: takes this rank's ``n_leaves``
    gradient leaves from ``leaves`` (an iterator, so each may be made just
    before it is reduced) and yields each aggregated leaf in its dtype
    before the next is taken. ``skip_psum[j]`` marks a leaf whose
    gradient is already summed over the clients: it gets the epilogue but
    no reduce (the reference's expert-parallel leaves)."""
    if mode not in ("ideal", "ota", "digital"):
        raise ValueError(mode)
    c, n = dist.client_index(mesh), dist.n_clients(mesh)
    group = dist.client_group(mesh)
    keys = rngstream.split(rngstream.fold_in(key, c) if mode == "digital"
                           else key, n_leaves)
    weight = levels = None
    for j, g in enumerate(leaves):
        if weight is None:
            weight = _local(round_info.weight, c, g.device)
            levels = _local(round_info.levels, c, g.device)
        dt = g.dtype
        if mode == "ideal":
            x = g.to(torch.float32, copy=True)      # reduced in place
        elif mode == "ota":
            x = (g * weight.to(dt)).float()
        else:
            x = kops.dithered_quantize(g.float(), levels, keys[j],
                                       use_kernel=use_kernel) * weight
        del g
        if skip_psum is None or not skip_psum[j]:
            x = dist.all_reduce_sum(x, group, size=n)
        if mode == "ideal":
            x = x / n
        elif mode == "ota":
            x = kops.ota_combine(x, round_info.alpha, round_info.noise_scale,
                                 keys[j], use_kernel=use_kernel)
        yield x.to(dt)
    if weight is not None and j + 1 != n_leaves:
        raise ValueError(f"{j + 1} leaves for a key split {n_leaves} ways")
