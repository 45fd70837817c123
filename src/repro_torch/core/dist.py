"""The collectives and the client mesh that the FL layers run over.

A :class:`Mesh` names the reference's axes ("data", "model", or ("pod",
"data", "model")) over the ranks of a ``torch.distributed`` group; each
rank is one FL client, client ``pod * |data| + data`` in the reference's
order, and the clients' collective runs over :func:`client_group`.
``launch/mesh.py`` builds meshes and ``launch/distributed.py`` starts
the ranks; this module is what ``core`` and ``fl`` need of them.

Under ``gloo`` a collective on a CUDA tensor goes through the host: the
helpers here copy the tensor to the CPU (a pinned buffer kept across
calls, as large as the largest tensor summed), run the collective there
and copy the result back (:func:`all_reduce_sum`, :func:`all_gather_cat`).
That is what sharing one card costs, and it is written out here, not left
to the backend. On tensors that hold no data (the meta device) the
collectives move nothing and report their bytes to ``kernels.reckon``'s
collective observers, so ``launch/analysis.py`` reckons them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

#: dtype -> the pinned host buffer CUDA tensors are summed through
_PINNED: dict = {}

@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes over ranks. ``shape`` maps each axis to its size, in
    order (as a JAX mesh's); ``coords`` this rank's index along each;
    ``device_mesh`` the torch DeviceMesh (None for an abstract mesh)."""
    axis_names: tuple
    shape: dict
    coords: dict
    device_mesh: Optional[object] = None


def client_axes(mesh: Mesh) -> tuple:
    """Mesh axes along which FL clients are laid out."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def n_clients(mesh: Mesh) -> int:
    n = 1
    for a in client_axes(mesh):
        n *= mesh.shape[a]
    return n


def client_index(mesh: Mesh) -> int:
    """This rank's client, ``pod * |data| + data``: the reference's
    ``cidx`` (``repro/core/collectives.py:94-97``)."""
    c = 0
    for a in client_axes(mesh):
        c = c * mesh.shape[a] + mesh.coords[a]
    return c


def client_group(mesh: Mesh):
    """The process group that spans the client axes (None for an abstract
    mesh). With the "model" axis of one rank that is every rank of the
    mesh: the "data" axis's group, or the default group on a pod mesh."""
    if mesh.device_mesh is None:
        return None
    axes = client_axes(mesh)
    if len(axes) == 1:
        return mesh.device_mesh.get_group(axes[0])
    return dist.group.WORLD


def world() -> tuple[int, int]:
    """(rank, world size) of the default group; (0, 1) without one."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def all_reduce_sum(t: torch.Tensor, group=None, *,
                   size: Optional[int] = None) -> torch.Tensor:
    """Sum ``t`` over ``group`` (the default group if None) in place and
    return it. Under ``gloo`` a CUDA tensor is summed through a host copy.
    On a tensor without data nothing moves: the call is reckoned as one
    all-reduce of ``t`` over ``size`` ranks (the group's size if None)."""
    from ..kernels import reckon     # here: a rank starts without the kernels
    if reckon.abstract(t):
        if size is None:
            size = dist.get_world_size(group) if dist.is_initialized() else 1
        return reckon.collective("all_reduce", t, size)
    if t.device.type == "cuda" and dist.get_backend(group) == "gloo":
        host = _pinned(t)
        host.copy_(t)
        dist.all_reduce(host, op=dist.ReduceOp.SUM, group=group)
        return t.copy_(host)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def _pinned(t: torch.Tensor) -> torch.Tensor:
    """A pinned host tensor of ``t``'s shape and dtype, a view of a buffer
    reused across calls (grown to the largest asked for)."""
    buf = _PINNED.get(t.dtype)
    if buf is None or buf.numel() < t.numel():
        buf = _PINNED[t.dtype] = None          # free the smaller one first
        buf = _PINNED[t.dtype] = torch.empty(t.numel(), dtype=t.dtype,
                                             pin_memory=True)
    return buf[:t.numel()].view(t.shape)


def all_gather_cat(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` (the same shape on each) concatenated along dim
    0 in rank order, on ``t``'s device. Under ``gloo`` a CUDA tensor is
    gathered through host copies."""
    n = dist.get_world_size(group)
    src = t.contiguous()
    if src.device.type == "cuda" and dist.get_backend(group) == "gloo":
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(t.device)
