"""The collectives and the client mesh that the FL layers run over.

A :class:`Mesh` names the reference's axes ("data", "model", or ("pod",
"data", "model")) over the ranks of a ``torch.distributed`` group; each
rank is one FL client, client ``pod * |data| + data`` in the reference's
order, and the clients' collective runs over :func:`client_group`.
``launch/mesh.py`` builds meshes and ``launch/distributed.py`` starts
the ranks; this module is what ``core`` and ``fl`` need of them, and
what the expert-parallel MoE needs: :func:`all_to_all` and
:func:`all_mean`, both with a gradient.

Under ``gloo`` a collective on a CUDA tensor goes through the host: the
helpers here copy the tensor to the CPU (pinned buffers kept across
calls, as large as the largest tensor moved), run the collective there
and copy the result back (:func:`all_reduce_sum`, :func:`all_gather_cat`,
:func:`all_to_all`); a two-rank sum swaps the tensors by send and
receive and adds on the card. That is what sharing one card costs, and
it is written out here, not left to the backend. On tensors that hold no data (the meta device) the
collectives move nothing and report their bytes to ``kernels.reckon``'s
collective observers, so ``launch/analysis.py`` reckons them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

#: (dtype, slot) -> a pinned host buffer CUDA tensors go through
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


def axis_group(mesh: Mesh, axis: str):
    """The process group along one axis of the mesh (None for an
    abstract mesh)."""
    if mesh.device_mesh is None:
        return None
    return mesh.device_mesh.get_group(axis)


def world() -> tuple[int, int]:
    """(rank, world size) of the default group; (0, 1) without one."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def all_reduce_sum(t: torch.Tensor, group=None, *,
                   size: Optional[int] = None) -> torch.Tensor:
    """Sum ``t`` over ``group`` (the default group if None) in place and
    return it. Under ``gloo`` a CUDA tensor is summed through a host copy,
    and a group of two ranks swaps the tensors with one send and one
    receive each and adds the other's on the tensor's device
    (:func:`_add_peer`): both ranks compute the same one addition, so the
    bits are gloo's all-reduce's, in less time (two ranks sharing one
    card sum their gradients this way). On a
    tensor without data nothing moves: the call is reckoned as one
    all-reduce of ``t`` over ``size`` ranks (the group's size if None)."""
    from ..kernels import reckon     # here: a rank starts without the kernels
    if reckon.abstract(t):
        if size is None:
            size = dist.get_world_size(group) if dist.is_initialized() else 1
        return reckon.collective("all_reduce", t, size)
    if dist.get_backend(group) == "gloo" and dist.get_world_size(group) == 2:
        return _add_peer(t, group)
    if t.device.type == "cuda" and dist.get_backend(group) == "gloo":
        host = _pinned(t)
        host.copy_(t)
        dist.all_reduce(host, op=dist.ReduceOp.SUM, group=group)
        return t.copy_(host)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def _add_peer(t: torch.Tensor, group) -> torch.Tensor:
    """The two-rank sum: send ``t``, receive the other rank's, add it to
    ``t`` in place (a + b on one rank, b + a on the other: the same
    bits). A CUDA tensor goes through two pinned host buffers."""
    me = dist.get_rank(group)
    peer = 1 - me if group is None else dist.get_global_rank(group, 1 - me)
    if t.device.type == "cuda":
        send, recv = _pinned(t, 0), _pinned(t, 1)
        send.copy_(t)
    else:
        send, recv = t.contiguous(), torch.empty(t.shape, dtype=t.dtype)
    reqs = [dist.isend(send, peer, group=group),
            dist.irecv(recv, peer, group=group)]
    for r in reqs:
        r.wait()
    return t.add_(recv.to(t.device))


def _pinned(t: torch.Tensor, slot: int = 0) -> torch.Tensor:
    """A pinned host tensor of ``t``'s shape and dtype, a view of a buffer
    reused across calls (grown to the largest asked for); ``slot`` tells
    apart buffers one collective needs at once."""
    key = (t.dtype, slot)
    buf = _PINNED.get(key)
    if buf is None or buf.numel() < t.numel():
        buf = _PINNED[key] = None              # free the smaller one first
        buf = _PINNED[key] = torch.empty(t.numel(), dtype=t.dtype,
                                         pin_memory=True)
    return buf[:t.numel()].view(t.shape)


def _exchange(t: torch.Tensor, group, size: Optional[int]) -> torch.Tensor:
    """The all-to-all itself (no gradient): block i of dim 0 goes to rank
    i, and block i of the result comes from rank i."""
    from ..kernels import reckon     # here: a rank starts without the kernels
    if reckon.abstract(t):
        if size is None:
            size = dist.get_world_size(group) if dist.is_initialized() else 1
        return reckon.collective("all_to_all", torch.empty_like(t), size)
    t = t.contiguous()
    if t.device.type == "cuda" and dist.get_backend(group) == "gloo":
        send, recv = _pinned(t, 0), _pinned(t, 1)
        send.copy_(t)
        dist.all_to_all_single(recv, send, group=group)
        return recv.to(t.device, copy=True)
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    """The exchange, differentiable: for split = concat = dim 0 the
    permutation is its own adjoint, so the backward pass is the same
    exchange of the gradient."""

    @staticmethod
    def forward(ctx, t, group, size):
        ctx.group, ctx.size = group, size
        return _exchange(t, group, size)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group, ctx.size), None, None


def all_to_all(t: torch.Tensor, group=None, *,
               size: Optional[int] = None) -> torch.Tensor:
    """Equal splits of ``t`` along dim 0 over ``group`` (the default
    group if None), as ``jax.lax.all_to_all(t, axis, 0, 0)``: dim 0 must
    be the group's size; block i goes to rank i and block i of the result
    came from rank i. Under NCCL one ``all_to_all_single``; under
    ``gloo`` a CUDA tensor goes through two pinned host buffers. On a
    tensor without data nothing moves: the call is reckoned as one
    all-to-all of ``t`` over ``size`` ranks (the group's size if None).
    It has a gradient (the same exchange)."""
    n = size if size is not None else (
        dist.get_world_size(group) if dist.is_initialized() else 1)
    if t.shape[0] != n:
        raise ValueError(f"all_to_all of a tensor of {t.shape[0]} blocks "
                         f"over {n} ranks")
    return _AllToAll.apply(t, group, size)


class _AllMean(torch.autograd.Function):
    """The mean over the group, differentiable as the reference's
    ``pmean`` under ``shard_map(check_vma=False)``: its backward pass is
    the mean of the cotangents over the group (a ``psum`` over n)."""

    @staticmethod
    def forward(ctx, t, group, size):
        ctx.group, ctx.size = group, size
        return all_reduce_sum(t.detach().clone(), group, size=size) / size

    @staticmethod
    def backward(ctx, g):
        return (all_reduce_sum(g.clone(), ctx.group, size=ctx.size)
                / ctx.size, None, None)


def all_mean(t: torch.Tensor, group, size: int) -> torch.Tensor:
    """The mean of ``t`` over the ``size`` ranks of ``group``, with a
    gradient (:class:`_AllMean`)."""
    return _AllMean.apply(t, group, size)


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
