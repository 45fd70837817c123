"""Host meshes over the ranks of a ``torch.distributed`` group (counterpart
of ``repro.launch.mesh``).

The reference lays FL clients along the ("pod", "data") axes of a JAX
mesh and leaves the "model" axis to XLA's tensor parallelism. Here a
:class:`Mesh` names the same axes over the ranks of the default process
group (one process a rank, ``launch/distributed.py``), built on
``torch.distributed.device_mesh.init_device_mesh``; each rank is one
client, client ``pod * |data| + data`` in the reference's order, and the
clients' collective runs over :func:`client_group`.

The client axes are ported, and with them the expert-parallel MoE over
"data" (``launch/sharding.py`` cuts the expert leaves over it): a
"model" axis of more than one rank (tensor parallelism) raises, and so
does the production mesh, which waits for the dry run's multi-card flags
(``NOT_PORTED``). An
:func:`abstract_mesh` has the same axes and one rank's coordinates but no
process group, so a step can be reckoned on the meta device
(``launch/analysis.py``) as one rank of a mesh that does not exist here.
"""
from __future__ import annotations

import math
from typing import Optional

import torch.distributed as dist

from ..core.dist import (Mesh, client_axes, client_group,  # noqa: F401
                         client_index, n_clients)

NOT_PORTED = ("ROADMAP Queue 1 item 10 step 6, part B (the 'model' axis, "
              "with the sequence-sharded caches; then the dry run's "
              "multi-card flags and production mesh)")


def _check_model_axis(model_axis: int) -> None:
    if model_axis != 1:
        raise NotImplementedError(
            f"model_axis={model_axis}: tensor parallelism over a 'model' "
            f"axis is not in the port yet; it arrives with {NOT_PORTED}")


def _axes(multi_pod: bool) -> tuple:
    return ("pod", "data", "model") if multi_pod else ("data", "model")


def _shape(world: int, model_axis: int, data_axis: Optional[int],
           multi_pod: bool) -> tuple:
    data = world // model_axis if data_axis is None else data_axis
    if multi_pod:
        pods = world // (data * model_axis)
        shape = (pods, data, model_axis)
    else:
        shape = (data, model_axis)
    if math.prod(shape) != world:
        raise ValueError(f"mesh {dict(zip(_axes(multi_pod), shape))} does "
                         f"not cover the {world} ranks")
    return shape


def make_host_mesh(model_axis: int = 1, data_axis: Optional[int] = None,
                   multi_pod: bool = False, device_type: str = "cuda") -> Mesh:
    """The mesh over every rank of the default group: axes ("data",
    "model"), or ("pod", "data", "model") with ``multi_pod``. ``data_axis``
    defaults to the ranks over ``model_axis``; with ``multi_pod`` the pod
    axis takes what is left (1 when ``data_axis`` is None, as the
    reference's host mesh). Ranks lie on the mesh in row-major order."""
    _check_model_axis(model_axis)
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs a process group "
                           "(launch.distributed.init_from_env or spawn)")
    world = dist.get_world_size()
    names = _axes(multi_pod)
    shape = _shape(world, model_axis, data_axis, multi_pod)
    dm = init_device_mesh(device_type, shape, mesh_dim_names=names)
    coords = {a: dm.get_local_rank(a) for a in names}
    return Mesh(names, dict(zip(names, shape)), coords, dm)


def abstract_mesh(n_clients: int, *, client: int = 0) -> Mesh:
    """A ("data", "model") mesh of ``n_clients`` one-rank clients seen
    from client ``client``, with no process group: its collectives are
    reckoned, not run."""
    names = _axes(False)
    return Mesh(names, {"data": n_clients, "model": 1},
                {"data": client, "model": 0})


def make_production_mesh(*, multi_pod: bool = False, data_axis=None):
    """The reference's (data=16, model=16) pods: not in the port yet."""
    raise NotImplementedError(
        f"the production mesh is not in the port yet; it arrives with "
        f"{NOT_PORTED}")
