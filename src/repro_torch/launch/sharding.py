"""Logical axes -> mesh axes (counterpart of ``repro.launch.sharding``).

Every parameter of the port records the reference's tuple of logical axis
names, one per dimension (``models.common.ParamModule.param``;
``Transformer.axes()`` gives them leaf by leaf, a stacked leaf's with
"layers" in front). This module maps those names to the axes of a
``core.dist.Mesh`` with the reference's two rules:

  * divisibility: a mesh axis (or tuple of axes) is used on a dimension
    only if the dimension is a multiple of its size; otherwise the next
    candidate is tried, and in the end the dimension is replicated;
  * uniqueness: a mesh axis cuts at most one dimension of a tensor.

A :class:`Spec` is the port's ``PartitionSpec``: a plain tuple whose
entries are None, an axis name or a tuple of names, trailing Nones
stripped. :func:`local_shape` and :func:`local_block` give a rank's block
of a full leaf from its mesh coordinates (the first axis of a tuple the
major one, as a JAX ``NamedSharding`` lays blocks out), and a
:class:`Placement` hands them to ``models.common.ParamInit``, so a rank's
model holds, and draws into, only its blocks.

Default rules (tensor parallel over "model", experts over "data"): a
"model" axis of one rank cuts nothing, and the port's meshes have no
other (``launch/mesh.py``), so only the expert leaves are cut today.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

#: candidate mesh axes per logical axis, in priority order; each candidate
#: is a tuple of mesh axes used together on that dimension
DEFAULT_RULES: dict = {
    "batch": (("pod", "data"), ("data",)),
    "vocab": (("model",),),
    "embed": (),
    "heads": (("model",),),
    "kv_heads": (("model",),),
    "head_dim": (),
    "mlp": (("model",),),
    "experts": (("data",),),
    "expert_mlp": (("model",),),
    "ssm_inner": (("model",),),
    "ssm_state": (),
    "dt_rank": (),
    "lru": (("model",),),
    "conv": (),
    "layers": (),
    "seq": (),
    "cache_seq": (),
    "enc_seq": (),
}


class Spec(tuple):
    """``Spec(None, "data")``: the mesh axes that cut each dimension."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec: Spec) -> tuple:
    """Every mesh axis a spec uses, in order."""
    return tuple(a for e in spec for a in _names(e))


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    rules: dict

    @classmethod
    def default(cls, overrides: Optional[dict] = None) -> "ShardingRules":
        r = dict(DEFAULT_RULES)
        if overrides:
            r.update(overrides)
        return cls(rules=r)

    def spec_for(self, mesh, shape: Sequence[int], axes: Sequence) -> Spec:
        """The spec of a tensor of ``shape`` whose dimensions have the
        logical ``axes`` on ``mesh`` (anything with ``axis_names`` and a
        ``shape`` mapping)."""
        if len(shape) != len(axes):
            raise ValueError(f"shape {tuple(shape)} and axes {tuple(axes)} "
                             f"differ in length")
        used: set = set()
        out = []
        for dim, name in zip(shape, axes):
            chosen = None
            for mesh_axes in self.rules.get(name, ()):
                if any(a not in mesh.axis_names for a in mesh_axes):
                    continue
                if any(a in used for a in mesh_axes):
                    continue
                if dim % math.prod(mesh.shape[a] for a in mesh_axes):
                    continue
                chosen = tuple(mesh_axes)
                used.update(mesh_axes)
                break
            out.append(chosen if chosen is None or len(chosen) > 1
                       else chosen[0])
        while out and out[-1] is None:
            out.pop()
        return Spec(*out)

    def tree_specs(self, mesh, shapes: Sequence, axes: Sequence) -> list:
        """One spec a leaf: ``shapes`` and ``axes`` are lists in the same
        leaf order (the port's trees are lists in the reference's
        ``jax.tree.leaves`` order)."""
        return [self.spec_for(mesh, tuple(s), tuple(a))
                for s, a in zip(shapes, axes, strict=True)]


def params_specs(mesh, model, rules: Optional[ShardingRules] = None) -> list:
    """Each reference leaf's spec (``interop.reference_leaves`` order),
    resolved on its full shape, whatever block the model holds."""
    rules = rules or ShardingRules.default()
    return rules.tree_specs(mesh, model.full_shapes(), model.axes())


def restrict(spec: Spec, manual: Sequence[str]) -> Spec:
    """Only the ``manual`` axes of a spec (the reference's
    ``_restrict_spec``: the client axes the train step runs over)."""
    out = []
    for entry in spec:
        kept = tuple(a for a in _names(entry) if a in manual)
        out.append(None if not kept else kept[0] if isinstance(entry, str)
                   else kept)
    while out and out[-1] is None:
        out.pop()
    return Spec(*out)


def cache_axes(caches: list) -> list:
    """Logical axes of the port's caches (one dict a layer, keyed as
    ``Transformer.init_cache`` makes them), with the reference's names:
    an attention cache's k, v ("batch", "cache_seq", "kv_heads",
    "head_dim") and pos ("batch", "cache_seq"); a Mamba cache's conv
    ("batch", "conv", "ssm_inner") and h ("batch", "ssm_inner",
    "ssm_state"); an RG-LRU cache's conv (the reference names its last
    axis "ssm_inner" too) and h ("batch", "lru"). A layer's cache carries
    no "layers" axis: the port keeps one a layer."""
    def leaf(name, t):
        if name in ("k", "v"):
            return ("batch", "cache_seq", "kv_heads", "head_dim")
        if name == "pos":
            return ("batch", "cache_seq")
        if name == "conv":
            return ("batch", "conv", "ssm_inner")
        if name == "h" and t.dim() == 3:
            return ("batch", "ssm_inner", "ssm_state")
        if name == "h":
            return ("batch", "lru")
        return (None,) * t.dim()
    return [{kind: {k: leaf(k, t) for k, t in c.items()}
             for kind, c in layer.items()} for layer in caches]


def batch_axes(batch: dict) -> dict:
    """Logical axes of a model-input batch dict (``models.batch_spec``'s
    leaves: tensors, or (shape, dtype) pairs)."""
    def ndim(v):
        return v.dim() if hasattr(v, "dim") else len(v[0])
    out = {}
    for name, v in batch.items():
        out[name] = {"tokens": ("batch", "seq"),
                     "patches": ("batch", "seq", "embed"),
                     "frames": ("batch", "enc_seq", "embed")}.get(
                         name, (None,) * ndim(v))
    return out


def decode_rules(batch: int, mesh) -> ShardingRules:
    """The default rules while the batch splits over the client axes;
    otherwise (a batch of one) the caches' sequence over "data"."""
    client = [a for a in ("pod", "data") if a in mesh.axis_names]
    if batch % math.prod(mesh.shape[a] for a in client) == 0:
        return ShardingRules.default()
    return ShardingRules.default(overrides={
        "batch": (),
        "cache_seq": (("data",),),
        "seq": (("data",),),
    })


def _block_index(entry, mesh) -> tuple[int, int]:
    """(block count, this rank's block) of a dimension cut by ``entry``."""
    count, index = 1, 0
    for a in _names(entry):
        count *= mesh.shape[a]
        index = index * mesh.shape[a] + mesh.coords[a]
    return count, index


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> tuple:
    """The shape of a rank's block of a ``shape`` tensor cut by ``spec``."""
    out = []
    for i, dim in enumerate(shape):
        count, _ = _block_index(spec[i] if i < len(spec) else None, mesh)
        if dim % count:
            raise ValueError(f"dimension {i} ({dim}) of {tuple(shape)} does "
                             f"not split into {count} blocks ({spec})")
        out.append(dim // count)
    return tuple(out)


def local_block(t, spec: Spec, mesh):
    """This rank's block of the full ``t`` (a tensor or an array; a view
    where the slicing allows one)."""
    local = local_shape(t.shape, spec, mesh)
    index = []
    for i, n in enumerate(local):
        _, j = _block_index(spec[i] if i < len(spec) else None, mesh)
        index.append(slice(j * n, (j + 1) * n))
    return t[tuple(index)]


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a rank's parameters come from: ``spec(shape, axes)`` under
    ``rules`` on ``mesh``, for ``models.common.ParamInit``, which draws a
    leaf whole and keeps :func:`local_block` of it (or allocates only the
    block, for weights loaded after). A layer's parameter and its stacked
    leaf get the same blocks: the "layers" axis is never cut."""
    mesh: object
    rules: ShardingRules = dataclasses.field(
        default_factory=ShardingRules.default)

    def spec(self, shape: Sequence[int], axes: Sequence) -> Spec:
        return self.rules.spec_for(self.mesh, shape, axes)

    def local_shape(self, shape: Sequence[int], axes: Sequence) -> tuple:
        return local_shape(shape, self.spec(shape, axes), self.mesh)

    def block(self, t, axes: Sequence):
        return local_block(t, self.spec(t.shape, axes), self.mesh)
