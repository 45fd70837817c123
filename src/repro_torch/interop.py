"""Carry state from the JAX reference package (``repro``) into the port.

Each function reads attributes and NumPy arrays of a reference object and
builds the port's own; nothing here imports ``repro``, so the port runs
without it and the tests can drive both packages from the same designed
parameters, deployments, datasets and models.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .core import baselines as B
from .core.async_fl import AsyncSpec
from .core.bounds import ObjectiveWeights
from .core.channel import Deployment, WirelessConfig
from .core.digital import DigitalParams
from .core.digital_design import DigitalDesignSpec
from .core.faults import FaultSpec
from .core.ota import OTAParams
from .core.ota_design import OTADesignSpec
from .core.participation import ResolvedParticipation
from .data.loader import FLDataset
from .fl.tasks import MLPTask, SoftmaxRegressionTask, SyntheticHighDimTask
from .kernels.ops import PackedGrads
from .kernels.ref import LANES, payload_word_rows


def _fields(obj, cls) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)}


def ota_params(ref) -> OTAParams:
    """``repro.core.ota.OTAParams`` -> port ``OTAParams``."""
    kw = _fields(ref, OTAParams)
    kw["gammas"] = np.asarray(kw["gammas"], dtype=np.float64)
    return OTAParams(**kw)


def digital_params(ref) -> DigitalParams:
    """``repro.core.digital.DigitalParams`` -> port ``DigitalParams``."""
    kw = _fields(ref, DigitalParams)
    for k in ("rhos", "nus"):
        kw[k] = np.asarray(kw[k], dtype=np.float64)
    kw["r_bits"] = np.asarray(kw["r_bits"], dtype=np.int64)
    return DigitalParams(**kw)


def _design_spec(ref, cls):
    kw = _fields(ref, cls)
    kw["lambdas"] = np.asarray(kw["lambdas"], dtype=np.float64)
    kw["weights"] = ObjectiveWeights(**_fields(ref.weights, ObjectiveWeights))
    if kw["sigma_sq"] is not None:
        kw["sigma_sq"] = np.asarray(kw["sigma_sq"], dtype=np.float64)
    return cls(**kw)


def ota_design_spec(ref) -> OTADesignSpec:
    """``repro.core.ota_design.OTADesignSpec`` -> port ``OTADesignSpec``."""
    return _design_spec(ref, OTADesignSpec)


def digital_design_spec(ref) -> DigitalDesignSpec:
    """``repro.core.digital_design.DigitalDesignSpec`` -> port
    ``DigitalDesignSpec``."""
    return _design_spec(ref, DigitalDesignSpec)


def deployment(ref) -> Deployment:
    """``repro.core.channel.Deployment`` -> port ``Deployment``."""
    return Deployment(distances_m=np.asarray(ref.distances_m),
                      lambdas=np.asarray(ref.lambdas),
                      cfg=WirelessConfig(**_fields(ref.cfg, WirelessConfig)))


def dataset(ref) -> FLDataset:
    """``repro.data.loader.FLDataset`` -> port ``FLDataset``."""
    return FLDataset.from_shards(
        [(np.asarray(d.x), np.asarray(d.y)) for d in ref.devices],
        np.asarray(ref.x_test), np.asarray(ref.y_test))


def fault_spec(ref) -> FaultSpec:
    """``repro.core.faults.FaultSpec`` -> port ``FaultSpec``."""
    return FaultSpec(**_fields(ref, FaultSpec))


def async_spec(ref) -> AsyncSpec:
    """``repro.core.async_fl.AsyncSpec`` -> port ``AsyncSpec``."""
    return AsyncSpec(**_fields(ref, AsyncSpec))


def resolved_participation(ref) -> ResolvedParticipation:
    """``repro.core.participation.ResolvedParticipation`` -> the port's
    (its float64 probabilities as they are)."""
    return ResolvedParticipation(clients=int(ref.clients),
                                 policy=ref.policy,
                                 probs=tuple(float(p) for p in ref.probs))


def _restore(cls, **attrs):
    """A port scheme with the given attributes, for schemes whose
    constructor needs a deployment the reference object does not keep."""
    obj = cls.__new__(cls)
    obj.__dict__.update(attrs)
    return obj


def _ota_consts(ref) -> tuple:
    return ref.dim, ref.g_max, ref.e_s, ref.n0


def _bbfl_interior(ref):
    return _restore(B.BBFLInterior, interior=np.asarray(ref.interior),
                    gamma=float(ref.gamma), dim=ref.dim, g_max=ref.g_max,
                    e_s=ref.e_s, n0=ref.n0)


def scheme(ref):
    """A reference ``core.baselines`` scheme -> the port's, by reading its
    attributes (all 15 Sec. V schemes). Digital baselines rebuild from
    their deployment with the port's constructors, which the tests hold
    bit-equal to the reference's."""
    kind = type(ref).__name__
    if kind == "IdealFedAvg":
        return B.IdealFedAvg()
    if kind in ("ProposedOTA", "ProposedDigital"):
        params = (ota_params(ref.params) if kind == "ProposedOTA"
                  else digital_params(ref.params))
        return getattr(B, kind)(params, label=ref.name)
    if kind in ("VanillaOTA", "OPCOTAFL"):
        return getattr(B, kind)(*_ota_consts(ref))
    if kind == "OPCOTAComp":
        return B.OPCOTAComp(*_ota_consts(ref), n_grid=ref.n_grid)
    if kind == "LCPCOTAComp":
        return _restore(B.LCPCOTAComp, params=ota_params(ref.params))
    if kind == "BBFLInterior":
        return _bbfl_interior(ref)
    if kind == "BBFLAlternative":
        return _restore(B.BBFLAlternative,
                        interior_agg=_bbfl_interior(ref.interior_agg),
                        all_mask=np.asarray(ref.all_mask),
                        gamma_all=float(ref.gamma_all), dim=ref.dim,
                        g_max=ref.g_max, e_s=ref.e_s, n0=ref.n0)
    digital = {
        "BestChannel": ("k", "r_bits"), "PropFairness": ("k", "r_bits"),
        "BestChannelNorm": ("k", "k_prime", "r_total"),
        "UQOS": ("k", "r_bits", "rate"), "QML": ("k", "var_cap", "r_max"),
        "FedTOE": ("k", "p_out", "t_budget_s", "r_max")}
    if kind in digital:
        # constructor keyword -> the attribute the reference keeps it in
        attr = {"r_bits": "r", "k_prime": "kp", "t_budget_s": "t_budget"}
        kw = {a: getattr(ref, attr.get(a, a)) for a in digital[kind]}
        return getattr(B, kind)(deployment(ref.dep), ref.dim, ref.g_max,
                                ref.e_s, ref.n0, ref.B, **kw)
    raise TypeError(f"{kind} is not a scheme of repro.core.baselines")


def task(ref):
    """A ``repro.fl.tasks`` task -> the port's task of the same
    constructor arguments (``SyntheticHighDimTask`` by its dim, g_max
    and seed)."""
    kind = type(ref).__name__
    if kind == "SoftmaxRegressionTask":
        return SoftmaxRegressionTask(ref.n_features, ref.n_classes,
                                     mu=ref.mu, g_max=ref.g_max)
    if kind == "MLPTask":
        return MLPTask(ref.n_features, ref.hidden, ref.n_classes,
                       mu_nc=ref.mu_nc, g_max=ref.g_max, seed=ref._seed)
    if kind == "SyntheticHighDimTask":
        return SyntheticHighDimTask(ref.dim, g_max=ref.g_max,
                                    seed=ref._seed)
    raise TypeError(f"{kind} is not a task of repro.fl.tasks")


def load_weights(task, w) -> None:
    """Set a task's buffers (``SoftmaxRegressionTask.weight``; ``MLPTask``'s
    W1, b1, W2, b2) from the reference's flat model vector w (d,): the
    buffers, flattened row-major in registration order, are w's layout."""
    w = torch.as_tensor(np.asarray(w, dtype=np.float64))
    if w.shape != (task.dim,):
        raise ValueError(f"w has shape {tuple(w.shape)}, the task takes "
                         f"({task.dim},)")
    parts = torch.split(w, [b.numel() for b in task.buffers()])
    for buf, part in zip(task.buffers(), parts):
        buf.copy_(part.reshape(buf.shape))


def flat_weights(task) -> np.ndarray:
    """A task's buffers as the reference's flat f64 model vector w (d,)."""
    return torch.cat([b.detach().reshape(-1).to(torch.float64).cpu()
                      for b in task.buffers()]).numpy()


def packed_grads(ref) -> PackedGrads:
    """``repro.kernels.ops.PackedGrads`` -> port ``PackedGrads``.

    The reference's uint32 words (N*R_dev/K, LANES) carry each device's
    codes in the same layout, padded further (to its row tile); the port
    keeps each device's first W = ``payload_word_rows(d, code_bits)`` word
    rows, which hold every code of the d entries.
    """
    words = np.asarray(ref.words).view(np.int32).reshape(ref.n_dev, -1,
                                                         LANES)
    w_rows = payload_word_rows(ref.d, ref.code_bits)
    return PackedGrads(
        words=torch.from_numpy(np.ascontiguousarray(words[:, :w_rows])),
        scal=torch.from_numpy(np.array(ref.scal)),
        code_bits=int(ref.code_bits), d=int(ref.d))


def _leaf_tensor(x) -> torch.Tensor:
    """A NumPy leaf as a tensor; bf16 leaves (ml_dtypes' ``bfloat16``) go
    through their raw 16 bits."""
    x = np.array(x)                       # a writable copy
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def _flatten(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def model_state(params: dict, model=None) -> dict:
    """The reference model's parameters (``Transformer.init``'s nested dict
    of NumPy arrays) -> the port's ``state_dict``. Stacked leaves
    ``groups/b<i>/...`` carry a leading group axis: group g, block i is the
    port's layer ``g * len(pattern) + i``; tail layer ``tail/<j>/...`` is
    layer ``n_groups * len(pattern) + j``; the encoder's
    ``enc_groups/b0/...`` are stacked over its layers: layer g is the
    port's ``enc_layers.<g>``. Load with
    ``model.load_state_dict(model_state(...))``.

    The mesh form: given a ``model`` built with a placement
    (``launch.sharding.Placement``), each leaf is cut to this rank's
    block (its spec from the leaf's logical axes, ``model.axes()``)
    before it becomes a tensor, so only the block is ever copied."""
    state = {}
    groups = params.get("groups", {})
    pattern_len = len(groups)
    n_grouped = (pattern_len * len(next(_flatten(groups))[1])
                 if groups else 0)
    place = None if model is None else model.placement
    if place is not None:
        axes = dict(zip((leaf.key for leaf in reference_leaves(model)),
                        model.axes()))
    for name, leaf in _flatten(params):
        if place is not None:
            leaf = place.block(leaf, axes[name.replace(".", "/")])
        head, _, rest = name.partition(".")
        if head == "tail":
            j, _, leaf_name = rest.partition(".")
            state[f"layers.{n_grouped + int(j)}.{leaf_name}"] = \
                _leaf_tensor(leaf)
        elif head in ("groups", "enc_groups"):
            block, _, leaf_name = rest.partition(".")
            port, n_blocks = (("layers", pattern_len) if head == "groups"
                              else ("enc_layers", 1))
            for g, v in enumerate(np.asarray(leaf)):
                state[f"{port}.{g * n_blocks + int(block[1:])}."
                      f"{leaf_name}"] = _leaf_tensor(v)
        else:
            state[name] = _leaf_tensor(leaf)
    return state


class Leaf(NamedTuple):
    """One leaf of the reference's parameter tree, viewed in the port: its
    '/'-joined key path, the port's parameters that make it (one per
    group, stacked along a leading axis, for ``groups/...`` leaves; one
    otherwise), and whether it is stacked."""
    key: str
    params: tuple
    stacked: bool

    @property
    def shape(self) -> tuple:
        one = tuple(self.params[0].shape)
        return (len(self.params),) + one if self.stacked else one

    def value(self, of=lambda p: p) -> torch.Tensor:
        """The leaf as the reference holds it (a new tensor when stacked),
        built from ``of(param)`` (e.g. each parameter's ``.grad``)."""
        parts = [of(p) for p in self.params]
        return torch.stack(parts) if self.stacked else parts[0]

    def parts(self, value: torch.Tensor) -> tuple:
        """A leaf-shaped tensor cut into the pieces of ``params``."""
        return tuple(value) if self.stacked else (value,)


def reference_leaves(model) -> list:
    """The inverse of :func:`model_state`: the port model's parameters as
    the reference's leaves, in the order ``jax.tree.leaves`` gives them
    (keys sorted at every level); on a rank of a mesh, its blocks of
    them. Layer i of a pattern of P kinds is block
    ``b<i % P>`` of group ``i // P`` while whole groups last, then
    ``tail/<j>``; encoder layer i is group i of ``enc_groups/b0``. So an
    encoder-decoder's leaves run ``embed``, ``enc_groups/...``,
    ``enc_norm``, ``final_norm``, ``groups/...``, ``lm_head``, and a
    block's ``attn``, ``cross``, ``ln1``, ``ln2``, ``ln_cross``, ``mlp``.
    Per-leaf quantities of the wireless collective (the quantizer's m,
    the key of ``split(key, n_leaves)``, the dither and noise counters)
    are taken over these stacked leaves."""
    pattern_len = len(model.cfg.layer_pattern)
    n_grouped = model.cfg.n_layers // pattern_len * pattern_len
    leaves: dict = {}
    for name, p in model.named_parameters():
        head, _, rest = name.partition(".")
        if head not in ("layers", "enc_layers"):
            leaves[(head,)] = [False, p]
            continue
        i, _, leaf_name = rest.partition(".")
        i = int(i)
        if head == "enc_layers":
            key = ("enc_groups", "b0", *leaf_name.split("."))
            leaves.setdefault(key, [True]).append(p)
        elif i < n_grouped:
            key = ("groups", f"b{i % pattern_len}", *leaf_name.split("."))
            leaves.setdefault(key, [True]).append(p)
        else:
            key = ("tail", str(i - n_grouped), *leaf_name.split("."))
            leaves[key] = [False, p]
    return [Leaf("/".join(k), tuple(v[1:]), v[0])
            for k, v in sorted(leaves.items())]
