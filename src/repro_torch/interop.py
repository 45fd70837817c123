"""Carry state from the JAX reference package (``repro``) into the port.

Each function reads attributes and NumPy arrays of a reference object and
builds the port's own; nothing here imports ``repro``, so the port runs
without it and the tests can drive both packages from the same designed
parameters, deployments, datasets and models.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core import baselines as B
from .core.channel import Deployment, WirelessConfig
from .core.digital import DigitalParams
from .core.ota import OTAParams
from .data.loader import FLDataset
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


def scheme(ref):
    """A reference ``core.baselines`` scheme of this slice -> the port's."""
    kind = type(ref).__name__
    if kind == "IdealFedAvg":
        return B.IdealFedAvg()
    if kind == "ProposedOTA":
        return B.ProposedOTA(ota_params(ref.params), label=ref.name)
    if kind == "VanillaOTA":
        return B.VanillaOTA(ref.dim, ref.g_max, ref.e_s, ref.n0)
    if kind == "ProposedDigital":
        return B.ProposedDigital(digital_params(ref.params), label=ref.name)
    raise NotImplementedError(
        f"no port of scheme {kind} yet (ROADMAP Queue 1 item 6)")


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
