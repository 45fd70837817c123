"""Step factories (counterparts of ``repro.launch.steps``): the FL train
step with the wireless collective, and the serve prefill and decode steps.

Plain functions over a model already on its device. FL clients are the
reference's data-axis slices: client m of N takes batch rows
[m B/N, (m+1) B/N); every leaf of a batch (``tokens``, and an audio
model's ``frames`` or a VLM's ``patches``) is cut by those rows. On one
card (``n_clients=N``) the clients run one after another; on a
``launch.mesh.Mesh`` (``mesh=``) each rank is one client, the gradients
meet in the mesh form of ``wireless_psum`` and the parameters stay
replicated, bit-identical on every rank.

Not in the port yet (ROADMAP Queue 1 item 10 step 6, part B, in order):
the logical axes on the parameters and the reference's ``sharding.py``;
the expert-parallel MoE with ``_a2a_quantized`` and ``skip_psum`` set;
the "model" axis; the serve steps on a mesh; the dry run's multi-card
flags and production mesh; qwen3-8b's FL step on a machine with that many
cards. The serve steps take one card.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import interop
from ..core.collectives import WirelessRound, mesh_psum_leaves, wireless_psum
from ..core.dist import (Mesh, all_reduce_sum, client_axes, client_group,
                         client_index, n_clients)
from ..models import api
from ..models.transformer import Transformer
from ..optim.sgd import SGDConfig, sgd_update


# ------------------------------------------------------------- train step

def fl_round_arrays(clients, *, gammas=None, chis=None, nus=None,
                    alpha: float = 1.0, noise_scale: float = 0.0,
                    levels: float = 255.0) -> dict:
    """The per-round FL inputs as f32 tensors, one entry per client for
    ``weight`` = chi * gamma / nu (f64 on the host, then f32) and
    ``levels``: (N,) for ``clients`` = N on one card, shaped like the
    client axes for a ``Mesh`` (as the reference's). Defaults give an
    ideal round (all participate, weight 1)."""
    shape = ((clients,) if isinstance(clients, int) else
             tuple(clients.shape[a] for a in client_axes(clients)))
    ones = np.ones(int(np.prod(shape)))
    gammas = ones if gammas is None else np.asarray(gammas)
    chis = ones if chis is None else np.asarray(chis)
    nus = ones if nus is None else np.asarray(nus)
    f32 = torch.float32
    return {
        "weight": torch.as_tensor(chis * gammas / nus,
                                  dtype=f32).reshape(shape),
        "alpha": torch.tensor(alpha, dtype=f32),
        "noise_scale": torch.tensor(noise_scale, dtype=f32),
        "levels": torch.full(shape, levels, dtype=f32),
    }


def make_train_step(model: Transformer, *, n_clients: int = 1,
                    mesh: Optional[Mesh] = None, aggregator: str = "ota",
                    sgd: SGDConfig = SGDConfig(eta=1e-2), batch: int = 8,
                    seq: int = 128, use_kernel: bool = True):
    """``step(batch_in, fl, key) -> mean unweighted loss`` (a 0-dim f32
    tensor); the model's parameters are updated in place. ``batch_in``
    has ``api.batch_spec(cfg, batch, seq)``'s leaves and shapes: the
    global batch, also on a mesh (:func:`_mesh_train_step`).

    Each client's loss is multiplied by its wireless weight before the
    backward pass (``fl["weight"][m]``: grad(w loss) = w grad), the
    gradients are viewed as the reference's stacked leaves and aggregated
    by :func:`wireless_psum` with weight 1, then one SGD step (in f32, cast
    back to the parameters' dtype) from zero momentum, as the reference's
    step takes it: ``sgd.momentum`` changes nothing (ROADMAP Queue 3).
    ``key`` is a threefry key pair (``rngstream.prng_key(t)`` for the
    reference's ``jax.random.key(t)``).
    """
    if mesh is not None:
        return _mesh_train_step(model, mesh, aggregator=aggregator, sgd=sgd,
                                batch=batch, seq=seq, use_kernel=use_kernel)
    if batch % n_clients:
        raise ValueError(f"batch {batch} does not split over {n_clients} "
                         f"clients")
    rows = batch // n_clients
    leaves = interop.reference_leaves(model)
    params = [p for leaf in leaves for p in leaf.params]

    def step(batch_in: dict, fl: dict, key):
        api.check_batch(model.cfg, batch_in, batch, seq)
        weight = fl["weight"].to(model.device)
        losses = []

        def clients():
            for m in range(n_clients):
                model.zero_grad(set_to_none=True)
                loss, _ = api.loss_fn(
                    model, {k: v[m * rows:(m + 1) * rows]
                            for k, v in batch_in.items()})
                (loss * weight[m]).backward()
                losses.append(loss.detach())
                yield [leaf.value(_grads_of) for leaf in leaves]
            model.zero_grad(set_to_none=True)

        rinfo = WirelessRound(weight=torch.ones(n_clients),
                              alpha=fl["alpha"],
                              noise_scale=fl["noise_scale"],
                              levels=fl["levels"])
        ghat = wireless_psum(clients(), rinfo, key, mode=aggregator,
                             use_kernel=use_kernel)
        sgd_update(sgd, params,
                   [part for leaf, g in zip(leaves, ghat)
                    for part in leaf.parts(g)])
        total = losses[0]
        for loss in losses[1:]:
            total = total + loss
        return total / n_clients

    return step


def _grads_of(p):
    return p.grad if p.grad is not None else torch.zeros_like(p)


def _mesh_train_step(model: Transformer, mesh: Mesh, *, aggregator: str,
                     sgd: SGDConfig, batch: int, seq: int, use_kernel: bool):
    """The train step with one client a rank (``repro/launch/steps.py``'s
    ``shard_map`` body): this rank's client c keeps batch rows
    [c B/N, (c+1) B/N) of the global batch, multiplies its loss by its
    weight ``fl["weight"]`` (entry c) and runs one backward; then leaf by
    leaf the mesh ``wireless_psum`` with weight 1 and the leaf's SGD
    step, its gradients freed before the next leaf; the result is the
    loss summed over the clients / N. Every rank ends with the same
    parameters, bit for bit."""
    nc, c = n_clients(mesh), client_index(mesh)
    group = client_group(mesh)
    if batch % nc:
        raise ValueError(f"batch {batch} does not split over {nc} clients")
    rows = batch // nc
    leaves = interop.reference_leaves(model)

    def step(batch_in: dict, fl: dict, key):
        api.check_batch(model.cfg, batch_in, batch, seq)
        weight = fl["weight"].reshape(-1)[c].to(model.device)
        model.zero_grad(set_to_none=True)
        loss, _ = api.loss_fn(model, {k: v[c * rows:(c + 1) * rows]
                                      for k, v in batch_in.items()})
        (loss * weight).backward()
        rinfo = WirelessRound(weight=torch.ones(()), alpha=fl["alpha"],
                              noise_scale=fl["noise_scale"],
                              levels=fl["levels"].reshape(-1)[c])
        ghat = mesh_psum_leaves((leaf.value(_grads_of) for leaf in leaves),
                                len(leaves), rinfo, key, mesh,
                                mode=aggregator, use_kernel=use_kernel)
        for leaf, g in zip(leaves, ghat):
            sgd_update(sgd, leaf.params, leaf.parts(g))
            del g
            for p in leaf.params:
                p.grad = None
        total = all_reduce_sum(loss.detach().clone(), group,
                                           size=nc)
        return total / nc

    return step


# ------------------------------------------------------------ serve steps


def make_prefill_step(model: Transformer, *, batch: int, seq: int,
                      cache_len: Optional[int] = None,
                      flags: Optional[dict] = None):
    """``fn(batch_in) -> (logits (B, V), caches, memory)`` for prompts of
    ``api.batch_spec(cfg, batch, seq)``'s leaves and shapes."""
    cache_len = cache_len or api.effective_seq(model.cfg, seq)
    flags = dict(flags or {})

    def prefill(batch_in):
        api.check_batch(model.cfg, batch_in, batch, seq)
        return api.prefill(model, batch_in, cache_len, flags)

    return prefill


def make_decode_step(model: Transformer, *, batch: int, cache_len: int,
                     flags: Optional[dict] = None):
    """``fn(token (B, 1), position (B,), caches, memory) -> (logits,
    caches)``."""
    flags = dict(flags or {})

    def decode(token, position, caches, memory=None):
        if tuple(token.shape) != (batch, 1):
            raise ValueError(f"decode step built for ({batch}, 1) tokens, "
                             f"got {tuple(token.shape)}")
        return api.decode_step(model, token, position, caches,
                               memory=memory, flags=flags)

    return decode
