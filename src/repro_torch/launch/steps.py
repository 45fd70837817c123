"""Step factories on one card (counterparts of ``repro.launch.steps``): the
FL train step with the wireless collective, and the serve prefill and
decode steps.

Plain functions over a model already on its device: the reference's mesh,
shardings and ``jit`` wait for the DeviceMesh item (ROADMAP Queue 1
item 10 step 6). FL clients are the reference's data-axis slices: client m of N
takes batch rows [m B/N, (m+1) B/N) and runs on the same card, one after
another; every leaf of a batch (``tokens``, and an audio model's
``frames`` or a VLM's ``patches``) is cut by those rows.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import interop
from ..core.collectives import WirelessRound, wireless_psum
from ..models import api
from ..models.transformer import Transformer
from ..optim.sgd import SGDConfig, sgd_update


# ------------------------------------------------------------- train step

def fl_round_arrays(n_clients: int, *, gammas=None, chis=None, nus=None,
                    alpha: float = 1.0, noise_scale: float = 0.0,
                    levels: float = 255.0) -> dict:
    """The per-round FL inputs as f32 tensors, one entry per client for
    ``weight`` = chi * gamma / nu (f64 on the host, then f32) and
    ``levels``. Defaults give an ideal round (all participate, weight 1).
    """
    ones = np.ones(n_clients)
    gammas = ones if gammas is None else np.asarray(gammas)
    chis = ones if chis is None else np.asarray(chis)
    nus = ones if nus is None else np.asarray(nus)
    f32 = torch.float32
    return {
        "weight": torch.as_tensor(chis * gammas / nus, dtype=f32),
        "alpha": torch.tensor(alpha, dtype=f32),
        "noise_scale": torch.tensor(noise_scale, dtype=f32),
        "levels": torch.full((n_clients,), levels, dtype=f32),
    }


def make_train_step(model: Transformer, *, n_clients: int = 1,
                    aggregator: str = "ota",
                    sgd: SGDConfig = SGDConfig(eta=1e-2), batch: int = 8,
                    seq: int = 128, use_kernel: bool = True):
    """``step(batch_in, fl, key) -> mean unweighted loss`` (a 0-dim f32
    tensor); the model's parameters are updated in place. ``batch_in``
    has ``api.batch_spec(cfg, batch, seq)``'s leaves and shapes.

    Each client's loss is multiplied by its wireless weight before the
    backward pass (``fl["weight"][m]``: grad(w loss) = w grad), the
    gradients are viewed as the reference's stacked leaves and aggregated
    by :func:`wireless_psum` with weight 1, then one SGD step (in f32, cast
    back to the parameters' dtype) from zero momentum, as the reference's
    step takes it: ``sgd.momentum`` changes nothing (ROADMAP Queue 3).
    ``key`` is a threefry key pair (``rngstream.prng_key(t)`` for the
    reference's ``jax.random.key(t)``).
    """
    if batch % n_clients:
        raise ValueError(f"batch {batch} does not split over {n_clients} "
                         f"clients")
    rows = batch // n_clients
    leaves = interop.reference_leaves(model)
    params = [p for leaf in leaves for p in leaf.params]

    def grads_of(p):
        return p.grad if p.grad is not None else torch.zeros_like(p)

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
                yield [leaf.value(grads_of) for leaf in leaves]
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
