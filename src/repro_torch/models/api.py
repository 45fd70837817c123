"""Model-level API: inputs, the training loss, prefill and decode
(counterpart of ``repro.models.api``).

A batch is ``{"tokens": (B, S) int64}`` (decoder-only LMs; the VLM and
audio inputs come with their front ends, ROADMAP Queue 1 item 10 step 4).
Entry points run on the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..device import resolve_device
from .common import ModelConfig
from .layers import NOT_PORTED
from .transformer import Transformer

MOE_AUX_COEF = 0.01


def make_model(cfg: ModelConfig, *, seed: Optional[int] = 0,
               device=None) -> Transformer:
    """The model with parameters drawn on ``device`` from a generator
    seeded with ``seed``; ``seed=None`` leaves them uninitialised, for
    weights loaded after."""
    dev = resolve_device(device)
    gen = (None if seed is None
           else torch.Generator(device=dev).manual_seed(seed))
    with torch.no_grad():
        return Transformer(cfg, device=dev, generator=gen)


def effective_seq(cfg: ModelConfig, seq: int) -> int:
    if cfg.max_target_positions:
        return min(seq, cfg.max_target_positions)
    return seq


def make_batch(cfg: ModelConfig, batch: int, seq: int,
               generator: torch.Generator) -> dict:
    """A random batch of prompt tokens, drawn on the generator's device."""
    if cfg.arch_type in ("vlm", "audio"):
        raise NotImplementedError(f"{cfg.arch_type} inputs {NOT_PORTED}")
    s = effective_seq(cfg, seq)
    return {"tokens": torch.randint(0, cfg.vocab_size, (batch, s),
                                    generator=generator,
                                    device=generator.device)}


def _embed_inputs(model: Transformer, batch: dict):
    """Returns (x (B, S, d), positions (B, S), loss_mask (B, S)) of a
    decoder-only text batch."""
    if model.cfg.arch_type in ("vlm", "audio"):
        raise NotImplementedError(f"{model.cfg.arch_type} inputs {NOT_PORTED}")
    tokens = batch["tokens"]
    x = model.embed[tokens]
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device)[None].expand(B, S)
    mask = torch.ones((B, S), dtype=torch.bool, device=tokens.device)
    return x, positions, mask


def loss_fn(model: Transformer, batch: dict, flags: Optional[dict] = None):
    """Mean next-token cross-entropy (f32 log-softmax, the masked mean of
    the negative log-likelihood) plus ``MOE_AUX_COEF`` times the MoE
    layers' summed load-balance term (``repro.models.api.loss_fn``).
    Returns (loss, {"ce": ce, "aux": aux})."""
    x, positions, mask = _embed_inputs(model, batch)
    hidden, _, aux = model(x, positions, mode="train", flags=flags)
    logits = model.logits(hidden)                           # (B, S, V)
    lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    tgt = batch["tokens"][:, 1:]
    nll = -torch.gather(lp, -1, tgt[..., None].long())[..., 0]
    m = mask[:, 1:].float()
    ce = torch.sum(nll * m) / torch.clamp_min(torch.sum(m), 1.0)
    return ce + MOE_AUX_COEF * aux, {"ce": ce, "aux": aux}


@torch.no_grad()
def prefill(model: Transformer, batch: dict, cache_len: int,
            flags: Optional[dict] = None):
    """Process the prompt, build the KV / state cache, return the last
    logits. Every attention layer's cache comes out ``cache_len`` long,
    as the reference's does (``flags["cache_len"]``).

    Returns (logits_last (B, V), caches, memory); ``memory`` (the
    encoder's output) is None for decoder-only models.
    """
    x, positions, _ = _embed_inputs(model, batch)
    caches = model.init_cache(x.shape[0], cache_len)
    fl = dict(flags or {})
    fl["cache_len"] = cache_len
    hidden, caches, _ = model(x, positions, mode="prefill", caches=caches,
                              flags=fl)
    logits = model.logits(hidden[:, -1:, :])[:, 0]
    return logits, caches, None


@torch.no_grad()
def decode_step(model: Transformer, token: torch.Tensor,
                position: torch.Tensor, caches, memory=None,
                flags: Optional[dict] = None):
    """One-token decode. token: (B, 1); position: (B,) absolute index.
    Returns (logits (B, V), new_caches)."""
    x = model.embed[token]
    hidden, caches, _ = model(x, position[:, None], mode="decode",
                              caches=caches, flags=flags)
    logits = model.logits(hidden[:, 0:1, :])[:, 0]
    return logits, caches


def param_count(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def active_param_count(cfg: ModelConfig, model: torch.nn.Module) -> int:
    """Parameters a token meets (``repro.models.api.active_param_count``):
    of the routed expert weights only top-k of E count. A leaf counts as
    expert weights when its third axis from the end is E in the shape the
    reference gives it: a grouped layer's parameter stacked over the
    ``n_layers // len(layer_pattern)`` groups, a tail layer's as it is. So
    a (H, hd, d) ``wo`` counts too where H == E, as it does there."""
    total = param_count(model)
    if cfg.n_experts == 0:
        return total
    n_groups = cfg.n_layers // len(cfg.layer_pattern)
    n_grouped = n_groups * len(cfg.layer_pattern)
    expert = 0
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        head, _, rest = name.partition(".")
        if head == "layers" and int(rest.partition(".")[0]) < n_grouped:
            shape = (n_groups,) + shape
        if len(shape) >= 3 and shape[-3] == cfg.n_experts:
            expert += p.numel()
    return int(total - expert
               + expert * cfg.n_experts_per_tok / cfg.n_experts)
