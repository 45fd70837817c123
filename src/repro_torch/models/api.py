"""Model-level API: inputs, the training loss, prefill and decode
(counterpart of ``repro.models.api``).

A batch is a dict (``batch_spec``):

  * decoder LM: ``{"tokens": (B, S) int64}``;
  * vlm: ``{"tokens": (B, S_text), "patches": (B, P, d)}``, the P =
    ``vision_prefix`` patch embeddings going in front of the text;
  * audio: ``{"tokens": (B, S_dec), "frames": (B, S_enc, d)}``, the frame
    embeddings the encoder reads.

The front ends' conv / mel and vision encoders are stubs in the
reference too: the embeddings come in as inputs.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..device import resolve_device
from .common import ModelConfig
from .transformer import Transformer

MOE_AUX_COEF = 0.01


def make_model(cfg: ModelConfig, *, seed: Optional[int] = 0,
               device=None, placement=None) -> Transformer:
    """The model with parameters drawn on ``device`` from a generator
    seeded with ``seed``; ``seed=None`` leaves them uninitialised, for
    weights loaded after. With a ``placement``
    (``launch.sharding.Placement(mesh)``) it is one rank's model: each
    parameter this rank's block of the one-card model's."""
    dev = resolve_device(device)
    gen = (None if seed is None
           else torch.Generator(device=dev).manual_seed(seed))
    with torch.no_grad():
        return Transformer(cfg, device=dev, generator=gen,
                           placement=placement)


def effective_seq(cfg: ModelConfig, seq: int) -> int:
    if cfg.max_target_positions:
        return min(seq, cfg.max_target_positions)
    return seq


def batch_spec(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """Every model input's (shape, dtype) (``repro.models.api.batch_spec``):
    a VLM's text is ``max(s - vision_prefix, 1)`` tokens after its
    patches, an audio model's frames are ``encoder_positions`` long; s is
    ``effective_seq(cfg, seq)``."""
    s = effective_seq(cfg, seq)
    emb = (cfg.dtype,)
    if cfg.arch_type == "vlm":
        return {"tokens": ((batch, max(s - cfg.vision_prefix, 1)),
                           torch.int64),
                "patches": ((batch, cfg.vision_prefix, cfg.d_model),) + emb}
    spec = {"tokens": ((batch, s), torch.int64)}
    if cfg.arch_type == "audio":
        spec["frames"] = ((batch, cfg.encoder_positions, cfg.d_model),) + emb
    return spec


def check_batch(cfg: ModelConfig, batch_in: dict, batch: int,
                seq: int) -> None:
    """Raise ValueError unless ``batch_in`` has exactly the leaves and
    shapes of ``batch_spec(cfg, batch, seq)``."""
    want = {k: shape for k, (shape, _) in batch_spec(cfg, batch,
                                                     seq).items()}
    got = {k: tuple(v.shape) for k, v in batch_in.items()}
    if got != want:
        raise ValueError(f"{cfg.name}: step built for inputs {want}, "
                         f"got {got}")


def make_batch(cfg: ModelConfig, batch: int, seq: int,
               generator: torch.Generator) -> dict:
    """A random batch of ``batch_spec``'s shapes, drawn on the generator's
    device: the tokens first, then the patch or frame embeddings
    (standard normals drawn in f32, cast to ``cfg.dtype``)."""
    out = {}
    for name, (shape, dtype) in batch_spec(cfg, batch, seq).items():
        if name == "tokens":
            out[name] = torch.randint(0, cfg.vocab_size, shape,
                                      generator=generator,
                                      device=generator.device)
        else:
            out[name] = torch.randn(shape, generator=generator,
                                    device=generator.device).to(dtype)
    return out


def _embed_inputs(model: Transformer, batch: dict):
    """Returns (x (B, S, d), positions (B, S), loss_mask (B, S), memory):
    a VLM's patches, cast to the embedding dtype, go in front of its
    tokens and are masked out of the loss; an audio model's frames go
    through the encoder into the memory (None otherwise)."""
    cfg = model.cfg
    tokens = batch["tokens"]
    x = model.embed[tokens]
    memory = None
    B, S = tokens.shape
    mask = torch.ones((B, S), dtype=torch.bool, device=tokens.device)
    if cfg.arch_type == "vlm":
        x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
        mask = torch.cat([torch.zeros((B, cfg.vision_prefix),
                                      dtype=torch.bool,
                                      device=tokens.device), mask], dim=1)
        S = x.shape[1]
    elif cfg.arch_type == "audio":
        memory = model.encode(batch["frames"])
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device)[None].expand(B, S)
    return x, positions, mask, memory


def loss_fn(model: Transformer, batch: dict, flags: Optional[dict] = None):
    """Mean next-token cross-entropy (f32 log-softmax, the masked mean of
    the negative log-likelihood) plus ``MOE_AUX_COEF`` times the MoE
    layers' summed load-balance term (``repro.models.api.loss_fn``), over
    the text positions: a VLM's logits lose the patch prefix first, so a
    VLM batch of one text token has no target and a loss of exactly 0,
    as the reference's. The backbone runs with ``remat`` on, as the
    reference's does. Returns (loss, {"ce": ce, "aux": aux})."""
    x, positions, mask, memory = _embed_inputs(model, batch)
    hidden, _, aux = model(x, positions, mode="train", flags=flags,
                           memory=memory)
    logits = model.logits(hidden)                           # (B, S, V)
    tgt_tok = batch["tokens"]
    n_prefix = logits.shape[1] - tgt_tok.shape[1]           # patch prefix
    lp = torch.log_softmax(logits[:, n_prefix:-1].float(), dim=-1)
    tgt = tgt_tok[:, 1:]
    nll = -torch.gather(lp, -1, tgt[..., None].long())[..., 0]
    m = mask[:, n_prefix + 1:].float()
    ce = torch.sum(nll * m) / torch.clamp_min(torch.sum(m), 1.0)
    return ce + MOE_AUX_COEF * aux, {"ce": ce, "aux": aux}


@torch.no_grad()
def prefill(model: Transformer, batch: dict, cache_len: int,
            flags: Optional[dict] = None):
    """Process the prompt, build the KV / state cache, return the last
    logits. Every attention layer's cache comes out ``cache_len`` long,
    as the reference's does (``flags["cache_len"]``).

    Returns (logits_last (B, V), caches, memory); ``memory`` (the
    encoder's output, for ``decode_step``) is None for decoder-only
    models.
    """
    x, positions, _, memory = _embed_inputs(model, batch)
    caches = model.init_cache(x.shape[0], cache_len)
    fl = dict(flags or {})
    fl["cache_len"] = cache_len
    hidden, caches, _ = model(x, positions, mode="prefill", caches=caches,
                              flags=fl, memory=memory)
    logits = model.logits(hidden[:, -1:, :])[:, 0]
    return logits, caches, memory


@torch.no_grad()
def decode_step(model: Transformer, token: torch.Tensor,
                position: torch.Tensor, caches, memory=None,
                flags: Optional[dict] = None):
    """One-token decode. token: (B, 1); position: (B,) absolute index (a
    VLM's count the patch prefix); ``memory``: the prefill's, which an
    encoder-decoder's cross-attention reads at every step.
    Returns (logits (B, V), new_caches)."""
    x = model.embed[token]
    hidden, caches, _ = model(x, position[:, None], mode="decode",
                              caches=caches, flags=flags, memory=memory)
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
