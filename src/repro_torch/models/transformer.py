"""Model assembly (counterpart of ``repro.models.transformer``).

The reference stacks one group per pass of ``cfg.layer_pattern`` and runs
them under ``jax.lax.scan``; here each layer is one entry of an
``nn.ModuleList`` and the forward pass is a Python loop over them. Layer i
of the port is the reference's group ``i // len(pattern)``, block
``i % len(pattern)`` (then the tail). Parameter names follow the
reference's tree: ``embed``, ``final_norm``, ``lm_head`` and
``layers.<i>.ln1``, ``layers.<i>.mamba.<leaf>``. Caches are a list with
one dict per layer.

Only Mamba-1 layers are ported (``layer_pattern == ("mamba",)``,
falcon-mamba); other kinds, encoder-decoders and VLMs raise
``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from . import layers as L
from .common import ModelConfig, ParamInit, ParamModule, rms_norm


class Layer(ParamModule):
    """One layer: ``ln1`` and the block of its kind (``_init_layer``)."""

    def __init__(self, cfg: ModelConfig, kind: str, init: ParamInit):
        super().__init__()
        self.param(init, "ln1", (cfg.d_model,), init="ones")
        if kind in ("global", "local", "encoder"):
            L.init_attention(init, self, cfg)
        elif kind == "rglru":
            L.init_rglru(init, self, cfg)
        elif kind != "mamba":
            raise ValueError(kind)
        # a Mamba layer has no MLP (the reference adds one only to the
        # other kinds)
        self.mamba = ParamModule()
        L.init_mamba(init, self.mamba, cfg)

    def forward(self, cfg: ModelConfig, x, *, cache=None, mode="train",
                flags=None):
        """``_layer_apply`` for a Mamba layer: (x, new_cache)."""
        h = rms_norm(x, self.ln1, cfg.norm_eps)
        y, nc = L.mamba_apply(cfg, self.mamba, h,
                              cache=None if cache is None else cache["mamba"],
                              mode=mode, flags=flags)
        return x + y, ({"mamba": nc} if mode != "train" else None)


class Transformer(nn.Module):
    """A decoder-only LM of Mamba-1 layers for one ModelConfig.

    ``generator`` draws the parameters on ``device`` (embed, final_norm,
    lm_head, then layer by layer); ``generator=None`` leaves them
    uninitialised, for weights loaded after (``interop.model_state``).
    """

    def __init__(self, cfg: ModelConfig, *, device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.encoder_layers > 0 or cfg.vision_prefix > 0:
            raise NotImplementedError(
                f"{cfg.name}: the encoder-decoder and VLM front ends "
                f"{L.NOT_PORTED}")
        self.cfg = cfg
        init = ParamInit(cfg.dtype, device, generator)
        self.embed = nn.Parameter(
            init((cfg.vocab_size, cfg.d_model), scale=0.02),
            requires_grad=False)
        self.final_norm = nn.Parameter(init((cfg.d_model,), init="ones"),
                                       requires_grad=False)
        self.lm_head = nn.Parameter(
            init((cfg.d_model, cfg.vocab_size), scale=0.02),
            requires_grad=False)
        self.layers = nn.ModuleList(
            Layer(cfg, cfg.kind(i), init) for i in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def init_cache(self, batch: int, cache_len: int, dtype=None) -> list:
        """One ``{"mamba": {"conv", "h"}}`` per layer (a Mamba cache does
        not grow with ``cache_len``)."""
        dtype = dtype or self.cfg.dtype
        return [{"mamba": L.init_mamba_cache(self.cfg, batch, dtype,
                                             self.device)}
                for _ in self.layers]

    def forward(self, x, *, mode="train", caches=None, flags=None):
        """Backbone over embeddings x (B, S, d). Returns (hidden, caches)
        (Mamba layers need no positions)."""
        new_caches = None if caches is None else []
        for i, layer in enumerate(self.layers):
            x, nc = layer(self.cfg, x,
                          cache=None if caches is None else caches[i],
                          mode=mode, flags=flags)
            if new_caches is not None:
                new_caches.append(nc if nc is not None else caches[i])
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return x, new_caches

    def logits(self, hidden):
        return hidden @ self.lm_head
