"""Model assembly (counterpart of ``repro.models.transformer``).

The reference stacks one group per pass of ``cfg.layer_pattern`` and runs
them under ``jax.lax.scan``; here each layer is one entry of an
``nn.ModuleList`` and the forward pass is a Python loop over them. Layer i
of the port is the reference's group ``i // len(pattern)``, block
``i % len(pattern)`` (then the tail). Parameter names follow the
reference's tree: ``embed``, ``final_norm``, ``lm_head`` and
``layers.<i>.ln1``, ``layers.<i>.mamba.<leaf>``, ``layers.<i>.attn.<leaf>``
or ``layers.<i>.rec.<leaf>``, ``layers.<i>.ln2``, then ``layers.<i>.mlp.<leaf>``
or, in MoE models, ``layers.<i>.moe.<leaf>``. An encoder-decoder
(whisper) adds ``layers.<i>.ln_cross`` and ``layers.<i>.cross.<leaf>`` to
each decoder layer, and the encoder stack ``enc_layers.<i>.<leaf>`` (the
reference's ``enc_groups/b0/...``, stacked over ``encoder_layers``) with
``enc_norm``.
Caches are a list with one dict per layer, keyed as the reference's:
``{"attn": ...}``, ``{"mamba": ...}`` or ``{"rec": ...}``.
``repro_torch.interop`` maps these names to the reference's stacked leaves
and back. In train mode ``forward`` checkpoints each group of layers (one
pass of the pattern, the reference's scan step) unless ``remat=False``.

Mamba-1 layers (falcon-mamba), dense layers (global and local attention
with the SwiGLU MLP: the llama family, gemma3's pattern), MoE layers
(attention with the top-k expert block: qwen3-moe, kimi-k2), RG-LRU
layers (recurrentgemma's pattern), the encoder-decoder (whisper: an
encoder of bidirectional attention layers, cross-attention in every
decoder layer) and the VLM (internvl2: a decoder-only LM fed a patch
prefix by ``api``) serve and train.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils import checkpoint

from . import layers as L
from .common import ModelConfig, ParamInit, ParamModule, rms_norm


class Layer(ParamModule):
    """One layer (``_init_layer``): ``ln1`` and the block of its kind, in a
    decoder of an encoder-decoder (``cross``) ``ln_cross`` and the
    cross-attention, then for attention and RG-LRU layers ``ln2`` and
    either the MoE block (``moe``) or the MLP, never both (a Mamba layer
    has neither)."""

    def __init__(self, cfg: ModelConfig, kind: str, init: ParamInit, *,
                 cross: bool = False, moe: bool = False):
        super().__init__()
        self.kind = kind
        self.param(init, "ln1", (cfg.d_model,), ("embed",), init="ones")
        if kind in ("global", "local", "encoder"):
            self.attn = ParamModule()
            L.init_attention(init, self.attn, cfg)
        elif kind == "mamba":
            self.mamba = ParamModule()
            L.init_mamba(init, self.mamba, cfg)
        elif kind == "rglru":
            self.rec = ParamModule()
            L.init_rglru(init, self.rec, cfg)
        else:
            raise ValueError(kind)
        if cross and kind != "encoder":
            self.param(init, "ln_cross", (cfg.d_model,), ("embed",),
                       init="ones")
            self.cross = ParamModule()
            L.init_attention(init, self.cross, cfg)
        if kind != "mamba" and cfg.d_ff > 0:
            self.param(init, "ln2", (cfg.d_model,), ("embed",), init="ones")
            if moe:
                self.moe = ParamModule()
                L.init_moe(init, self.moe, cfg)
            else:
                self.mlp = ParamModule()
                L.init_mlp(init, self.mlp, cfg)

    def forward(self, cfg: ModelConfig, x, positions, *, cache=None,
                mode="train", flags=None, memory=None):
        """``_layer_apply``: (x, new_cache, aux); aux is the MoE block's
        load-balance term, None for a layer without one (and for an
        expert-parallel block outside training, which drops it). A layer with
        cross-attention reads the encoder ``memory`` in every mode, and
        raises without one (the reference's would attend over x instead,
        ROADMAP Queue 3)."""
        h = rms_norm(x, self.ln1, cfg.norm_eps)
        if self.kind == "mamba":
            y, nc = L.mamba_apply(
                cfg, self.mamba, h,
                cache=None if cache is None else cache["mamba"], mode=mode,
                flags=flags)
            new_cache = {"mamba": nc} if mode != "train" else None
        elif self.kind == "rglru":
            y, nc = L.rglru_apply(
                cfg, self.rec, h,
                cache=None if cache is None else cache["rec"], mode=mode,
                flags=flags)
            new_cache = {"rec": nc} if mode != "train" else None
        else:
            y, nc = L.attention_apply(
                cfg, self.attn, h, positions, kind=self.kind,
                cache=None if cache is None else cache["attn"], mode=mode,
                flags=flags)
            new_cache = None if nc is None else {"attn": nc}
        x = x + y
        if hasattr(self, "cross"):
            if memory is None:
                raise ValueError(
                    "a decoder layer with cross-attention needs the "
                    "encoder memory (prefill returns it; pass it to "
                    "decode_step)")
            h = rms_norm(x, self.ln_cross, cfg.norm_eps)
            y, _ = L.attention_apply(cfg, self.cross, h, positions,
                                     mode="train", flags=flags,
                                     cross_kv=memory)
            x = x + y
        aux = None
        if hasattr(self, "ln2"):
            h = rms_norm(x, self.ln2, cfg.norm_eps)
            if hasattr(self, "moe"):
                y, aux = L.moe_apply(cfg, self.moe, h, flags=flags,
                                     aux=mode == "train")
            else:
                y = L.mlp_apply(cfg, self.mlp, h)
            x = x + y
        return x, new_cache, aux


class Transformer(ParamModule):
    """An LM for one ModelConfig: decoder-only, or with an encoder stack
    when ``cfg.encoder_layers > 0``.

    ``generator`` draws the parameters on ``device`` (embed, final_norm,
    lm_head, then layer by layer, then the encoder's layers and
    enc_norm); ``generator=None`` leaves them uninitialised, for weights
    loaded after (``interop.model_state``). ``placement``
    (``launch.sharding.Placement``) makes one rank's model of a mesh:
    each parameter is this rank's block of the one-card model's, the same
    bits (``ParamInit``).
    """

    def __init__(self, cfg: ModelConfig, *, device,
                 generator: Optional[torch.Generator] = None,
                 placement=None):
        super().__init__()
        self.cfg = cfg
        self.placement = placement
        cross = cfg.encoder_layers > 0
        init = ParamInit(cfg.dtype, device, generator, placement)
        self.param(init, "embed", (cfg.vocab_size, cfg.d_model),
                   ("vocab", "embed"), scale=0.02)
        self.param(init, "final_norm", (cfg.d_model,), ("embed",),
                   init="ones")
        self.param(init, "lm_head", (cfg.d_model, cfg.vocab_size),
                   ("embed", "vocab"), scale=0.02)
        self.layers = nn.ModuleList(
            Layer(cfg, cfg.kind(i), init, cross=cross,
                  moe=cfg.n_experts > 0) for i in range(cfg.n_layers))
        if cross:
            self.enc_layers = nn.ModuleList(
                Layer(cfg, "encoder", init)
                for _ in range(cfg.encoder_layers))
            self.param(init, "enc_norm", (cfg.d_model,), ("embed",),
                       init="ones")

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _leaf_meta(self) -> list:
        """(axes, whole shape) of each reference leaf, in
        ``interop.reference_leaves`` order; a stacked leaf's with "layers"
        (and the stack's length) in front."""
        from .. import interop
        meta = {id(getattr(m, name)): am
                for m in self.modules() if isinstance(m, ParamModule)
                for name, am in m.__dict__.get("leaf_meta", {}).items()}
        out = []
        for leaf in interop.reference_leaves(self):
            axes, shape = meta[id(leaf.params[0])]
            if leaf.stacked:
                axes, shape = ("layers",) + axes, (len(leaf.params),) + shape
            out.append((axes, shape))
        return out

    def axes(self) -> list:
        """The reference's logical axes of each leaf
        (``repro.models.transformer.Transformer.axes``, flattened in
        ``jax.tree.leaves`` order)."""
        return [axes for axes, _ in self._leaf_meta()]

    def full_shapes(self) -> list:
        """Each reference leaf's whole shape, also where this rank holds
        a block of it."""
        return [shape for _, shape in self._leaf_meta()]

    def init_cache(self, batch: int, cache_len: int, dtype=None) -> list:
        """One cache per layer (``_init_layer_cache``): an attention ring
        buffer of ``cache_len`` slots (a local layer's of
        ``min(cache_len, window_size)``), or a Mamba or RG-LRU state, which
        does not grow with ``cache_len``."""
        cfg, dev = self.cfg, self.device
        dtype = dtype or cfg.dtype
        caches = []
        for layer in self.layers:
            if layer.kind == "mamba":
                c = {"mamba": L.init_mamba_cache(cfg, batch, dtype, dev)}
            elif layer.kind == "rglru":
                c = {"rec": L.init_rglru_cache(cfg, batch, dtype, dev)}
            else:
                n = (min(cache_len, cfg.window_size) if layer.kind == "local"
                     else cache_len)
                c = {"attn": L.init_attention_cache(cfg, batch, n, dtype,
                                                    dev)}
            caches.append(c)
        return caches

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """The encoder stack over frame embeddings (B, S_enc, d), then
        ``enc_norm`` (``Transformer.encode``). The reference calls its
        encoder layers with ``flags=None``, so they attend by the einsum
        route whatever ``attn_impl`` the caller chose; so does the
        port."""
        B, S, _ = frames.shape
        pos = torch.arange(S, dtype=torch.int32,
                           device=frames.device)[None].expand(B, S)
        x = frames
        for layer in self.enc_layers:
            x, _, _ = layer(self.cfg, x, pos, mode="train", flags=None)
        return rms_norm(x, self.enc_norm, self.cfg.norm_eps)

    def forward(self, x, positions=None, *, mode="train", caches=None,
                flags=None, memory=None, remat=True):
        """Backbone over embeddings x (B, S, d) at ``positions`` (B, S)
        (attention layers; Mamba and RG-LRU layers read none), the
        decoder layers' cross-attention over the encoder ``memory``.
        Returns (hidden, caches, aux): aux sums the MoE layers'
        load-balance terms in f32, layer by layer (0 without MoE layers;
        under remat each group's sum is added, the same order for the
        one-layer patterns of the MoE archs).

        ``remat`` (train mode only, as the reference's ``jax.checkpoint``
        of its scan body): each of the ``n_layers // len(layer_pattern)``
        groups, one pass of the pattern, runs as one non-reentrant
        ``torch.utils.checkpoint.checkpoint`` call, which keeps only the
        group's inputs for the backward pass and runs the group again
        there; the tail layers run as they are. The recompute repeats the
        forward's ops, so the loss and gradients keep their bits."""
        cfg = self.cfg
        new_caches = None if caches is None else []
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        n_grouped = 0
        if remat and mode == "train":
            size = len(cfg.layer_pattern)
            n_grouped = cfg.n_layers // size * size
            for g in range(0, n_grouped, size):
                x, aux = checkpoint.checkpoint(
                    self._group, x, positions, memory, g, g + size, flags,
                    use_reentrant=False)
                if aux is not None:
                    aux_total = aux_total + aux
            if new_caches is not None:      # a train layer's cache is kept
                new_caches.extend(caches[:n_grouped])
        for i in range(n_grouped, cfg.n_layers):
            x, nc, aux = self.layers[i](
                cfg, x, positions,
                cache=None if caches is None else caches[i], mode=mode,
                flags=flags, memory=memory)
            if aux is not None:
                aux_total = aux_total + aux
            if new_caches is not None:
                new_caches.append(nc if nc is not None else caches[i])
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        return x, new_caches, aux_total

    def _group(self, x, positions, memory, start, stop, flags):
        """Train-mode layers [start, stop) in order: (x, the sum of their
        MoE aux terms in layer order, None without one)."""
        aux_sum = None
        for layer in self.layers[start:stop]:
            x, _, aux = layer(self.cfg, x, positions, mode="train",
                              flags=flags, memory=memory)
            if aux is not None:
                aux_sum = aux if aux_sum is None else aux_sum + aux
        return x, aux_sum

    def logits(self, hidden):
        return hidden @ self.lm_head
