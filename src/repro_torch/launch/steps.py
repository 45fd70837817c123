"""Serve steps on one card (counterparts of ``repro.launch.steps``
``make_prefill_step`` / ``make_decode_step``).

Plain functions over a model already on its device: the reference's mesh,
shardings and ``jit`` wait for the DeviceMesh item (ROADMAP Queue 1
item 10).
"""
from __future__ import annotations

from typing import Optional

from ..models import api
from ..models.transformer import Transformer


def make_prefill_step(model: Transformer, *, batch: int, seq: int,
                      cache_len: Optional[int] = None,
                      flags: Optional[dict] = None):
    """``fn(batch_in) -> (logits (B, V), caches, memory)`` for prompts of
    ``batch`` x ``effective_seq(seq)`` tokens."""
    seq = api.effective_seq(model.cfg, seq)
    cache_len = cache_len or seq
    flags = dict(flags or {})

    def prefill(batch_in):
        tokens = batch_in["tokens"]
        if tuple(tokens.shape) != (batch, seq):
            raise ValueError(f"prefill step built for ({batch}, {seq}) "
                             f"tokens, got {tuple(tokens.shape)}")
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
