"""The four assigned input shapes and per-arch applicability (counterpart
of ``repro.launch.shapes``; host data, no tensors).

Decode shapes run ``decode_step`` (one new token against a KV/state cache
of ``seq_len``), not a train step. ``long_500k`` needs sub-quadratic
attention: SSM and hybrid archs run natively; dense, MoE and VLM archs run
the sliding-window decode variant (``long_context_variant``); whisper-tiny
is capped at its 448-token decoder context, so long_500k is skipped.
"""
from __future__ import annotations

import dataclasses

from ..models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}

SHAPE_IDS = tuple(SHAPES)

# long-context window for archs that need the sliding-window decode variant
LONG_WINDOW = 8192


def long_context_variant(cfg: ModelConfig) -> ModelConfig:
    """The sliding-window decode variant for long_500k: global layers
    become local, at the config's own window where it has local layers
    and at ``LONG_WINDOW`` otherwise."""
    if cfg.supports_long_decode:
        return cfg
    pat = tuple("local" if k == "global" else k for k in cfg.layer_pattern)
    window = cfg.window_size if "local" in cfg.layer_pattern else LONG_WINDOW
    return dataclasses.replace(cfg, layer_pattern=pat, window_size=window)


def applicable(cfg: ModelConfig, shape: InputShape) -> tuple[bool, str]:
    """(runs?, reason-if-skipped); the reason is the reference's string,
    word for word."""
    if shape.name == "long_500k" and cfg.max_target_positions:
        return False, (f"{cfg.name}: decoder context capped at "
                       f"{cfg.max_target_positions} (enc-dec ASR model); "
                       "long_500k skipped per DESIGN.md §5")
    return True, ""


def config_for(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    if shape.name == "long_500k":
        return long_context_variant(cfg)
    return cfg
