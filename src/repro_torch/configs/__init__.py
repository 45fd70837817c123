"""Architecture registry: ``get_config(arch_id)`` (counterpart of
``repro.configs``).

The ten configs are the reference's, as pure data; each cites its source
(HF model card or arXiv). The port builds a model from every one of them:
Mamba (falcon-mamba-7b), dense (the llama family, qwen3-8b, gemma3-4b),
RG-LRU (recurrentgemma-2b), MoE (qwen3-moe-30b-a3b, kimi-k2-1t-a32b), audio
(whisper-tiny) and VLM (internvl2-2b). Only the expert-parallel MoE route
and multi-card training wait for more than one card.
"""
from __future__ import annotations

from ..models.common import ModelConfig

from .qwen3_8b import CONFIG as qwen3_8b
from .llama3_2_1b import CONFIG as llama3_2_1b
from .recurrentgemma_2b import CONFIG as recurrentgemma_2b
from .gemma3_4b import CONFIG as gemma3_4b
from .kimi_k2_1t_a32b import CONFIG as kimi_k2
from .falcon_mamba_7b import CONFIG as falcon_mamba_7b
from .tinyllama_1_1b import CONFIG as tinyllama_1_1b
from .qwen3_moe_30b_a3b import CONFIG as qwen3_moe
from .whisper_tiny import CONFIG as whisper_tiny
from .internvl2_2b import CONFIG as internvl2_2b

REGISTRY: dict[str, ModelConfig] = {
    "qwen3-8b": qwen3_8b,
    "llama3.2-1b": llama3_2_1b,
    "recurrentgemma-2b": recurrentgemma_2b,
    "gemma3-4b": gemma3_4b,
    "kimi-k2-1t-a32b": kimi_k2,
    "falcon-mamba-7b": falcon_mamba_7b,
    "tinyllama-1.1b": tinyllama_1_1b,
    "qwen3-moe-30b-a3b": qwen3_moe,
    "whisper-tiny": whisper_tiny,
    "internvl2-2b": internvl2_2b,
}

ARCH_IDS = tuple(REGISTRY)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch '{arch_id}'; known: {sorted(REGISTRY)}")
    return REGISTRY[arch_id]
