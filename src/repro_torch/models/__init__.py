"""The model zoo (counterpart of ``repro.models``): Mamba-1 LMs, dense
llama-style LMs (global and local attention), MoE LMs, the RG-LRU
hybrid, the encoder-decoder (whisper) and the VLM (internvl2), in train,
prefill and decode modes."""
from .common import ModelConfig
from .transformer import Transformer
from .api import (make_model, batch_spec, make_batch, loss_fn, prefill,
                  decode_step, effective_seq, param_count,
                  active_param_count)

__all__ = ["ModelConfig", "Transformer", "make_model", "batch_spec",
           "make_batch", "loss_fn", "prefill", "decode_step",
           "effective_seq", "param_count", "active_param_count"]
