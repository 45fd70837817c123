"""The model zoo (counterpart of ``repro.models``): Mamba-1 LMs so far."""
from .common import ModelConfig
from .transformer import Transformer
from .api import (make_model, make_batch, prefill, decode_step,
                  effective_seq, param_count)

__all__ = ["ModelConfig", "Transformer", "make_model", "make_batch",
           "prefill", "decode_step", "effective_seq", "param_count"]
