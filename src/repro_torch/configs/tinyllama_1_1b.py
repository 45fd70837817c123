"""tinyllama-1.1b [dense] — 22L d_model=2048 32H (GQA kv=4) d_ff=5632
vocab=32000 (llama2-style small). [arXiv:2401.02385]"""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b", arch_type="dense", n_layers=22, d_model=2048,
    n_heads=32, n_kv_heads=4, d_ff=5632, vocab_size=32000,
    head_dim=64,
    source="arXiv:2401.02385",
)
