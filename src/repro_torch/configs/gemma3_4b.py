"""gemma3-4b [dense] — 34L d_model=2560 8H (GQA kv=4) d_ff=10240
vocab=262144, 5:1 local:global sliding-window pattern, 128k context.
[hf:google/gemma-3-1b-pt family]"""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b", arch_type="dense", n_layers=34, d_model=2560,
    n_heads=8, n_kv_heads=4, d_ff=10240, vocab_size=262144,
    head_dim=256, qk_norm=True,
    layer_pattern=("local", "local", "local", "local", "local", "global"),
    window_size=1024, rope_theta=1e6,
    source="hf:google/gemma-3-1b-pt",
)
