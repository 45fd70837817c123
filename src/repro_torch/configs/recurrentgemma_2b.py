"""recurrentgemma-2b [hybrid] — 26L d_model=2560 10H (GQA kv=1) d_ff=7680
vocab=256000, RG-LRU + local attention at 1:2 (two recurrent blocks per
local-attention block, Griffin pattern). [arXiv:2402.19427]"""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", arch_type="hybrid", n_layers=26, d_model=2560,
    n_heads=10, n_kv_heads=1, d_ff=7680, vocab_size=256000,
    head_dim=256, layer_pattern=("rglru", "rglru", "local"),
    window_size=2048, lru_width=2560, conv1d_width=4,
    source="arXiv:2402.19427",
)
