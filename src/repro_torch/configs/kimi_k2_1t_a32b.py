"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8) expert d_ff=2048
vocab=163840, MoE 384 experts top-8. Trillion-parameter paper-table config.
[arXiv:2501.kimi2]

Simplification: the released Kimi-K2 uses MLA attention and one shared
expert; the model zoo implements GQA (kv=8) and routed experts only.
"""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", arch_type="moe", n_layers=61, d_model=7168,
    n_heads=64, n_kv_heads=8, d_ff=2048, vocab_size=163840,
    head_dim=112, n_experts=384, n_experts_per_tok=8,
    moe_capacity_factor=1.25, rope_theta=5e4,
    source="arXiv:2501.kimi2",
)
