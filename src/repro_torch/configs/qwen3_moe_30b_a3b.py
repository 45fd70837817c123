"""qwen3-moe-30b-a3b [moe] — 48L d_model=2048 32H (GQA kv=4) expert
d_ff=768 vocab=151936, MoE 128 experts top-8, qk_norm.
[hf:Qwen/Qwen3-30B-A3B]"""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", arch_type="moe", n_layers=48, d_model=2048,
    n_heads=32, n_kv_heads=4, d_ff=768, vocab_size=151936,
    head_dim=128, qk_norm=True, n_experts=128, n_experts_per_tok=8,
    moe_capacity_factor=1.25, rope_theta=1e6,
    source="hf:Qwen/Qwen3-30B-A3B",
)
