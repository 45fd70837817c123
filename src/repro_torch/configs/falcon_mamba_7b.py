"""falcon-mamba-7b [ssm] — 64L d_model=4096 attention-free, vocab=65024,
ssm_state=16 (mamba-1 architecture, d_inner = 2*d_model, dt_rank = d/16).
[arXiv:2410.05355]"""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", arch_type="ssm", n_layers=64, d_model=4096,
    n_heads=1, n_kv_heads=1, d_ff=0, vocab_size=65024,
    layer_pattern=("mamba",), ssm_state=16, ssm_conv=4, ssm_expand=2,
    source="arXiv:2410.05355",
)
