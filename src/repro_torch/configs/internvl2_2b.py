"""internvl2-2b [vlm] — InternLM2-1.8B language backbone: 24L d_model=2048
16H (GQA kv=8) d_ff=8192 vocab=92553. InternViT vision encoder + projector
STUBBED: the runtime feeds 256 precomputed patch embeddings (B, 256, 2048)
prepended to the text tokens. [arXiv:2404.16821]"""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", arch_type="vlm", n_layers=24, d_model=2048,
    n_heads=16, n_kv_heads=8, d_ff=8192, vocab_size=92553,
    head_dim=128, vision_prefix=256,
    source="arXiv:2404.16821",
)
