"""whisper-tiny [audio] — 4L encoder + 4L decoder, d_model=384 6H (kv=6)
d_ff=1536 vocab=51865, enc-dec with conv/mel frontend STUBBED: the runtime
feeds precomputed frame embeddings (B, 1500, 384). Decoder context is
capped at 448 target positions (the model's true max), so decode_32k runs
at 448 and long_500k is skipped. [arXiv:2212.04356]"""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", arch_type="audio", n_layers=4, d_model=384,
    n_heads=6, n_kv_heads=6, d_ff=1536, vocab_size=51865,
    head_dim=64, encoder_layers=4, encoder_positions=1500,
    max_target_positions=448,
    source="arXiv:2212.04356",
)
