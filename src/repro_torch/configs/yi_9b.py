"""yi-9b [dense] — llama-arch GQA: 48L d_model=4096 32H (kv=4) d_ff=11008
vocab=64000. [arXiv:2403.04652]"""
from repro_torch.models.lm.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    arch_type="dense",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64000,
    mlp="swiglu",
    rope_theta=10000.0,
    source="arXiv:2403.04652",
)
