"""qwen1.5-4b [dense] — 40L d_model=2560 20H (GQA kv=20 = MHA) d_ff=6912
vocab=151936, QKV bias. [hf:Qwen/Qwen1.5-0.5B (family card)]"""
from repro_torch.models.lm.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    arch_type="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
    mlp="swiglu",
    rope_theta=1e6,
    source="hf:Qwen/Qwen1.5-0.5B",
)
