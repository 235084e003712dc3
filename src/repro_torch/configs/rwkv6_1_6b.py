"""rwkv6-1.6b [ssm] — Finch: 24L d_model=2048 attention-free,
data-dependent decay, channel-mix d_ff=7168, vocab=65536, head_dim 64.
[arXiv:2404.05892] — runs long_500k natively (O(1) state)."""
from repro_torch.models.lm.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    arch_type="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,            # d_model / head_dim (time-mix heads)
    n_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab_size=65536,
    rope_theta=0.0,        # no RoPE: token-shift provides recency
    source="arXiv:2404.05892",
)
