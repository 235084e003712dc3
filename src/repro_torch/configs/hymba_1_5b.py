"""hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504,
parallel attention + Mamba(SSD) heads per block, ssm_state=16,
vocab=32001. Sliding-window (1024) attention everywhere except 3 full-
attention anchor layers (first / middle / last), per the paper.
[arXiv:2411.13676]

Deviations noted: meta-tokens (128 learned prefix tokens) and cross-layer
KV sharing are omitted; SSM heads are SSD (scalar per-head decay) rather
than Mamba-1 per-channel decay.
"""
from repro_torch.models.lm.config import ModelConfig, Segment, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    arch_type="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    mlp="swiglu",
    sliding_window=1024,
    segments=(
        Segment(kind="hybrid", n_layers=1, full_attention=True),
        Segment(kind="hybrid", n_layers=14),
        Segment(kind="hybrid", n_layers=1, full_attention=True),
        Segment(kind="hybrid", n_layers=15),
        Segment(kind="hybrid", n_layers=1, full_attention=True),
    ),
    ssm=SSMConfig(state_dim=16, expand=2, head_dim=64),
    rope_theta=10000.0,
    source="arXiv:2411.13676",
)
