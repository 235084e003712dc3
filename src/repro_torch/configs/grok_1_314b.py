"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8) MoE 8 experts
top-2 with expert d_ff=32768, vocab=131072, attention logit softcap 30.
[hf:xai-org/grok-1]"""
from repro_torch.models.lm.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    arch_type="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    mlp="gelu",
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32768,
                  capacity_factor=1.5),
    attn_logit_softcap=30.0,
    rope_theta=10000.0,
    source="hf:xai-org/grok-1",
)
