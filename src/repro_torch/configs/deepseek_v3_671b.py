"""deepseek-v3-671b [moe] — 61L d_model=7168, 128 MLA heads,
MoE: 1 shared + 256 routed experts (top-8, expert d_ff=2048), first 3
layers dense (d_ff=18432), vocab=129280, MTP head. [arXiv:2412.19437]

MLA: q_lora 1536, kv_lora 512, rope head 64, nope head 128, v head 128 —
decode runs the *absorbed* form and caches only (c_kv, k_rope).
MTP simplification: a single extra next-next-token head off the trunk
(the paper uses a 1-layer MTP module; ours is the projection-only variant,
noted as a deviation).
"""
from repro_torch.models.lm.config import MLAConfig, ModelConfig, MoEConfig, Segment

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    arch_type="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=18432,                       # dense layers (first 3)
    vocab_size=129280,
    mlp="swiglu",
    segments=(
        Segment(kind="attn", n_layers=3),
        Segment(kind="moe", n_layers=58),
    ),
    moe=MoEConfig(n_experts=256, top_k=8, d_ff_expert=2048, n_shared=1,
                  capacity_factor=1.5),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
    mtp=True,
    rope_theta=10000.0,
    source="arXiv:2412.19437",
)
