"""llava-next-mistral-7b [vlm] — LLaVA-NeXT on a Mistral-7B backbone.

[hf:llava-hf/llava-v1.6-mistral-7b-hf]
Backbone: 32L, d_model=4096, 32 heads (GQA kv=8, head_dim 128),
d_ff=14336 SwiGLU, vocab 32000. Sliding-window attention (4096) per
Mistral-7B-v0.1 — which is also what makes `long_500k` run natively.

AnyRes tiling is STUBBED per the brief: the vision tower + projector are
replaced by precomputed patch embeddings; n_prefix_tokens=2880 is the
anyres worst case (5 x 576 patches, 4 tiles + base image).
"""
from repro_torch.models.lm.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    arch_type="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    mlp="swiglu",
    sliding_window=4096,
    rope_theta=1e6,
    n_prefix_tokens=2880,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
