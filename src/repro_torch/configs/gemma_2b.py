"""gemma-2b [dense] — 18L d_model=2048 8H MQA (kv=1) head_dim=256,
d_ff=16384 GeGLU, vocab=256000, tied embeddings. [arXiv:2403.08295]

Note: the reference implementation scales token embeddings by
sqrt(d_model); we fold the equivalent effect into init scale (recorded as
a deviation — it does not change shapes or FLOPs).
"""
from repro_torch.models.lm.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    arch_type="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    mlp="geglu",
    tie_embeddings=True,
    rope_theta=10000.0,
    source="arXiv:2403.08295",
)
