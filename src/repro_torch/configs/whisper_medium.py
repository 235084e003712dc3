"""whisper-medium [audio] — enc-dec, 24+24L d_model=1024 16H d_ff=4096
vocab=51865, GELU MLPs, sinusoidal positions. [arXiv:2212.04356]

The mel-spectrogram + conv feature extractor frontend is a STUB per the
brief: `input_specs` feeds precomputed frame embeddings (B, 1500, 1024).
Decode shapes exercise the decoder with self- and cross-attention caches.
long_500k is SKIPPED for this arch (pure full-attention enc-dec; a 500k
token decode has no audio analogue) — recorded in DESIGN.md.
Deviation: RMSNorm in place of LayerNorm (shape/FLOP neutral at roofline
granularity).
"""
from repro_torch.models.lm.config import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    arch_type="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    mlp="gelu",
    rope_theta=0.0,
    pos_emb="sinusoidal",
    tie_embeddings=True,
    encoder=EncoderConfig(n_layers=24, n_frames=1500),
    source="arXiv:2212.04356",
)
