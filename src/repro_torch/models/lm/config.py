"""Architecture configuration for the assigned model families.

A copy of `repro.models.lm.config` (pure dataclasses, `reduced()`
included), so `repro_torch.configs` resolves every `--arch` without the
JAX package. One `ModelConfig` describes any of the 10 assigned
architectures: dense GQA/MQA decoders, MoE (top-k routed + shared
experts, optionally MLA attention), attention-free RWKV6, hybrid
attention+SSM (Hymba), enc-dec audio (Whisper backbone), and VLM (decoder
backbone + stubbed vision embeddings). The port runs the "attn" and
"hybrid" kinds (`repro_torch.models.lm.transformer`).

A model is a sequence of *segments*: contiguous runs of identical layers
whose parameters are stacked along a leading layer axis (the port loops
over that axis in Python; the reference scans it). Segment kinds:
  "attn"   — attention + dense MLP
  "moe"    — attention + routed-expert MLP (+ shared experts)
  "rwkv"   — RWKV6 time-mix + channel-mix (attention-free)
  "hybrid" — parallel attention + SSD/Mamba heads, dense MLP
"""
from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0           # shared (always-on) experts, DeepSeek-style
    capacity_factor: float = 2.0
    router_aux_coef: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 multi-head latent attention."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """SSD (Mamba-2 style) heads for hybrid blocks."""
    state_dim: int = 16
    expand: int = 2
    head_dim: int = 64
    dt_rank: int = 64


@dataclasses.dataclass(frozen=True)
class Segment:
    kind: Literal["attn", "moe", "rwkv", "hybrid"]
    n_layers: int
    # Per-segment attention window override (None = config default).
    sliding_window: int | None = None
    full_attention: bool = False   # force full attention in this segment


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec models (Whisper). Frontend is a stub:
    inputs arrive as precomputed frame embeddings (B, n_frames, d_model)."""
    n_layers: int
    n_frames: int = 1500          # Whisper: 30 s audio -> 1500 frames


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None           # default d_model // n_heads
    segments: tuple[Segment, ...] = ()    # default: one "attn" run
    # Attention details.
    qkv_bias: bool = False
    # rope_theta = 0 disables RoPE (Whisper-style absolute embeddings).
    rope_theta: float = 10000.0
    pos_emb: Literal["rope", "sinusoidal"] = "rope"
    sliding_window: int | None = None     # None = full causal
    attn_logit_softcap: float | None = None
    # MLP.
    mlp: Literal["swiglu", "geglu", "gelu"] = "swiglu"
    # Optional sub-configs.
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    encoder: EncoderConfig | None = None
    # VLM / audio stub frontend: number of prefix embedding positions the
    # stubbed modality encoder produces (0 = pure text).
    n_prefix_tokens: int = 0
    # Misc.
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # Multi-token prediction (DeepSeek-V3 MTP) — extra next-next-token head.
    mtp: bool = False
    # Activation-checkpoint each scanned layer during training.
    remat: bool = False
    # Unroll layer scans (analysis/calibration only — exact HLO costs).
    scan_unroll: bool = False
    # Citation for the exact configuration (model card / paper).
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def resolved_segments(self) -> tuple[Segment, ...]:
        if self.segments:
            return self.segments
        kind = {"dense": "attn", "vlm": "attn", "audio": "attn",
                "moe": "moe", "ssm": "rwkv", "hybrid": "hybrid"}[self.arch_type]
        return (Segment(kind=kind, n_layers=self.n_layers),)

    @property
    def attention_free(self) -> bool:
        return all(s.kind == "rwkv" for s in self.resolved_segments)

    @property
    def supports_long_context(self) -> bool:
        """long_500k eligibility: the arch must have *some* sub-quadratic /
        bounded-cache token mixing — SSM or RWKV state, or sliding-window
        attention on its (non-anchor) attention segments. A handful of
        full-attention anchor layers (Hymba-style) keep decode O(S) and the
        cache linear, so they do not disqualify; an arch whose *only*
        mechanism is full attention does."""
        has_state = any(s.kind in ("rwkv", "hybrid")
                        for s in self.resolved_segments)
        windowed = all(
            s.full_attention or s.sliding_window or self.sliding_window
            for s in self.resolved_segments if s.kind in ("attn", "moe"))
        any_attn = any(s.kind in ("attn", "moe")
                       for s in self.resolved_segments)
        return has_state or (any_attn and windowed)

    def reduced(self, n_layers: int = 2, d_model: int = 256,
                n_experts: int = 4) -> "ModelConfig":
        """Smoke-test variant: same family, tiny dimensions."""
        hd = 64
        heads = max(2, d_model // hd)
        kv = max(1, min(self.n_kv_heads, heads))
        segs = []
        total = 0
        for s in self.resolved_segments:
            if total >= n_layers:
                break
            take = min(s.n_layers, n_layers - total)
            segs.append(dataclasses.replace(
                s, n_layers=take,
                sliding_window=min(s.sliding_window, 128)
                if s.sliding_window else None))
            total += take
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe, n_experts=min(n_experts, self.moe.n_experts),
                top_k=min(self.moe.top_k, 2),
                d_ff_expert=d_model, n_shared=min(self.moe.n_shared, 1),
                capacity_factor=8.0)   # effectively dropless at smoke scale
        mla = None
        if self.mla is not None:
            mla = MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                            rope_head_dim=32, nope_head_dim=hd, v_head_dim=hd)
        ssm = None
        if self.ssm is not None:
            ssm = dataclasses.replace(self.ssm, head_dim=hd, dt_rank=16)
        enc = None
        if self.encoder is not None:
            enc = EncoderConfig(n_layers=min(2, self.encoder.n_layers),
                                n_frames=64)
        return dataclasses.replace(
            self, name=self.name + "-smoke", n_layers=total or n_layers,
            d_model=d_model, n_heads=heads, n_kv_heads=kv, head_dim=hd,
            d_ff=2 * d_model, vocab_size=min(self.vocab_size, 512),
            segments=tuple(segs), moe=moe, mla=mla, ssm=ssm, encoder=enc,
            sliding_window=min(self.sliding_window, 128)
            if self.sliding_window else None,
            n_prefix_tokens=min(self.n_prefix_tokens, 16),
            dtype="float32",
        )
