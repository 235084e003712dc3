"""Roofline terms from the dry-run record (NVIDIA H100 SXM targets).

Port of `repro.analysis.roofline`, priced by `launch.mesh`'s data-sheet
constants in place of the reference's TPU v5e ones:

  compute term    = FLOPs / (devices x 989 TFLOP/s)
  memory term     = bytes / (devices x 3.35 TB/s)
  collective term = collective_bytes / (devices x 450 GB/s)

plus MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE) and the useful-
compute ratio MODEL_FLOPS / FLOPs (catches remat/redundancy waste).

The dry run's FLOPs, bytes and collective bytes are rank 0's (the per-
device program), so each term divides by one device's rate.
"""
from __future__ import annotations

import dataclasses

from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16


def param_count(cfg) -> int:
    """Analytic parameter count for a ModelConfig (excludes frontend stubs)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    total = cfg.vocab_size * d                     # embed
    if not cfg.tie_embeddings:
        total += d * cfg.vocab_size                # lm_head
    if cfg.mtp:
        total += d * cfg.vocab_size

    def attn_params():
        if cfg.mla is not None:
            m = cfg.mla
            qh = m.nope_head_dim + m.rope_head_dim
            return (d * m.q_lora_rank + m.q_lora_rank * H * qh
                    + d * (m.kv_lora_rank + m.rope_head_dim)
                    + m.kv_lora_rank * H * (m.nope_head_dim + m.v_head_dim)
                    + H * m.v_head_dim * d)
        return d * H * hd + 2 * d * KV * hd + H * hd * d

    def mlp_params(ff):
        mult = 3 if cfg.mlp in ("swiglu", "geglu") else 2
        return mult * d * ff

    for seg in cfg.resolved_segments:
        for _ in range(seg.n_layers):
            if seg.kind == "rwkv":
                total += 5 * d * d + d * 7 * 64 + 64 * d   # ~time-mix
                total += 2 * d * cfg.d_ff + d * d          # channel-mix
                continue
            total += attn_params()
            if seg.kind == "hybrid":
                s = cfg.ssm
                di = s.expand * d
                total += d * 2 * di + di * d + d * (di // s.head_dim) \
                    + 2 * d * s.state_dim
            if seg.kind == "moe":
                m = cfg.moe
                total += d * m.n_experts
                total += m.n_experts * mlp_params(m.d_ff_expert) // 1
                if m.n_shared:
                    total += mlp_params(m.d_ff_expert * m.n_shared)
            else:
                total += mlp_params(cfg.d_ff)
    if cfg.encoder is not None:
        total += cfg.encoder.n_layers * (attn_params() + mlp_params(cfg.d_ff))
        # decoder cross-attention blocks
        total += cfg.n_layers * attn_params()
    return int(total)


def active_param_count(cfg) -> int:
    """Parameters touched per token (MoE: top_k + shared experts only)."""
    if cfg.moe is None:
        return param_count(cfg)
    m = cfg.moe
    act = dataclasses.replace(
        cfg, moe=dataclasses.replace(m, n_experts=m.top_k))
    return param_count(act)


def model_flops(cfg, shape) -> float:
    """6*N_active*D for training; 2*N_active*D for inference tokens.

    decode shapes process exactly `global_batch` tokens per step."""
    n_act = active_param_count(cfg)
    if shape.kind == "train":
        toks = shape.global_batch * shape.seq_len
        return 6.0 * n_act * toks
    if shape.kind == "prefill":
        toks = shape.global_batch * shape.seq_len
        return 2.0 * n_act * toks
    return 2.0 * n_act * shape.global_batch      # decode: 1 token/seq


def roofline_terms(result: dict) -> dict:
    """Three terms in seconds per executed step, from a dry-run record.

    cost_flops / cost_bytes / collective_bytes are PER-DEVICE (rank 0's
    program), so each term divides by one device's rate; this equals the
    global-FLOPs/(devices x rate) formulation.
    """
    chips = result["chips"]
    flops = max(result.get("cost_flops", 0.0), 0.0)
    byts = max(result.get("cost_bytes", 0.0), 0.0)
    coll = sum(result.get("collective_bytes", {}).values())
    terms = {"compute_s": flops / PEAK_FLOPS_BF16,
             "memory_s": byts / HBM_BW,
             "collective_s": coll / NVLINK_BW}
    dom = max(terms, key=terms.get)
    mf = result.get("model_flops", 0.0)   # global
    return {
        **terms,
        "dominant": dom.replace("_s", ""),
        "useful_flops_ratio": (mf / (flops * chips)) if flops > 0 else None,
    }
