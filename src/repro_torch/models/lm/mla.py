"""Multi-head Latent Attention (DeepSeek-V2/V3).

Port of `repro.models.lm.mla`. Queries and keys/values are projected
through low-rank bottlenecks; only the compressed KV latent c_kv
(kv_lora_rank) and the shared RoPE key (rope_head_dim) are cached.

Prefill and training expand k_nope and v from c_kv, broadcast k_rope over
the heads and attend through `attention.attention_prefill`: one
`flash_attention` launch with keys of nope + rope dims and values of
v_head_dim (Dv != D; (192, 128) at deepseek-v3's widths), scaled by the
key dim's D^-1/2 as the reference. `mla_stacked` runs a stack of G
clients (every leaf of `p` with a leading (G,) axis, x (G, B*S, d)): the
projections are batched products per client and the clients fold into
the kernel's batch, so one launch serves a layer for the whole stack.
`mla_prefill` is its form for one model, each row of the batch a stack
entry that shares the weights.

Decode uses the *absorbed* form, plain torch products as in the
reference (no kernel): W_uk is folded into the query and W_uv into the
output, so attention runs in the compressed space against the
(c_kv, k_rope) cache, 576 values a token a layer at full width against
the 40,960 of an expanded 128-head k/v cache. `mla_decode` writes the
new token's latent into the cache in place (the reference returns new
arrays).
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models.lm.attention import attention_prefill
from repro_torch.models.lm.config import MLAConfig
from repro_torch.models.lm.layers import apply_rope, dense_init, rmsnorm


def init_mla(generator: torch.Generator, d_model: int, n_heads: int,
             cfg: MLAConfig, lead: tuple[int, ...] = (), device=None,
             dtype=torch.float32) -> dict:
    device = resolve_device(device)
    kw = dict(lead=lead, device=device, dtype=dtype)
    qh = cfg.nope_head_dim + cfg.rope_head_dim
    zeros = lambda n: torch.zeros(tuple(lead) + (n,), dtype=dtype,
                                  device=device)
    return {
        "wq_a": dense_init(generator, (d_model, cfg.q_lora_rank), **kw),
        "q_norm": zeros(cfg.q_lora_rank),
        "wq_b": dense_init(generator, (cfg.q_lora_rank, n_heads * qh), **kw),
        "wkv_a": dense_init(
            generator, (d_model, cfg.kv_lora_rank + cfg.rope_head_dim), **kw),
        "kv_norm": zeros(cfg.kv_lora_rank),
        "wk_b": dense_init(
            generator, (cfg.kv_lora_rank, n_heads * cfg.nope_head_dim), **kw),
        "wv_b": dense_init(
            generator, (cfg.kv_lora_rank, n_heads * cfg.v_head_dim), **kw),
        "wo": dense_init(generator, (n_heads * cfg.v_head_dim, d_model), **kw),
    }


def _project_q(p, x, n_heads: int, cfg: MLAConfig, positions, theta,
               seq_len: int):
    """x (G, N, d) -> q_nope (G*N/S, S, H, nope), q_rope (.., rope)."""
    # A norm scale (G, r) broadcasts against (G, N, r) as (G, 1, r).
    cq = rmsnorm(x @ p["wq_a"], p["q_norm"].unsqueeze(-2))
    q = (cq @ p["wq_b"]).reshape(-1, seq_len, n_heads,
                                 cfg.nope_head_dim + cfg.rope_head_dim)
    q_nope, q_rope = q.split([cfg.nope_head_dim, cfg.rope_head_dim], -1)
    return q_nope, apply_rope(q_rope, positions, theta)


def _project_kv_latent(p, x, cfg: MLAConfig, positions, theta,
                       seq_len: int):
    """x (G, N, d) -> c_kv (G, N, r), k_rope (G, N, rope), k_rope
    rotated at its sequence's positions."""
    c_kv, k_rope = (x @ p["wkv_a"]).split(
        [cfg.kv_lora_rank, cfg.rope_head_dim], -1)
    c_kv = rmsnorm(c_kv, p["kv_norm"].unsqueeze(-2))
    k_rope = apply_rope(k_rope.reshape(-1, seq_len, 1, cfg.rope_head_dim),
                        positions, theta).reshape(k_rope.shape)
    return c_kv, k_rope


def mla_stacked(p: dict, x: torch.Tensor, n_heads: int, cfg: MLAConfig,
                positions: torch.Tensor, theta: float, seq_len: int):
    """MLA over a client stack: x (G, B*S, d), S = seq_len, positions
    (S,), p's leaves (G, ...), or without the client axis to share one
    model's weights over G. Returns (out (G, B*S, d), (c_kv (G, B*S, r),
    k_rope (G, B*S, rope)))."""
    G, n, _ = x.shape
    S, H = seq_len, n_heads
    q_nope, q_rope = _project_q(p, x, H, cfg, positions, theta, S)
    c_kv, k_rope = _project_kv_latent(p, x, cfg, positions, theta, S)
    # Expand keys and values for the parallel (training / prefill) form.
    k_nope = (c_kv @ p["wk_b"]).reshape(-1, S, H, cfg.nope_head_dim)
    v = (c_kv @ p["wv_b"]).reshape(-1, S, H, cfg.v_head_dim)
    q = torch.cat([q_nope, q_rope], -1)
    kr = k_rope.reshape(-1, S, 1, cfg.rope_head_dim)
    k = torch.cat([k_nope, kr.expand(-1, S, H, cfg.rope_head_dim)], -1)
    o = attention_prefill(q, k, v, causal=True)       # (G*B, S, H, Dv)
    return o.reshape(G, n, H * cfg.v_head_dim) @ p["wo"], (c_kv, k_rope)


def mla_prefill(p: dict, x: torch.Tensor, n_heads: int, cfg: MLAConfig,
                positions: torch.Tensor, theta: float):
    """Full-sequence MLA of one model, x (B, S, d), positions 0..S-1
    (S,): `mla_stacked` with each row its own stack entry. Returns (out
    (B, S, d), cache (c_kv (B, S, r), k_rope (B, S, rope)))."""
    return mla_stacked(p, x, n_heads, cfg, positions, theta, x.shape[1])


def mla_decode(p: dict, x: torch.Tensor, c_kv: torch.Tensor,
               k_rope: torch.Tensor, pos: int, n_heads: int, cfg: MLAConfig,
               theta: float) -> torch.Tensor:
    """Absorbed single-token decode. x (B, 1, d); the cache c_kv (B, Smax,
    r) and k_rope (B, Smax, rope), written at `pos` in place. Returns
    out (B, 1, d)."""
    B = x.shape[0]
    H, r = n_heads, cfg.kv_lora_rank
    positions = torch.full((1,), pos, device=x.device)
    q_nope, q_rope = _project_q(p, x, H, cfg, positions, theta, 1)
    c_new, kr_new = _project_kv_latent(p, x, cfg, positions, theta, 1)
    c_kv[:, pos:pos + 1] = c_new
    k_rope[:, pos:pos + 1] = kr_new
    # Absorb W_uk: q_c (B, 1, H, r) = q_nope @ W_uk^T per head.
    wk = p["wk_b"].reshape(r, H, cfg.nope_head_dim)
    q_c = torch.einsum("bqhd,rhd->bqhr", q_nope, wk)
    scale = (cfg.nope_head_dim + cfg.rope_head_dim) ** -0.5
    s = (torch.einsum("bqhr,bkr->bhqk", q_c, c_kv)
         + torch.einsum("bqhd,bkd->bhqk", q_rope, k_rope)) * scale
    k_pos = torch.arange(c_kv.shape[1], device=x.device)
    s = torch.where(k_pos <= pos, s.float(), -1e30)
    prob = torch.softmax(s, dim=-1).to(x.dtype)
    o_c = torch.einsum("bhqk,bkr->bqhr", prob, c_kv)          # compressed
    wv = p["wv_b"].reshape(r, H, cfg.v_head_dim)
    o = torch.einsum("bqhr,rhd->bqhd", o_c, wv)               # absorb W_uv
    return o.reshape(B, 1, H * cfg.v_head_dim) @ p["wo"]
