"""The LM stack: GQA or MLA attention, routed-expert, RWKV6 and hybrid
(attention + SSD) layers, and the MTP head.

Port of `repro.models.lm.transformer` for the segment kinds
  attn    — [MLA|GQA] attention + dense MLP
  moe     — [MLA|GQA] attention + routed experts (+ shared), row-local
            dispatch, or expert-parallel (one all-to-all each way) over
            full sequences under a declared `sharding.expert_parallel`
            context whose size divides the expert count; decode (S = 1)
            stays row-local
  rwkv    — RWKV6 time mix + channel mix
  hybrid  — parallel GQA attention + SSD heads, then dense MLP
(MLA where `cfg.mla` is set, as deepseek-v3) with the reference's
parameter tree: `params["segments"]` is a list of
dicts, one per `cfg.resolved_segments` entry, whose leaves carry the
segment's stacked layer axis. Where the reference scans that axis
(`lax.scan`), the port loops over it in Python and hands each layer
views of its slice.

Entry points:
  init_params(cfg, generator, device)           -> params
  forward_train(cfg, params, tokens, ...)       -> (logits, aux)
  forward_train_stacked(cfg, params, tokens, ...) -> (logits, aux)
  prefill(cfg, params, tokens, max_seq, ...)    -> (logits, cache)
  decode_step(cfg, params, token, cache)        -> (logits, cache)
  init_decode_cache(cfg, params, B, max_seq)    -> (logits, cache)
  encoder_forward(cfg, params, enc_embeds)      -> encoder output

Enc-dec (whisper) and prefix embeddings (VLM), as the reference: a
config with an encoder has `params["encoder"]` (one stacked "attn"
segment of `cfg.encoder.n_layers`) and `params["enc_final_norm"]`, and
each decoder layer a cross-attention block (`xattn`, `norm_x`) after its
self-attention. `encoder_forward` runs the bidirectional stack over the
stubbed frame embeddings (B, F, d); cross-attention attends from the
decoder's positions to the frames at 0..F-1 with no mask, through the
same `flash_attention` kernel with keys of their own length. Prefill
caches each layer's cross K/V once (`xk`, `xv`), and every decode step
reads them. `prefix_embeds` (B, P, d) (the stubbed vision tower's patch
embeddings) go before the text tokens and take positions 0..P-1; the
decode cache's `pos` counts them. With `cfg.pos_emb == "sinusoidal"`
the f32 sinusoidal table, rounded once to the model's dtype, is added
to the embeddings (the encoder's frames too).

`forward_train_stacked` is the training forward over a stack of clients
(every param leaf with a leading (G,) client axis, tokens (G, B, S)): the
projections are batched products per client, and attention and the SSD
scan fold the clients into the kernels' batch, so one `flash_attention`
(and one `wkv6`) launch serves a layer for the whole stack, forward and
backward. `forward_train` is its single-client case (G = 1, the params
as views). With `cfg.remat` each layer is recomputed in the backward
(`torch.utils.checkpoint`), as the reference's `jax.checkpoint` of the
scanned layer.

The prefill attention is the `flash_attention` kernel (for MLA with
value head dim Dv below the keys' D, `mla.mla_stacked`), and the SSD and
RWKV6 prefill scans the `wkv6` kernel (through `attention.attention_prefill`
and `scan_core.chunked_decay_scan`). The decode cache is the reference's, per
segment with a leading layer axis, plus `cache["pos"]`, a Python int
(one position for the whole batch, kept on the host). `decode_step`
updates the cache's tensors in place and returns the cache with `pos`
advanced: the reference returns new arrays instead. An `rwkv` layer's
cache is O(1) in the sequence: the last inputs of both mixes and the
(H, hd, hd) scan state, in the model's dtype. An MLA layer caches the
compressed latent c_kv and the shared rope key, and decodes in the
absorbed form (`mla.mla_decode`).

The MoE layers' aux loss is per client in `forward_train_stacked`
(`moe_aux` of shape (G,), each client's over its own tokens), so that
`client_lm_losses` adds each client its own; `forward_train` returns it
0-d, as the reference. With `cfg.mtp` both also return `mtp_logits`,
the MTP head's next-next-token logits off the final norm.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models.lm.attention import (
    attention_decode,
    attention_prefill,
    cache_update,
)
from repro_torch.models.lm.config import ModelConfig, Segment
from repro_torch.models.lm.layers import (
    apply_mlp,
    apply_rope,
    dense_init,
    init_mlp,
    rmsnorm,
)
from repro_torch.models.lm.mla import (
    init_mla,
    mla_decode,
    mla_prefill,
    mla_stacked,
)
from repro_torch.models.lm.moe import apply_moe, apply_moe_ep, \
    apply_moe_stacked, init_moe
from repro_torch.models.lm.params import map_tree
from repro_torch.sharding.ctx import ep_axis
from repro_torch.models.lm.rwkv import (
    init_rwkv_channel_mix,
    init_rwkv_time_mix,
    rwkv_channel_mix,
    rwkv_channel_mix_stacked,
    rwkv_time_mix,
    rwkv_time_mix_stacked,
    rwkv_time_mix_step,
)
from repro_torch.models.lm.ssm import (
    CONV_K,
    init_ssm,
    ssm_forward,
    ssm_stacked,
    ssm_step,
)

# ======================================================================= #
# Init
# ======================================================================= #
def _init_gqa(generator, cfg: ModelConfig, lead, device, dtype) -> dict:
    hd = cfg.resolved_head_dim
    d, H, KV = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    kw = dict(lead=lead, device=device, dtype=dtype)
    p = {
        "wq": dense_init(generator, (d, H * hd), **kw),
        "wk": dense_init(generator, (d, KV * hd), **kw),
        "wv": dense_init(generator, (d, KV * hd), **kw),
        "wo": dense_init(generator, (H * hd, d), **kw),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd)):
            p[name] = torch.zeros(lead + (width,), dtype=dtype, device=device)
    return p


def _is_mla(cfg: ModelConfig, seg: Segment) -> bool:
    """Whether the segment's attention is MLA (the reference's rule)."""
    return cfg.mla is not None and seg.kind in ("attn", "moe")


def _init_segment(cfg: ModelConfig, seg: Segment, generator, device,
                  dtype, cross_attention: bool = False) -> dict:
    """One segment's params, every leaf with a leading (n_layers,) axis;
    with `cross_attention` (an enc-dec decoder), a cross-attention block
    (`xattn`, `norm_x`) beside each layer's self-attention."""
    lead = (seg.n_layers,)
    zeros = lambda *shape: torch.zeros(lead + shape, dtype=dtype,
                                       device=device)
    p: dict = {"norm1": zeros(cfg.d_model), "norm2": zeros(cfg.d_model)}
    if seg.kind == "rwkv":
        p["tm"] = init_rwkv_time_mix(generator, cfg.d_model,
                                     cfg.resolved_head_dim, lead, device,
                                     dtype)
        p["cm"] = init_rwkv_channel_mix(generator, cfg.d_model, cfg.d_ff,
                                        lead, device, dtype)
        return p
    if _is_mla(cfg, seg):
        p["mla"] = init_mla(generator, cfg.d_model, cfg.n_heads, cfg.mla,
                            lead, device, dtype)
    else:
        p["attn"] = _init_gqa(generator, cfg, lead, device, dtype)
    if cross_attention:
        p["xattn"] = _init_gqa(generator, cfg, lead, device, dtype)
        p["norm_x"] = zeros(cfg.d_model)
    if seg.kind == "hybrid":
        p["ssm"] = init_ssm(generator, cfg.d_model, cfg.ssm, lead, device,
                            dtype)
        p["gate_attn"] = zeros()
        p["gate_ssm"] = zeros()
    if seg.kind == "moe":
        p["moe"] = init_moe(generator, cfg.d_model, cfg.moe, cfg.mlp, lead,
                            device, dtype)
    else:
        p["mlp"] = init_mlp(generator, cfg.d_model, cfg.d_ff,
                            cfg.mlp in ("swiglu", "geglu"), lead, device,
                            dtype)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random params from `generator` (which lies on `device`), with the
    reference's leaf names, shapes, dtype (`cfg.dtype`) and
    distributions. The values differ from the reference's (torch and jax
    generators differ); `lm_params_from_jax` carries those across. An
    enc-dec config's decoder segments carry the cross-attention leaves,
    and its encoder is one stacked "attn" segment, `params["encoder"]`,
    with `params["enc_final_norm"]`."""
    device = resolve_device(device)
    dt = getattr(torch, cfg.dtype)
    embed = 0.02 * torch.randn((cfg.vocab_size, cfg.d_model),
                               generator=generator, device=device)
    params: dict = {"embed": embed.to(dt),
                    "final_norm": torch.zeros((cfg.d_model,), dtype=dt,
                                              device=device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(
            generator, (cfg.d_model, cfg.vocab_size), device=device, dtype=dt)
    enc_dec = cfg.encoder is not None
    params["segments"] = [_init_segment(cfg, seg, generator, device, dt,
                                        cross_attention=enc_dec)
                          for seg in cfg.resolved_segments]
    if enc_dec:
        params["encoder"] = _init_segment(cfg, _encoder_segment(cfg),
                                          generator, device, dt)
        params["enc_final_norm"] = torch.zeros((cfg.d_model,), dtype=dt,
                                               device=device)
    if cfg.mtp:
        params["mtp_head"] = dense_init(
            generator, (cfg.d_model, cfg.vocab_size), device=device, dtype=dt)
    return params


def _encoder_segment(cfg: ModelConfig) -> Segment:
    return Segment(kind="attn", n_layers=cfg.encoder.n_layers)


def count_params(params) -> int:
    n = []
    map_tree(lambda t: n.append(t.numel()), params)
    return sum(n)


# ======================================================================= #
# Attention sub-blocks
# ======================================================================= #
def _gqa_q(p: dict, x: torch.Tensor, cfg: ModelConfig,
           positions: torch.Tensor | None):
    """Queries (B, S, H, hd), with RoPE at `positions` where the config
    has it (None: none, as the reference's cross-attention decode)."""
    B, S, _ = x.shape
    q = x @ p["wq"] + (p["bq"] if "bq" in p else 0.0)
    q = q.reshape(B, S, cfg.n_heads, cfg.resolved_head_dim)
    if cfg.rope_theta and positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
    return q


def _gqa_qkv(p: dict, x: torch.Tensor, cfg: ModelConfig,
             positions: torch.Tensor):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    k = x @ p["wk"] + (p["bk"] if "bk" in p else 0.0)
    v = x @ p["wv"] + (p["bv"] if "bv" in p else 0.0)
    k = k.reshape(B, S, cfg.n_kv_heads, hd)
    v = v.reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.rope_theta:
        k = apply_rope(k, positions, cfg.rope_theta)
    return _gqa_q(p, x, cfg, positions), k, v


def cross_kv(p: dict, enc_out: torch.Tensor, cfg: ModelConfig,
             n_frames: int | None = None):
    """Project the encoder's output to cross-attention K/V (no RoPE):
    enc_out (B, F, d) -> k, v (B, F, KV, hd). Over a client stack
    (enc_out (G, B*F, d), p's leaves (G, ...), `n_frames` = F) -> (G*B,
    F, KV, hd): the clients fold into the batch."""
    F = n_frames or enc_out.shape[1]
    hd = cfg.resolved_head_dim
    k = enc_out @ p["wk"]
    v = enc_out @ p["wv"]
    if "bk" in p:
        k, v = k + _row(p["bk"]), v + _row(p["bv"])
    return (k.reshape(-1, F, cfg.n_kv_heads, hd),
            v.reshape(-1, F, cfg.n_kv_heads, hd))


def _gqa_full(p, x, cfg: ModelConfig, positions, window, causal=True,
              kv_override=None):
    """Prefill GQA over positions 0..S-1; with `kv_override`, the
    precomputed (k, v) of cross-attention, whose keys sit at 0..F-1.
    Returns (out, (k, v))."""
    B, S, _ = x.shape
    if kv_override is None:
        q, k, v = _gqa_qkv(p, x, cfg, positions)
    else:
        q, (k, v) = _gqa_q(p, x, cfg, positions), kv_override
    o = attention_prefill(q, k, v, window=window,
                          softcap=cfg.attn_logit_softcap, causal=causal)
    return o.reshape(B, S, -1) @ p["wo"], (k, v)


def _gqa_step(p, x, cfg: ModelConfig, cache_k, cache_v, pos: int, window):
    B = x.shape[0]
    positions = torch.full((1,), pos, device=x.device)
    q, k, v = _gqa_qkv(p, x, cfg, positions)
    cache_update(cache_k, k, pos, window)
    cache_update(cache_v, v, pos, window)
    o = attention_decode(q, cache_k, cache_v, pos, window=window,
                         softcap=cfg.attn_logit_softcap)
    return o.reshape(B, 1, -1) @ p["wo"]


def _seg_window(cfg: ModelConfig, seg: Segment):
    if seg.full_attention:
        return None
    return seg.sliding_window or cfg.sliding_window


# ======================================================================= #
# Layer application (one call per layer)
# ======================================================================= #
def _init_segment_cache(cfg: ModelConfig, seg: Segment, B: int,
                        max_seq: int, dt, device,
                        n_frames: int | None = None) -> dict:
    """One segment's decode cache, every leaf with a leading layer axis;
    with `n_frames` (an enc-dec decoder), also each layer's cross K/V
    over the encoder's frames (`xk`, `xv`), written once by prefill."""
    hd = cfg.resolved_head_dim
    window = _seg_window(cfg, seg)
    slots = min(max_seq, window) if window else max_seq
    zeros = lambda *shape: torch.zeros((seg.n_layers, B) + shape, dtype=dt,
                                       device=device)
    if seg.kind == "rwkv":
        H = cfg.d_model // hd
        return {"tm_x": zeros(cfg.d_model), "cm_x": zeros(cfg.d_model),
                "s": zeros(H, hd, hd)}
    if _is_mla(cfg, seg):
        return {"c_kv": zeros(max_seq, cfg.mla.kv_lora_rank),
                "k_rope": zeros(max_seq, cfg.mla.rope_head_dim)}
    c = {"k": zeros(slots, cfg.n_kv_heads, hd),
         "v": zeros(slots, cfg.n_kv_heads, hd)}
    if n_frames:
        c["xk"] = zeros(n_frames, cfg.n_kv_heads, hd)
        c["xv"] = zeros(n_frames, cfg.n_kv_heads, hd)
    if seg.kind == "hybrid":
        d_inner = cfg.ssm.expand * cfg.d_model
        H = d_inner // cfg.ssm.head_dim
        c["ssm_s"] = zeros(H, cfg.ssm.state_dim, cfg.ssm.head_dim)
        c["conv_tail"] = zeros(CONV_K - 1, d_inner)
    return c


def _apply_layer_prefill(cfg: ModelConfig, seg: Segment, lp: dict, x,
                         positions, cache: dict, enc_out=None):
    """Returns x; fills this layer's `cache` views in place (with
    `enc_out`, the cross K/V too)."""
    if seg.kind == "rwkv":
        h = rmsnorm(x, lp["norm1"], cfg.norm_eps)
        o, (tm_x, s) = rwkv_time_mix(lp["tm"], h, cfg.resolved_head_dim)
        x = x + o
        h2 = rmsnorm(x, lp["norm2"], cfg.norm_eps)
        o, cm_x = rwkv_channel_mix(lp["cm"], h2)
        cache["tm_x"].copy_(tm_x)
        cache["cm_x"].copy_(cm_x)
        cache["s"].copy_(s)
        return x + o
    S = x.shape[1]
    window = _seg_window(cfg, seg)
    h = rmsnorm(x, lp["norm1"], cfg.norm_eps)
    if "mla" in lp:
        o, (c_kv, k_rope) = mla_prefill(lp["mla"], h, cfg.n_heads, cfg.mla,
                                        positions, cfg.rope_theta)
        cache["c_kv"][:, :S] = c_kv
        cache["k_rope"][:, :S] = k_rope
    else:
        o, (k, v) = _gqa_full(lp["attn"], h, cfg, positions, window)
        slots = cache["k"].shape[1]
        if window and S > slots:
            # keep the last `window` tokens, ring-aligned
            start = (S - slots) % slots
            cache["k"].copy_(torch.roll(k[:, -slots:], start, dims=1))
            cache["v"].copy_(torch.roll(v[:, -slots:], start, dims=1))
        else:
            cache["k"][:, :S] = k
            cache["v"][:, :S] = v
    if seg.kind == "hybrid":
        s_out, (ssm_s, tail) = ssm_forward(lp["ssm"], h, cfg.ssm)
        o = torch.exp(lp["gate_attn"]) * o + torch.exp(lp["gate_ssm"]) * s_out
        cache["ssm_s"].copy_(ssm_s)
        cache["conv_tail"].copy_(tail)
    x = x + o
    if enc_out is not None and "xattn" in lp:
        hx = rmsnorm(x, lp["norm_x"], cfg.norm_eps)
        xk, xv = cross_kv(lp["xattn"], enc_out, cfg)
        o, _ = _gqa_full(lp["xattn"], hx, cfg, positions, None,
                         causal=False, kv_override=(xk, xv))
        x = x + o
        cache["xk"].copy_(xk)            # read by every decode step
        cache["xv"].copy_(xv)
    h2 = rmsnorm(x, lp["norm2"], cfg.norm_eps)
    return x + _ffn(cfg, seg, lp, h2)


def _moe_ep(cfg: ModelConfig, S: int):
    """The group when a routed-expert layer over S positions takes the
    expert-parallel dispatch (the reference's `_moe_block`): an EP
    context is declared, the expert count divides its world size, and
    S > 1; else None (row-local)."""
    group = ep_axis()
    if (group is not None and S > 1
            and cfg.moe.n_experts % dist.get_world_size(group) == 0):
        return group
    return None


def _ffn(cfg: ModelConfig, seg: Segment, lp: dict, h2):
    """The layer's feed-forward piece on one model: routed experts (their
    aux loss dropped, as the reference's prefill and decode drop it) or
    the dense MLP."""
    if seg.kind == "moe":
        ep = _moe_ep(cfg, h2.shape[1])
        if ep is not None:
            return apply_moe_ep(lp["moe"], h2, cfg.moe, cfg.mlp, ep)[0]
        return apply_moe(lp["moe"], h2, cfg.moe, cfg.mlp)[0]
    return apply_mlp(lp["mlp"], h2, cfg.mlp)


def _apply_layer_decode(cfg: ModelConfig, seg: Segment, lp: dict, x,
                        cache: dict, pos: int):
    """Returns x; updates this layer's `cache` views in place."""
    if seg.kind == "rwkv":
        h = rmsnorm(x, lp["norm1"], cfg.norm_eps)
        o, (tm_x, s) = rwkv_time_mix_step(lp["tm"], h[:, 0], cache["tm_x"],
                                          cache["s"], cfg.resolved_head_dim)
        x = x + o[:, None, :]
        h2 = rmsnorm(x, lp["norm2"], cfg.norm_eps)
        o2, cm_x = rwkv_channel_mix(lp["cm"], h2, x_prev=cache["cm_x"])
        cache["tm_x"].copy_(tm_x)
        cache["cm_x"].copy_(cm_x)
        cache["s"].copy_(s)
        return x + o2
    window = _seg_window(cfg, seg)
    h = rmsnorm(x, lp["norm1"], cfg.norm_eps)
    if "mla" in lp:
        o = mla_decode(lp["mla"], h, cache["c_kv"], cache["k_rope"], pos,
                       cfg.n_heads, cfg.mla, cfg.rope_theta)
    else:
        o = _gqa_step(lp["attn"], h, cfg, cache["k"], cache["v"], pos,
                      window)
    if seg.kind == "hybrid":
        s_out, (ssm_s, tail) = ssm_step(lp["ssm"], h, cfg.ssm,
                                        cache["ssm_s"], cache["conv_tail"])
        o = torch.exp(lp["gate_attn"]) * o + torch.exp(lp["gate_ssm"]) * s_out
        cache["ssm_s"].copy_(ssm_s)
        cache["conv_tail"].copy_(tail)
    x = x + o
    if "xattn" in lp and "xk" in cache:     # against every cached frame
        hx = rmsnorm(x, lp["norm_x"], cfg.norm_eps)
        o = attention_decode(_gqa_q(lp["xattn"], hx, cfg, None),
                             cache["xk"], cache["xv"],
                             cache["xk"].shape[1] - 1)
        x = x + o.reshape(x.shape[0], 1, -1) @ lp["xattn"]["wo"]
    h2 = rmsnorm(x, lp["norm2"], cfg.norm_eps)
    return x + _ffn(cfg, seg, lp, h2)


# ======================================================================= #
# Top-level model API
# ======================================================================= #
def _layer(tree: dict, i: int) -> dict:
    """Layer i's views of a segment's stacked leaves."""
    return map_tree(lambda t: t[i], tree)


def _logits(cfg: ModelConfig, params, x):
    h = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return h @ params["embed"].T
    return h @ params["lm_head"]


def _sinusoidal(positions: torch.Tensor, d: int) -> torch.Tensor:
    """The reference's f32 sinusoidal table: (..., d), sines then
    cosines of positions times 10000^(-i / (d/2))."""
    half = d // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _add_sinusoidal(cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor) -> torch.Tensor:
    """x (..., S, d) plus the sinusoidal table of `positions` (S,), rounded
    once to x's dtype, where the config embeds positions so."""
    if cfg.pos_emb != "sinusoidal":
        return x
    return x + _sinusoidal(positions, cfg.d_model).to(x.dtype)


def _embed(cfg: ModelConfig, params, tokens, prefix_embeds=None,
           pos_offset: int = 0):
    """tokens (B, S_text); prefix_embeds (B, P, d), the stubbed modality's
    embeddings, go first. Returns (x (B, S, d), positions (S,)): S = P +
    S_text at positions pos_offset + 0..S-1."""
    return _place(cfg, params["embed"][tokens], prefix_embeds, pos_offset)


def _place(cfg: ModelConfig, x, prefix_embeds=None, pos_offset: int = 0):
    """Token embeddings x (..., S_text, d) after the prefix embeddings
    (..., P, d), with their positions: `_embed` past the table lookup."""
    if prefix_embeds is not None:
        if prefix_embeds.shape[-1] != x.shape[-1]:
            raise ValueError(f"prefix_embeds of width "
                             f"{prefix_embeds.shape[-1]}, the model's is "
                             f"{x.shape[-1]}")
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=-2)
    positions = pos_offset + torch.arange(x.shape[-2], device=x.device)
    return _add_sinusoidal(cfg, x, positions), positions


def encoder_forward(cfg: ModelConfig, params, enc_embeds: torch.Tensor):
    """The bidirectional encoder over stubbed frame embeddings (B, F, d)
    -> (B, F, d): the single-model case of `_encoder_stacked`."""
    if enc_embeds is None:
        raise ValueError(f"{cfg.name}: an enc-dec model needs enc_embeds")
    out = _encoder_stacked(cfg, map_tree(lambda t: t.unsqueeze(0), params),
                           enc_embeds[None])
    return out.reshape(enc_embeds.shape)


def prefill(cfg: ModelConfig, params, tokens: torch.Tensor, max_seq: int,
            prefix_embeds=None, enc_embeds=None):
    """Process the prompt (B, S) (after `prefix_embeds` (B, P, d), where
    given) and build the decode cache; an enc-dec config runs its encoder
    over `enc_embeds` (B, F, d) and caches each layer's cross K/V.

    Returns (last-position logits (B, V), cache dict)."""
    enc_out = None
    if cfg.encoder is not None:
        enc_out = encoder_forward(cfg, params, enc_embeds)
    x, positions = _embed(cfg, params, tokens, prefix_embeds)
    B, S, _ = x.shape
    n_frames = None if enc_out is None else enc_out.shape[1]
    caches = []
    for seg, sp in zip(cfg.resolved_segments, params["segments"]):
        cache = _init_segment_cache(cfg, seg, B, max_seq, x.dtype, x.device,
                                    n_frames)
        for i in range(seg.n_layers):
            x = _apply_layer_prefill(cfg, seg, _layer(sp, i), x, positions,
                                     _layer(cache, i), enc_out)
        caches.append(cache)
    logits = _logits(cfg, params, x[:, -1:, :])[:, 0]
    return logits, {"segments": caches, "pos": S}


def decode_step(cfg: ModelConfig, params, token: torch.Tensor, cache):
    """One decode step. token: (B, 1) integer. Returns (logits (B,V),
    cache), the cache updated in place."""
    pos = cache["pos"]
    x, _ = _embed(cfg, params, token, pos_offset=pos)
    for seg, sp, sc in zip(cfg.resolved_segments, params["segments"],
                           cache["segments"]):
        for i in range(seg.n_layers):
            x = _apply_layer_decode(cfg, seg, _layer(sp, i), x,
                                    _layer(sc, i), pos)
    logits = _logits(cfg, params, x)[:, 0]
    return logits, {"segments": cache["segments"], "pos": pos + 1}


def init_decode_cache(cfg: ModelConfig, params, B: int, max_seq: int,
                      enc_embeds=None, prompt=None, prefix_embeds=None):
    """Convenience: prefill from a prompt (or a single BOS token)."""
    if prompt is None:
        prompt = torch.zeros((B, 1), dtype=torch.int64,
                             device=params["embed"].device)
    return prefill(cfg, params, prompt, max_seq, prefix_embeds=prefix_embeds,
                   enc_embeds=enc_embeds)


# ======================================================================= #
# Training forward (a leading client axis)
# ======================================================================= #
def _row(w: torch.Tensor) -> torch.Tensor:
    """A (G, e) per-client vector, shaped to broadcast against (G, N, e)."""
    return w.unsqueeze(-2)


def _gqa_train(p, x, cfg: ModelConfig, positions, window, seq_len: int,
               causal: bool = True, kv=None):
    """GQA over a client stack: x (G, B*S, d), p's leaves (G, ...).
    Clients fold into the kernel's batch: (G*B, H, S, D). `kv`: the
    cross-attention's (k, v) from `cross_kv` (keys at 0..F-1, no RoPE)
    in place of x's own."""
    G, n, _ = x.shape
    GB, hd = G * (n // seq_len), cfg.resolved_head_dim
    q = x @ p["wq"]
    if "bq" in p:
        q = q + _row(p["bq"])
    q = q.reshape(GB, seq_len, cfg.n_heads, hd)
    if cfg.rope_theta:
        q = apply_rope(q, positions, cfg.rope_theta)
    if kv is None:
        k = x @ p["wk"]
        v = x @ p["wv"]
        if "bk" in p:
            k, v = k + _row(p["bk"]), v + _row(p["bv"])
        k = k.reshape(GB, seq_len, cfg.n_kv_heads, hd)
        v = v.reshape(GB, seq_len, cfg.n_kv_heads, hd)
        if cfg.rope_theta:
            k = apply_rope(k, positions, cfg.rope_theta)
    else:
        k, v = kv
    o = attention_prefill(q, k, v, window=window,
                          softcap=cfg.attn_logit_softcap, causal=causal)
    return o.reshape(G, n, -1) @ p["wo"]


def _apply_layer_train(cfg: ModelConfig, seg: Segment, lp: dict, x,
                       positions, seq_len: int, enc_out=None,
                       n_frames: int | None = None):
    """One layer of the training forward (the reference's
    `_apply_layer_train`) on x (G, B*S, d); with `enc_out` (G, B*F, d),
    the encoder's output, a decoder layer's cross-attention too. Returns
    (x, the layer's MoE aux loss per client (G,), or None for the other
    kinds)."""
    if seg.kind == "rwkv":
        hd = cfg.resolved_head_dim
        o, _ = rwkv_time_mix_stacked(
            lp["tm"], rmsnorm(x, _row(lp["norm1"]), cfg.norm_eps), hd,
            seq_len)
        x = x + o
        o, _ = rwkv_channel_mix_stacked(
            lp["cm"], rmsnorm(x, _row(lp["norm2"]), cfg.norm_eps), seq_len)
        return x + o, None
    window = _seg_window(cfg, seg)
    h = rmsnorm(x, _row(lp["norm1"]), cfg.norm_eps)
    if "mla" in lp:
        o, _ = mla_stacked(lp["mla"], h, cfg.n_heads, cfg.mla, positions,
                           cfg.rope_theta, seq_len)
    else:
        o = _gqa_train(lp["attn"], h, cfg, positions, window, seq_len)
    if seg.kind == "hybrid":
        s, _ = ssm_stacked(lp["ssm"], h, cfg.ssm, seq_len)
        gate = lambda g: torch.exp(g)[:, None, None]
        o = gate(lp["gate_attn"]) * o + gate(lp["gate_ssm"]) * s
    x = x + o
    if enc_out is not None and "xattn" in lp:
        hx = rmsnorm(x, _row(lp["norm_x"]), cfg.norm_eps)
        kv = cross_kv(lp["xattn"], enc_out, cfg, n_frames)
        x = x + _gqa_train(lp["xattn"], hx, cfg, positions, None, seq_len,
                           causal=False, kv=kv)
    h2 = rmsnorm(x, _row(lp["norm2"]), cfg.norm_eps)
    if seg.kind == "moe":
        ep = _moe_ep(cfg, seq_len)
        if ep is not None:
            G, n, d = h2.shape
            if G != 1:
                raise ValueError(
                    f"expert-parallel MoE trains one model, not a stack of "
                    f"{G} clients")
            lp1 = map_tree(lambda t: t[0], lp["moe"])
            o, aux = apply_moe_ep(lp1, h2.view(n // seq_len, seq_len, d),
                                  cfg.moe, cfg.mlp, ep)
            o = o.reshape(1, n, d)
            aux = {k: v.reshape(1) for k, v in aux.items()}
        else:
            o, aux = apply_moe_stacked(lp["moe"], h2, cfg.moe, cfg.mlp,
                                       seq_len)
        return x + o, aux["load_balance"] + aux["router_z"]
    return x + apply_mlp(lp["mlp"], h2, cfg.mlp), None


def _encoder_stacked(cfg: ModelConfig, params, enc_embeds: torch.Tensor):
    """The bidirectional encoder over a client stack (the reference's
    `encoder_forward`): params' leaves (G, ...), enc_embeds (G, B, F, d)
    -> (G, B*F, d): sinusoidal positions over the frames, each layer's
    non-causal self-attention (the clients folded into the kernel's
    batch) and MLP, then `enc_final_norm`."""
    G, B, F, _ = enc_embeds.shape
    positions = torch.arange(F, device=enc_embeds.device)
    x = _add_sinusoidal(cfg, enc_embeds, positions).reshape(G, B * F, -1)
    for i in range(cfg.encoder.n_layers):
        lp = map_tree(lambda t: t[:, i], params["encoder"])
        h = rmsnorm(x, _row(lp["norm1"]), cfg.norm_eps)
        x = x + _gqa_train(lp["attn"], h, cfg, positions, None, F,
                           causal=False)
        h2 = rmsnorm(x, _row(lp["norm2"]), cfg.norm_eps)
        x = x + apply_mlp(lp["mlp"], h2, cfg.mlp)
    return rmsnorm(x, _row(params["enc_final_norm"]), cfg.norm_eps)


def forward_train_stacked(cfg: ModelConfig, params, tokens: torch.Tensor,
                          prefix_embeds=None, enc_embeds=None):
    """Full-sequence forward of G clients at once: every leaf of `params`
    has a leading (G,) axis, tokens (G, B, S) integer, `prefix_embeds`
    (G, B, P, d) and `enc_embeds` (G, B, F, d) where the config takes
    them. Returns (logits (G, B, P + S, V), {"moe_aux": (G,) f32}), each
    client's MoE aux loss summed over its layers (zero without MoE
    layers); with the MTP head, also "mtp_logits" (G, B, P + S, V)."""
    G, B, _ = tokens.shape
    enc_out, n_frames = None, None
    if cfg.encoder is not None:
        if enc_embeds is None:
            raise ValueError(f"{cfg.name}: an enc-dec model needs "
                             "enc_embeds")
        enc_out = _encoder_stacked(cfg, params, enc_embeds)
        n_frames = enc_embeds.shape[2]
    # Each client's rows of its own table, through `F.embedding`: its
    # backward sums a token's repeats in a fixed order, where indexing's
    # accumulating backward on several CPU threads does not (a routed
    # model's training then drifts from run to run).
    emb = params["embed"]
    V = emb.shape[1]
    rows = torch.arange(G, device=tokens.device)[:, None, None] * V + tokens
    x, positions = _place(cfg, F.embedding(rows, emb.reshape(G * V, -1)),
                          prefix_embeds)
    S = x.shape[2]
    x = x.reshape(G, B * S, -1)
    moe_aux = torch.zeros((G,), dtype=torch.float32, device=tokens.device)
    for seg, sp in zip(cfg.resolved_segments, params["segments"]):
        for i in range(seg.n_layers):
            lp = map_tree(lambda t: t[:, i], sp)
            if cfg.remat:
                x, aux = checkpoint(_apply_layer_train, cfg, seg, lp, x,
                                    positions, S, enc_out, n_frames,
                                    use_reentrant=False)
            else:
                x, aux = _apply_layer_train(cfg, seg, lp, x, positions, S,
                                            enc_out, n_frames)
            if aux is not None:
                moe_aux = moe_aux + aux
    h = rmsnorm(x, _row(params["final_norm"]), cfg.norm_eps)
    aux = {"moe_aux": moe_aux}
    if cfg.mtp and "mtp_head" in params:
        aux["mtp_logits"] = (h @ params["mtp_head"]).reshape(G, B, S, -1)
    logits = h @ (params["embed"].transpose(-1, -2) if cfg.tie_embeddings
                  else params["lm_head"])
    return logits.reshape(G, B, S, -1), aux


def forward_train(cfg: ModelConfig, params, tokens, prefix_embeds=None,
                  enc_embeds=None):
    """Full-sequence forward of one model. tokens (B, S) integer,
    `prefix_embeds` (B, P, d), `enc_embeds` (B, F, d). Returns (logits
    (B, P + S, V), {"moe_aux": 0-d}), as the reference: the MoE layers'
    aux loss, zero without them (and "mtp_logits" (B, P + S, V) with the
    MTP head)."""
    one = lambda t: None if t is None else t[None]
    logits, aux = forward_train_stacked(
        cfg, map_tree(lambda t: t.unsqueeze(0), params), tokens[None],
        one(prefix_embeds), one(enc_embeds))
    return logits[0], {k: v[0] for k, v in aux.items()}
