"""Plain float32 reference of hymba-1.5b (arXiv:2411.13676) as the
benchmark runs it: a next-token loss over a token batch.

Each block runs attention heads and SSM heads side by side on the same
normed input and sums their outputs under learned gates, then a SwiGLU
MLP. Attention is grouped-query with rotary positions, over a causal
window of `sliding_window` tokens except in the segments marked
`full_attention` (the first, middle and last layer). The SSM heads are
SSD heads: an input projection to the heads' inputs and a gate, a causal
depthwise convolution of width 4 with SiLU, a scalar decay per head
exp(-softplus(dt) exp(a_log)), shared B and C projections of the state
size, a skip term D, and an RMS-normed, SiLU-gated output projection.
Departures from the paper, as the configuration file lists them: no meta
tokens, no cross-layer KV sharing, SSD heads in place of Mamba-1's
per-channel decay.

`loss_sum(cfg, params, tokens, mm)` takes the configuration file's
"model" section, the weights as a tree of float32 tensors (the leaf names
of the configuration's checkpoint layout), and tokens (B, S); it returns
the summed cross-entropy of positions 1..S-1. Each layer is recomputed
in the backward (`torch.utils.checkpoint`) so that a full-width batch
fits beside the weights and their gradients.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

_spec = importlib.util.spec_from_file_location(
    "bench_reference_plain", Path(__file__).with_name("_plain.py"))
plain = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(plain)

CONV_WIDTH = 4


def _attention(p, h, cfg, window, mm):
    B, S, _ = h.shape
    hd = cfg["head_dim"]
    q = mm(h, p["wq"]).view(B, S, cfg["n_heads"], hd)
    k = mm(h, p["wk"]).view(B, S, cfg["n_kv_heads"], hd)
    v = mm(h, p["wv"]).view(B, S, cfg["n_kv_heads"], hd)
    q, k = plain.rope(q, cfg["rope_theta"]), plain.rope(k, cfg["rope_theta"])
    o = plain.causal_attention(q, k, v, window)
    return mm(o.reshape(B, S, -1), p["wo"])


def _ssm(p, h, cfg, mm):
    B, S, d = h.shape
    ssm = cfg["ssm"]
    d_inner = ssm["expand"] * d
    H = d_inner // ssm["head_dim"]
    xs, z = mm(h, p["in_proj"]).split(d_inner, dim=-1)
    pad = F.pad(xs, (0, 0, CONV_WIDTH - 1, 0))
    conv = sum(pad[:, i:i + S] * p["conv_w"][i] for i in range(CONV_WIDTH))
    xs = F.silu(conv + p["conv_b"])
    pre = mm(h, p["dt_w"]) + p["dt_b"]
    dt = torch.logaddexp(pre, torch.zeros_like(pre))            # softplus
    logw = -dt * torch.exp(p["a_log"])                          # (B, S, H)
    x = xs.view(B, S, H, ssm["head_dim"])
    y = plain.ssd_scan(x * dt[..., None], logw, mm(h, p["b_proj"]),
                       mm(h, p["c_proj"]))
    y = (y + p["d_skip"][:, None] * x).reshape(B, S, d_inner)
    y = plain.rmsnorm(y * F.silu(z), p["out_norm"], cfg["norm_eps"])
    return mm(y, p["out_proj"])


def _layer(p, x, cfg, window, mm):
    h = plain.rmsnorm(x, p["norm1"], cfg["norm_eps"])
    o = torch.exp(p["gate_attn"]) * _attention(p["attn"], h, cfg, window, mm) \
        + torch.exp(p["gate_ssm"]) * _ssm(p["ssm"], h, cfg, mm)
    x = x + o
    h = plain.rmsnorm(x, p["norm2"], cfg["norm_eps"])
    m = p["mlp"]
    return x + mm(F.silu(mm(h, m["w1"])) * mm(h, m["w3"]), m["w2"])


def _layers(tree: dict) -> list[dict]:
    """Each layer's views of a segment's stacked leaves, through one
    `unbind` a leaf (whose backward stacks the layers' gradients once)."""
    parts = {k: _layers(v) if isinstance(v, dict) else v.unbind(0)
             for k, v in tree.items()}
    n = len(next(iter(parts.values())))
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def loss_sum(cfg: dict, params: dict, tokens: torch.Tensor,
             mm=plain.plain_mm) -> torch.Tensor:
    x = params["embed"][tokens]
    for seg, sp in zip(cfg["segments"], params["segments"]):
        window = None if seg.get("full_attention") else cfg["sliding_window"]
        for lp in _layers(sp):
            x = checkpoint(_layer, lp, x, cfg, window, mm,
                           use_reentrant=False)
    h = plain.rmsnorm(x, params["final_norm"], cfg["norm_eps"])
    logits = mm(h, params["lm_head"])
    return plain.cross_entropy(logits[:, :-1], tokens[:, 1:])
