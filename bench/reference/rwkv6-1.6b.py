"""Plain float32 reference of rwkv6-1.6b, "Finch" (arXiv:2404.05892), as
the benchmark runs it: a next-token loss over a token batch.

Each block is a time mix and a channel mix, each on an RMS-normed input
and added to the residual. The time mix shifts each token's input one
step back (zero before the first) and interpolates towards it with a
data-dependent lerp: a first mix by mu_x, a tanh LoRA of rank 32 giving
five adjustments, one for each of r, k, v, the decay w and the gate g.
The decay is per channel, w_t = exp(-exp(w0 + tanh(x_w A) B)) with a
LoRA of rank 64, its log clipped to [-40, -1e-4]. The WKV recurrence
with the bonus u runs over heads of 64 channels, its output goes through
a per-head GroupNorm (eps 64e-5), times SiLU(g), into the output
projection. The channel mix is token-shifted too: sigmoid(r) times the
squared-ReLU MLP of width d_ff.

`loss_sum(cfg, params, tokens, mm)` takes the configuration file's
"model" section, the weights as a tree of float32 tensors, and tokens
(B, S); it returns the summed cross-entropy of positions 1..S-1. Each
layer is recomputed in the backward (`torch.utils.checkpoint`).
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

MIX_RANK = 32          # the data-dependent lerp's LoRA
DECAY_CLIP = (-40.0, -1e-4)
GROUP_NORM_EPS = 64e-5


def _shift(x):
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _time_mix(p, x, cfg, mm):
    B, S, d = x.shape
    hd = cfg["head_dim"]
    H = d // hd
    dx = _shift(x) - x
    lora = torch.tanh(mm(x + dx * p["mu"][0], p["tm_w1"]))
    lora = lora.view(B, S, 5, MIX_RANK)
    xr, xk, xv, xw, xg = (x + dx * (p["mu"][f] + mm(lora[:, :, f],
                                                     p["tm_w2"][f]))
                          for f in range(5))
    heads = lambda t: t.view(B, S, H, hd)
    r, k, v = heads(mm(xr, p["wr"])), heads(mm(xk, p["wk"])), \
        heads(mm(xv, p["wv"]))
    g = F.silu(mm(xg, p["wg"]))
    logw = -torch.exp(p["w0"] + mm(torch.tanh(mm(xw, p["td_w1"])),
                                   p["td_w2"]))
    logw = torch.clamp(heads(logw), *DECAY_CLIP)
    o = plain.wkv_scan(r, k, v, logw, p["u"])
    mean = o.mean(-1, keepdim=True)
    var = o.var(-1, unbiased=False, keepdim=True)
    o = ((o - mean) * torch.rsqrt(var + GROUP_NORM_EPS)).reshape(B, S, d)
    o = o * p["ln_x_g"] + p["ln_x_b"]
    return mm(o * g, p["wo"])


def _channel_mix(p, x, mm):
    dx = _shift(x) - x
    xk, xr = x + dx * p["mu_k"], x + dx * p["mu_r"]
    return torch.sigmoid(mm(xr, p["wr"])) \
        * mm(torch.square(torch.relu(mm(xk, p["wk"]))), p["wv"])


def _layer(p, x, cfg, mm):
    x = x + _time_mix(p["tm"], plain.rmsnorm(x, p["norm1"], cfg["norm_eps"]),
                      cfg, mm)
    return x + _channel_mix(p["cm"], plain.rmsnorm(x, p["norm2"],
                                                   cfg["norm_eps"]), mm)


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
        for lp in _layers(sp):
            x = checkpoint(_layer, lp, x, cfg, mm,
                           use_reentrant=False)
    h = plain.rmsnorm(x, params["final_norm"], cfg["norm_eps"])
    logits = mm(h, params["lm_head"])
    return plain.cross_entropy(logits[:, :-1], tokens[:, 1:])
