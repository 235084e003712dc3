"""RWKV6 "Finch" block: data-dependent-decay time mix + channel mix.

Port of `repro.models.lm.rwkv` (arXiv:2404.05892): token shift with a
data-dependent lerp (ddlerp, a small LoRA), per-channel decay
w_t = exp(-exp(w0 + lora(x))), the bonus u, a per-head GroupNorm on the
WKV output, and the squared-ReLU channel mix. The train and prefill
recurrence is `scan_core.chunked_decay_scan`, i.e. the `wkv6` kernel
(forward and, through autograd, `wkv6_bwd`), at K = V = head_dim on
transposed views of the (B, T, H, hd) projections; decode takes one
`decay_scan_step` with u, as the reference does (no kernel there).

The `*_stacked` functions take a leading client axis: x (G, B*T, d)
holds B sequences of T = seq_len rows per client, and every leaf of `p`
has a leading (G,) axis. Projections are one batched product per client,
the token shift runs per sequence (never across the flattened B*T axis),
and the scan folds the clients into its batch, (G*B, H, T, hd): one
`wkv6` launch for the whole stack. The unstacked forms are their G = 1
views, as `ssm.ssm_forward` is of `ssm.ssm_stacked`.

The dtype flow is the reference's (`rwkv.py:95-113`): with bf16 params
the decay's LoRA sum is bf16 and turns f32 only before `-exp`; r, k, v
and the state go to f32 for the scan, the bonus term is f32, and the
output returns to x's dtype before the GroupNorm; the end state comes
back in x's dtype, so a bf16 model's decode cache holds a bf16 state.

Except in a bf16 model's training forward, where this port departs from
the reference's bf16 flow: its activations are f32 from the embeddings
to the logits, over the bf16 weights (`transformer.forward_train_stacked`,
`f32_activations`). The gradient of full-width rwkv6 at a seeded init
is ill-conditioned: at the start of each sequence the wkv state is
young, so the GroupNorm's variance is near its eps and the bonus
r.(u k) cancels; most of the loss's gradient passes through those
positions and grows down the stack. Activations held in bf16 moved the
gradient of full-width rwkv6-1.6b on 2 x 2,048 tokens by 1.7-7.7x at the
median leaf against the f32 gradient of the same weights, and forward
products short of f32 (TF32 or bf16 pieces of the activations) by
0.1-0.5. So the forward's weight products are f32 products of the bf16
values; the backward's take bf16 pieces of the gradient
(`_F32Product`). The first layers are recomputed in the backward, so
that the f32 activations fit (`recomputed_layers`). Prefill and decode keep
the reference's flow.

Spans (`repro_torch.obs`, off unless enabled): `rwkv.time_mix` around
its parts `.shift` (the ddlerp), `.decay`, `.scan` and `.out` (bonus,
GroupNorm, gate, output projection; the r, k, v and g projections are
the outer span's own), and `rwkv.channel_mix`; each once a layer, and
once more for a layer recomputed in the backward.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.lm.layers import dense_init
from repro_torch.models.lm.scan_core import chunked_decay_scan, \
    decay_scan_step
from repro_torch.obs import span

LORA_TM = 32     # ddlerp LoRA rank
LORA_DECAY = 64  # decay LoRA rank


def _decay_base(d_model: int, device) -> torch.Tensor:
    """w0 = -6 + 5 linspace(0, 1, d)^1.5 in f32 as the reference computes
    it: jnp.linspace's iota times the reciprocal of (d - 1), and the power
    rounded once from f64 (XLA's f32 pow is correctly rounded: bitwise at
    the reduced d = 256)."""
    lin = torch.arange(d_model, dtype=torch.float32, device=device) \
        * torch.tensor(1.0 / max(d_model - 1, 1), dtype=torch.float32)
    lin[-1] = 1.0
    return -6.0 + 5.0 * (lin.double() ** 1.5).float()


def init_rwkv_time_mix(generator: torch.Generator, d_model: int,
                       head_dim: int, lead: tuple[int, ...] = (),
                       device=None, dtype=torch.float32) -> dict:
    device = resolve_device(device)
    H = d_model // head_dim
    lead = tuple(lead)
    kw = dict(lead=lead, device=device, dtype=dtype)

    def full(shape, value):
        return torch.full(lead + shape, value, dtype=dtype, device=device)

    d = d_model
    return {
        # ddlerp: 5 interpolation targets (r, k, v, w, g)
        "mu": full((5, d), 0.5),
        "tm_w1": dense_init(generator, (d, 5 * LORA_TM), scale=0.01, **kw),
        "tm_w2": dense_init(generator, (5, LORA_TM, d), scale=0.01, **kw),
        # decay
        "w0": _decay_base(d, device).to(dtype).expand(lead + (d,)).clone(),
        "td_w1": dense_init(generator, (d, LORA_DECAY), scale=0.01, **kw),
        "td_w2": dense_init(generator, (LORA_DECAY, d), scale=0.01, **kw),
        "u": full((H, head_dim), 0.1),
        "wr": dense_init(generator, (d, d), **kw),
        "wk": dense_init(generator, (d, d), **kw),
        "wv": dense_init(generator, (d, d), **kw),
        "wg": dense_init(generator, (d, d), **kw),
        "wo": dense_init(generator, (d, d), **kw),
        "ln_x_g": full((d,), 1.0),
        "ln_x_b": full((d,), 0.0),
    }


def init_rwkv_channel_mix(generator: torch.Generator, d_model: int,
                          d_ff: int, lead: tuple[int, ...] = (),
                          device=None, dtype=torch.float32) -> dict:
    device = resolve_device(device)
    lead = tuple(lead)
    kw = dict(lead=lead, device=device, dtype=dtype)
    return {
        "mu_k": torch.full(lead + (d_model,), 0.5, dtype=dtype,
                           device=device),
        "mu_r": torch.full(lead + (d_model,), 0.5, dtype=dtype,
                           device=device),
        "wk": dense_init(generator, (d_model, d_ff), **kw),
        "wv": dense_init(generator, (d_ff, d_model), **kw),
        "wr": dense_init(generator, (d_model, d_model), **kw),
    }


def _group_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                n_groups: int, eps: float = 64e-5) -> torch.Tensor:
    """Per-head GroupNorm over the channel dim (population variance, as
    `jnp.var`). x: (..., d); g, b broadcast against x."""
    shp = x.shape
    xg = x.reshape(shp[:-1] + (n_groups, shp[-1] // n_groups))
    mean = xg.mean(-1, keepdim=True)
    var = xg.var(-1, unbiased=False, keepdim=True)
    xg = (xg - mean) * torch.rsqrt(var + eps)
    return xg.reshape(shp) * g + b


def _row(w: torch.Tensor) -> torch.Tensor:
    """A (G, e) per-client vector, shaped to broadcast against (G, N, e)."""
    return w.unsqueeze(-2)


def _shift(x: torch.Tensor, seq_len: int,
           x_prev: torch.Tensor | None) -> torch.Tensor:
    """Each sequence's input one step back: x (G, B*T, d) -> the same
    shape, whose first row per sequence is zero (train, prefill) or
    `x_prev` (G*B, d) (decode's cached last input)."""
    G, n, d = x.shape
    xs = x.view(G, n // seq_len, seq_len, d)
    first = torch.zeros_like(xs[:, :, :1]) if x_prev is None \
        else x_prev.view(G, n // seq_len, 1, d).to(x.dtype)
    return torch.cat([first, xs[:, :, :-1]], dim=2).view(G, n, d)


def _ddlerp(p: dict, x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """Data-dependent token shift over a client stack: x, x_prev (G, N, d),
    p's leaves (G, ...). Returns the 5 mixed variants (5, G, N, d)."""
    dx = x_prev - x
    # First-stage mix for the LoRA input (RWKV6 uses mu_x; reuse mu[0]).
    xx = x + dx * _row(p["mu"][:, 0])
    lora = torch.tanh(weight_product(xx, p["tm_w1"]))     # (G, N, 5 r)
    # The 5 adjustments as one batch of 5 G products.
    G, N = lora.shape[:2]
    adj = weight_product(
        lora.view(G, N, 5, LORA_TM).transpose(1, 2).reshape(G * 5, N,
                                                            LORA_TM),
        p["tm_w2"].reshape(G * 5, LORA_TM, -1))
    adj = adj.view(G, 5, N, -1).transpose(0, 1)           # (5, G, N, d)
    mu = p["mu"].transpose(0, 1)[:, :, None, :]          # (5, G, 1, d)
    return x[None] + dx[None] * (mu + adj)


def _decay(p: dict, xw: torch.Tensor) -> torch.Tensor:
    """Log decay, f32, clipped to [-40, -1e-4]: the LoRA sum in xw's
    dtype, then -exp in f32."""
    lora = torch.tanh(weight_product(xw, p["td_w1"]))
    lw = -torch.exp((_row(p["w0"]) + weight_product(lora, p["td_w2"]))
                    .float())
    return torch.clamp(lw, -40.0, -1e-4)


def rwkv_time_mix_stacked(p: dict, x: torch.Tensor, head_dim: int,
                          seq_len: int, x_prev: torch.Tensor | None = None,
                          state: torch.Tensor | None = None,
                          chunk: int = 64):
    """The time mix over a client stack: x (G, B*T, d), p's leaves (G,
    ...); `x_prev` (G*B, d) the input before each sequence (zero when
    None), `state` (G*B, H, hd, hd) the scan's start state (zero when
    None). Returns (out (G, B*T, d), (last input (G*B, d), end state
    (G*B, H, hd, hd) in x's dtype))."""
    G, n, d = x.shape
    T = seq_len
    B = n // T
    H = d // head_dim
    heads = lambda z: z.reshape(G * B, T, H, head_dim)
    bhtk = lambda z: z.transpose(1, 2)                   # (GB, H, T, hd)
    with span("rwkv.time_mix"):
        with span("rwkv.time_mix.shift"):
            xr, xk, xv, xw, xg = _ddlerp(p, x, _shift(x, T, x_prev))
        r = heads(weight_product(xr, p["wr"])).float()
        k = heads(weight_product(xk, p["wk"])).float()
        v = heads(weight_product(xv, p["wv"])).float()
        g = F.silu(weight_product(xg, p["wg"]))
        with span("rwkv.time_mix.decay"):
            logw = heads(_decay(p, xw))
        with span("rwkv.time_mix.scan"):
            if state is None:
                state = torch.zeros((G * B, H, head_dim, head_dim),
                                    dtype=torch.float32, device=x.device)
            o, s_final = chunked_decay_scan(bhtk(r), bhtk(k), bhtk(v),
                                            bhtk(logw), state.float(),
                                            chunk=chunk)
        with span("rwkv.time_mix.out"):
            # Diagonal bonus term: r.(u (.) k_t) v_t, per client's u.
            u = p["u"].float()[:, None, None]            # (G, 1, 1, H, hd)
            diag = (r.view(G, B, T, H, head_dim) * u
                    * k.view(G, B, T, H, head_dim)).sum(-1).view(G * B, T, H)
            o = o.transpose(1, 2) + diag[..., None] * v
            o = o.reshape(G, n, d).to(x.dtype)
            o = _group_norm(o, _row(p["ln_x_g"]), _row(p["ln_x_b"]), H)
            out = weight_product(o * g, p["wo"])
    last = x.view(G * B, T, d)[:, -1]
    return out, (last, s_final.to(x.dtype))


def rwkv_time_mix(p: dict, x: torch.Tensor, head_dim: int,
                  x_prev: torch.Tensor | None = None,
                  state: torch.Tensor | None = None, chunk: int = 64):
    """x: (B, T, d). Returns (out, (last_x (B, d), final_state)): one
    model, the G = 1 view of `rwkv_time_mix_stacked`."""
    B, T, d = x.shape
    out, (last, s) = rwkv_time_mix_stacked(
        {name: w[None] for name, w in p.items()}, x.reshape(1, B * T, d),
        head_dim, T, x_prev, state, chunk)
    return out.view(B, T, d), (last, s)


def rwkv_time_mix_step(p: dict, x: torch.Tensor, x_prev: torch.Tensor,
                       state: torch.Tensor, head_dim: int):
    """Single-token decode. x, x_prev: (B, d); state: (B, H, K, V)."""
    B, d = x.shape
    H = d // head_dim
    p1 = {name: w[None] for name, w in p.items()}
    xr, xk, xv, xw, xg = _ddlerp(p1, x[None], x_prev[None].to(x.dtype))
    heads = lambda z: z.reshape(B, H, head_dim)
    r = heads(xr @ p1["wr"])
    k = heads(xk @ p1["wk"])
    v = heads(xv @ p1["wv"])
    g = F.silu(xg @ p1["wg"]).reshape(B, d)
    logw = heads(_decay(p1, xw))
    u = p["u"].float()[None].expand(B, H, head_dim)
    o, s_new = decay_scan_step(r.float(), k.float(), v.float(), logw,
                               state.float(), u=u)
    o = o.reshape(B, d).to(x.dtype)
    o = _group_norm(o, p["ln_x_g"], p["ln_x_b"], H)
    return (o * g) @ p["wo"], (x, s_new.to(x.dtype))


def rwkv_channel_mix_stacked(p: dict, x: torch.Tensor, seq_len: int,
                             x_prev: torch.Tensor | None = None):
    """The channel mix over a client stack: x (G, B*T, d), p's leaves (G,
    ...), `x_prev` as in `rwkv_time_mix_stacked`. Returns (out, last input
    (G*B, d))."""
    G, n, d = x.shape
    with span("rwkv.channel_mix"):
        dx = _shift(x, seq_len, x_prev) - x
        xk = x + dx * _row(p["mu_k"])
        xr = x + dx * _row(p["mu_r"])
        h = torch.square(torch.relu(weight_product(xk, p["wk"])))
        out = torch.sigmoid(weight_product(xr, p["wr"])) \
            * weight_product(h, p["wv"])
    return out, x.view(G * (n // seq_len), seq_len, d)[:, -1]


def rwkv_channel_mix(p: dict, x: torch.Tensor,
                     x_prev: torch.Tensor | None = None):
    """x: (B, T, d) (or (B, 1, d) in decode with x_prev (B, d))."""
    B, T, d = x.shape
    out, last = rwkv_channel_mix_stacked(
        {name: w[None] for name, w in p.items()}, x.reshape(1, B * T, d), T,
        x_prev)
    return out.view(B, T, d), last


# ------------------------------------------- f32 activations in training
# Layers of a bf16 attention-free model's f32 training forward that are
# recomputed in the backward (the first ones): the f32 activations of all
# 24 of rwkv6-1.6b's layers at 4 x 2,048 tokens would not fit beside the
# weights on one H100.
RECOMPUTED_LAYERS = 6


class _F32Product(torch.autograd.Function):
    """x (M, N, a) f32 @ w (M, a, b) of a lower precision -> (M, N, b) f32.

    The forward is an f32 product of w's values: the gradient of a full-
    width rwkv6 rests on the forward's activations to f32's last bits
    (products of TF32 pieces of x, some 21 bits, or of bf16 pieces, whose
    f32-output product holds some 16, move it by 0.1-0.5 at the median
    leaf). The backward bears rounding: x's gradient takes the output's
    gradient as two pieces of w's dtype, each product with an f32 output
    (one f32 product on the CPU); the weight's gradient is one product in
    w's dtype (a leaf's, rounded once where it lands, not carried down
    the stack)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x.to(w.dtype), w)
        return x @ w.float()

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        wt = w.transpose(-1, -2)
        hi = dy.to(w.dtype)
        if dy.device.type == "cuda":
            lo = (dy - hi.float()).to(w.dtype)
            dx = torch.bmm(hi, wt, out_dtype=torch.float32) \
                + torch.bmm(lo, wt, out_dtype=torch.float32)
        else:
            dx = dy @ wt.float()
        return dx, x.transpose(-1, -2) @ hi


def weight_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (M, N, a) @ w (M, a, b): through `_F32Product` where x is f32 and
    w is not, else a plain product."""
    if x.dtype == torch.float32 and w.dtype != torch.float32:
        return _F32Product.apply(x, w)
    return x @ w


def f32_activations(cfg, dtype: torch.dtype) -> bool:
    """Whether the training forward of `cfg`, its embeddings in `dtype`,
    runs with f32 activations over its weights: an attention-free (`rwkv`)
    model in bf16 or f16."""
    return cfg.attention_free and dtype in (torch.bfloat16, torch.float16)


def recomputed_layers(cfg, dtype: torch.dtype) -> int:
    """How many of its first layers the training forward of `cfg`, its
    embeddings in `dtype`, recomputes in the backward: every layer under
    `cfg.remat`, else the first RECOMPUTED_LAYERS where the activations
    are f32 (`f32_activations`), else none."""
    n = sum(s.n_layers for s in cfg.resolved_segments)
    if cfg.remat:
        return n
    return min(RECOMPUTED_LAYERS, n) if f32_activations(cfg, dtype) else 0
