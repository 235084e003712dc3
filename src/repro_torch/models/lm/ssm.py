"""SSD (Mamba-2 style) selective state-space heads for hybrid blocks.

Port of `repro.models.lm.ssm`. Hymba (arXiv:2411.13676) runs attention
heads and Mamba heads *in parallel* inside each block. The SSM side is
SSD: scalar per-head decay a_t = exp(-softplus(dt) * exp(A_log)), shared
B/C projections (1 group), causal depthwise conv front, gated output with
RMS-style normalization. Between its projections, `ssm_stacked` runs
the heads through `kernels.ops.ssd_heads_op`: the conv front and the
scan's inputs in one kernel, the `wkv6` scan (the per-head decay and the
shared B projection passed as broadcast views, no copy), then the
diagonal, D skip, gate and norm in another, each with a backward kernel
(on the CPU, their plain versions). `ssm_stacked` takes a leading client
axis (training runs a client stack through it, prefill its G = 1 view),
and gradients flow through it. Decode (`ssm_step`) stays plain PyTorch.

`jax.nn.softplus` is exact (`logaddexp(x, 0)`); torch's `softplus` turns
linear above 20, so `torch.logaddexp` stands in for it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.kernels.ops import ssd_heads_op
from repro_torch.models.lm.config import SSMConfig
from repro_torch.models.lm.layers import dense_init, rmsnorm

CONV_K = 4


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def init_ssm(generator: torch.Generator, d_model: int, cfg: SSMConfig,
             lead: tuple[int, ...] = (), device=None,
             dtype=torch.float32) -> dict:
    device = resolve_device(device)
    d_inner = cfg.expand * d_model
    H = d_inner // cfg.head_dim
    lead = tuple(lead)
    kw = dict(lead=lead, device=device, dtype=dtype)

    def full(shape, value):
        return torch.full(lead + shape, value, dtype=dtype, device=device)

    conv_w = torch.randn(lead + (CONV_K, d_inner), generator=generator,
                         device=device)
    a_log = torch.log(torch.linspace(1.0, 8.0, H, device=device))
    return {
        "in_proj": dense_init(generator, (d_model, 2 * d_inner), **kw),
        "conv_w": (0.1 * conv_w).to(dtype),
        "conv_b": full((d_inner,), 0.0),
        "dt_w": dense_init(generator, (d_model, H), scale=0.01, **kw),
        "dt_b": full((H,), -2.0),
        "a_log": a_log.to(dtype).expand(lead + (H,)).clone(),
        "b_proj": dense_init(generator, (d_model, cfg.state_dim), **kw),
        "c_proj": dense_init(generator, (d_model, cfg.state_dim), **kw),
        "d_skip": full((H,), 1.0),
        "out_norm": full((d_inner,), 0.0),
        "out_proj": dense_init(generator, (d_inner, d_model), **kw),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 x_prev: torch.Tensor | None = None):
    """Depthwise causal conv via shifted adds. x: (..., T, D); w: (..., K,
    D) and b: (..., D), their leading axes broadcasting against x's
    (serving: none; training: a client axis shaped to broadcast).

    x_prev: (..., K-1, D) tail from the previous segment (decode), else
    zeros. Returns (y, new_tail)."""
    T, D = x.shape[-2:]
    if x_prev is None:
        x_prev = torch.zeros(x.shape[:-2] + (CONV_K - 1, D), dtype=x.dtype,
                             device=x.device)
    xp = torch.cat([x_prev, x], dim=-2)              # (..., T+K-1, D)
    y = sum(xp[..., i:i + T, :] * w[..., i, :] for i in range(CONV_K)) + b
    return F.silu(y), xp[..., -(CONV_K - 1):, :]


def _conv_tail(xs: torch.Tensor, x_prev: torch.Tensor | None):
    """The conv's last K-1 input rows, the next segment's `x_prev`: xs
    (..., T, D) after x_prev (..., K-1, D) (zeros if None)."""
    T, D = xs.shape[-2:]
    if x_prev is None:
        x_prev = torch.zeros(xs.shape[:-2] + (CONV_K - 1, D), dtype=xs.dtype,
                             device=xs.device)
    keep = xs[..., max(T - (CONV_K - 1), 0):, :]
    return torch.cat([x_prev, keep], dim=-2)[..., -(CONV_K - 1):, :]


def ssm_forward(p: dict, x: torch.Tensor, cfg: SSMConfig,
                state=None, conv_tail=None, chunk: int = 64):
    """x: (B,T,d_model) -> (y (B,T,d_model), (state, conv_tail)): one
    model, the G = 1 view of `ssm_stacked`."""
    B, T, d = x.shape
    y, (s_final, tail) = ssm_stacked(
        {name: w[None] for name, w in p.items()}, x.reshape(1, B * T, d),
        cfg, T, state, None if conv_tail is None else conv_tail[None], chunk)
    return y.view(B, T, d), (s_final, tail[0])


def ssm_stacked(p: dict, x: torch.Tensor, cfg: SSMConfig, seq_len: int,
                state=None, conv_tail=None, chunk: int = 64):
    """The SSD heads over a stack of clients: x (G, B*T, d_model) holds B
    sequences of T = seq_len rows per client, and every leaf of `p` has a
    leading (G,) axis. Projections are one batched product per client
    ((G, B*T, d) @ (G, d, e)); the SSD op folds the clients into its
    batch, (G*B, H, T, .): one launch of each kernel for the whole stack.
    `state` (G*B, H, N, hd) and `conv_tail` (G, B, K-1, d_inner) default
    to zeros. Returns (y (G, B*T, d_model), (state in x's dtype, conv_tail))."""
    G, n, d = x.shape
    T = seq_len
    d_inner = cfg.expand * d
    xz = x @ p["in_proj"]
    y, s_final = ssd_heads_op(
        xz, x @ p["dt_w"], x @ p["b_proj"], x @ p["c_proj"], p["conv_w"],
        p["conv_b"], p["dt_b"], p["a_log"], p["d_skip"], p["out_norm"],
        state, conv_tail, seq_len=T,
        head_dim=cfg.head_dim, chunk=chunk)
    xs = xz[..., :d_inner].reshape(G, n // T, T, d_inner)
    return y @ p["out_proj"], (s_final.to(x.dtype),
                               _conv_tail(xs, conv_tail))


def ssm_step(p: dict, x: torch.Tensor, cfg: SSMConfig, state, conv_tail):
    """Single-token decode. x: (B,1,d)."""
    B, _, d = x.shape
    d_inner = cfg.expand * d
    H = d_inner // cfg.head_dim
    N = cfg.state_dim
    xz = x @ p["in_proj"]
    xs, z = xz.chunk(2, dim=-1)
    xs, tail = _causal_conv(xs, p["conv_w"], p["conv_b"], conv_tail)
    xh = xs.reshape(B, H, cfg.head_dim)
    dt = _softplus((x[:, 0] @ p["dt_w"] + p["dt_b"]).float())  # (B,H)
    logw = -dt * torch.exp(p["a_log"])
    bt = (x[:, 0] @ p["b_proj"]).float()
    ct = (x[:, 0] @ p["c_proj"]).float()
    k = bt[:, None, :].expand(B, H, N)
    v = xh.float() * dt[..., None]
    lw = logw[..., None].expand(B, H, N)
    # decay_scan_step with u = 1/w would be unstable; compute directly:
    kv = k[..., :, None] * v[..., None, :]
    s_new = torch.exp(lw)[..., None] * state.float() + kv
    o = torch.einsum("bhn,bhnv->bhv", ct[:, None, :].expand(B, H, N), s_new)
    o = o + p["d_skip"][None, :, None] * xh.float()
    y = o.reshape(B, 1, d_inner).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["out_norm"])
    return y @ p["out_proj"], (s_new.to(x.dtype), tail)
