"""SSD (Mamba-2 style) selective state-space heads for hybrid blocks.

Port of `repro.models.lm.ssm`. Hymba (arXiv:2411.13676) runs attention
heads and Mamba heads *in parallel* inside each block. The SSM side is
SSD: scalar per-head decay a_t = exp(-softplus(dt) * exp(A_log)), shared
B/C projections (1 group), causal depthwise conv front, gated output with
RMS-style normalization. The prefill recurrence is `scan_core`'s
`chunked_decay_scan`, i.e. the `wkv6` kernel, with the per-head decay and
the shared B projection passed as broadcast views (no copy).

`jax.nn.softplus` is exact (`logaddexp(x, 0)`); torch's `softplus` turns
linear above 20, so `torch.logaddexp` stands in for it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.lm.config import SSMConfig
from repro_torch.models.lm.layers import dense_init, rmsnorm
from repro_torch.models.lm.scan_core import chunked_decay_scan

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
    """Depthwise causal conv via shifted adds. x: (B,T,D); w: (K,D).

    x_prev: (B, K-1, D) tail from the previous segment (decode), else zeros.
    Returns (y, new_tail)."""
    B, T, D = x.shape
    if x_prev is None:
        x_prev = torch.zeros((B, CONV_K - 1, D), dtype=x.dtype,
                             device=x.device)
    xp = torch.cat([x_prev, x], dim=1)               # (B, T+K-1, D)
    y = sum(xp[:, i:i + T, :] * w[i] for i in range(CONV_K)) + b
    return F.silu(y), xp[:, -(CONV_K - 1):, :]


def ssm_forward(p: dict, x: torch.Tensor, cfg: SSMConfig,
                state=None, conv_tail=None, chunk: int = 64):
    """x: (B,T,d_model) -> (y (B,T,d_model), (state, conv_tail))."""
    B, T, d = x.shape
    d_inner = cfg.expand * d
    H = d_inner // cfg.head_dim
    N = cfg.state_dim

    xz = x @ p["in_proj"]
    xs, z = xz.chunk(2, dim=-1)
    xs, tail = _causal_conv(xs, p["conv_w"], p["conv_b"], conv_tail)
    xh = xs.reshape(B, T, H, cfg.head_dim)

    dt = _softplus((x @ p["dt_w"] + p["dt_b"]).float())
    logw = -dt * torch.exp(p["a_log"])                   # (B,T,H) <= 0
    bt = (x @ p["b_proj"]).float()                       # (B,T,N)
    ct = (x @ p["c_proj"]).float()

    # Map onto the scan core: r = C (.) w_t (decay includes current step),
    # k = B_t, v = dt * x_t; diagonal handled explicitly below. k and logw
    # are broadcast views (stride 0 over heads / the state dim).
    r = ct[:, None, :, :] * torch.exp(logw).transpose(1, 2)[..., None]
    k = bt[:, None, :, :].expand(B, H, T, N)
    v = (xh.float() * dt[..., None]).transpose(1, 2)     # (B,H,T,hd)
    lw = logw.transpose(1, 2)[..., None].expand(B, H, T, N)
    if state is None:
        state = torch.zeros((B, H, N, cfg.head_dim), dtype=torch.float32,
                            device=x.device)
    o, s_final = chunked_decay_scan(r, k, v, lw, state.float(), chunk=chunk)
    o = o.transpose(1, 2)                                # (B,T,H,hd)
    # Diagonal (i == t): (C_t . B_t) dt x_t  + D skip.
    diag = torch.einsum("btn,btn->bt", ct, bt)[..., None, None] \
        * v.transpose(1, 2)
    o = o + diag
    o = o + p["d_skip"][None, None, :, None] * xh.float()
    y = o.reshape(B, T, d_inner).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["out_norm"])
    return y @ p["out_proj"], (s_final.to(x.dtype), tail)


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
