"""Shared building blocks: norms, RoPE, gated MLPs, initializers.

Port of `repro.models.lm.layers`. Parameters are plain nested dicts of
tensors. Every `init_*` takes a `torch.Generator` (on the device the
tensors are made on) and a `lead` shape, the segment's stacked layer axis,
which is prepended to every leaf; fan-in is the per-layer shape's. Values
are drawn in f32 and stored in `dtype` leaf by leaf, as the reference
casts its f32 draws (one f32 leaf at a time is alive, not a whole tree).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device


def dense_init(generator: torch.Generator, shape: tuple[int, ...],
               scale: float | None = None, lead: tuple[int, ...] = (),
               device=None, dtype=torch.float32) -> torch.Tensor:
    """Truncated-normal fan-in init (MaxText-style): std * N(0, 1) cut to
    [-2, 2], not rescaled (the reference's `std * truncated_normal`)."""
    device = resolve_device(device)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    w = torch.empty(tuple(lead) + tuple(shape), dtype=torch.float32,
                    device=device)
    return torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                       generator=generator).to(dtype)


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """The reference's dtype flow: variance in f32, scale applied in
    x.dtype, times (1 + gamma)."""
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * (1.0 + gamma)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    device = resolve_device(device)
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) or (S,). Split halves (not
    interleaved pairs), computed in f32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)             # (D/2,)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs         # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------- #
# Gated MLPs
# ----------------------------------------------------------------------- #
def causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                window: int | None = None) -> torch.Tensor:
    """(..., Q, K) boolean mask, True = attend: key positions at or before
    each query's, and within `window` of it where one is given."""
    m = q_pos[..., :, None] >= k_pos[..., None, :]
    if window is not None:
        m &= (q_pos[..., :, None] - k_pos[..., None, :]) < window
    return m


def init_mlp(generator: torch.Generator, d_model: int, d_ff: int,
             gated: bool, lead: tuple[int, ...] = (), device=None,
             dtype=torch.float32) -> dict:
    device = resolve_device(device)
    kw = dict(lead=lead, device=device, dtype=dtype)
    p = {"w1": dense_init(generator, (d_model, d_ff), **kw),
         "w2": dense_init(generator, (d_ff, d_model), **kw)}
    if gated:
        p["w3"] = dense_init(generator, (d_model, d_ff), **kw)
    return p


def apply_mlp(p: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    h = x @ p["w1"]
    if kind == "swiglu":
        h = F.silu(h) * (x @ p["w3"])
    elif kind == "geglu":
        h = F.gelu(h, approximate="tanh") * (x @ p["w3"])
    elif kind == "gelu":
        h = F.gelu(h, approximate="tanh")
    else:
        raise ValueError(kind)
    return h @ p["w2"]
