"""Plain float32 building blocks shared by the per-configuration references.

Written from the published descriptions, in plain PyTorch operations: no
kernel, no cache, no batching trick, and nothing imported from the
program under test. Every function takes float32 tensors. Matrix products
of weights go through `mm`, so that the control (`fp8_mm`) can put the
same reference in the program's place at the next lower precision.
"""
from __future__ import annotations

import torch

# float8 e4m3's largest finite value: each operand is scaled by its
# absolute maximum to it before rounding (per-tensor scaling).
E4M3_MAX = 448.0


def plain_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


def _to_e4m3(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, back in f32."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class _Fp8Matmul(torch.autograd.Function):
    """a @ b with both operands, and in the backward the output's
    gradient, rounded to float8 e4m3 (per-tensor scale), accumulated in
    float32: the GEMMs of an fp8 training step."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _to_e4m3(a), _to_e4m3(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _to_e4m3(g)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


def fp8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _Fp8Matmul.apply(a, b)


MATMULS = {"float32": plain_mm, "float8_e4m3": fp8_mm}


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """x / rms(x) * (1 + gamma): the zero-centred scale of the published
    models' checkpoints."""
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + gamma)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (B, S, H, D) at positions 0..S-1, rotating
    the first half of each head against the second."""
    S, D = x.shape[1], x.shape[-1]
    inv = theta ** (-torch.arange(0, D, 2, dtype=torch.float32,
                                  device=x.device) / D)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * inv[None, :]
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     window: int | None) -> torch.Tensor:
    """Softmax attention of q (B, S, H, D) over k, v (B, S, KV, D), each
    query head reading key head h // (H / KV); query t sees keys i with
    i <= t and, under a window, t - i < window. Returns (B, S, H, D)."""
    B, S, H, D = q.shape
    rep = H // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bthd,bihd->bhti", q, k) * D ** -0.5
    t = torch.arange(S, device=q.device)
    lag = t[:, None] - t[None, :]
    keep = lag >= 0
    if window is not None:
        keep = keep & (lag < window)
    s = s.masked_fill(~keep, float("-inf"))
    return torch.einsum("bhti,bihd->bthd", torch.softmax(s, dim=-1), v)


def _chunked(t: torch.Tensor, chunk: int) -> torch.Tensor:
    """(B, T, ...) zero-padded to whole chunks -> (B, T / chunk, chunk,
    ...)."""
    B, T = t.shape[:2]
    pad = (-T) % chunk
    if pad:
        t = torch.cat([t, t.new_zeros((B, pad) + t.shape[2:])], dim=1)
    return t.view(B, -1, chunk, *t.shape[2:])


def _carry(start: torch.Tensor, decay: torch.Tensor,
           added: torch.Tensor) -> torch.Tensor:
    """Each chunk's start state from the one before: S_0 = `start`,
    S_{c+1} = decay_c S_c + added_c, chunks on axis 1. Returns the start
    states (B, n, ...)."""
    states, s = [], start
    for c in range(added.shape[1]):
        states.append(s)
        s = s * decay[:, c] + added[:, c]
    return torch.stack(states, dim=1)


def ssd_scan(x: torch.Tensor, logw: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, chunk: int = 128) -> torch.Tensor:
    """The SSD recurrence with one scalar decay per head:
        S_t = exp(logw_t) S_{t-1} + b_t x_t^T,   y_t = S_t^T c_t,
    x (B, T, H, P), logw (B, T, H) <= 0, b and c (B, T, N) shared by the
    heads; S_0 = 0. Chunked, every chunk at once: within a chunk the
    decay between two steps is exp of a difference of cumulative logs
    (never positive); the chunks' start states follow one another.
    Returns y (B, T, H, P)."""
    B, T, H, P = x.shape
    xc, wc, bc, cc = (_chunked(t, chunk) for t in (x, logw, b, c))
    L = xc.shape[2]
    cum = torch.cumsum(wc, dim=2)                         # (B, n, L, H)
    lag = cum[:, :, :, None] - cum[:, :, None, :]         # (B, n, t, i, H)
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    decay = torch.where(tri[:, :, None], torch.exp(torch.clamp(lag, max=0.0)),
                        0.0)
    weight = torch.einsum("bctn,bcin->bcti", cc, bc)[..., None] * decay
    y = torch.einsum("bctih,bcihp->bcthp", weight, xc)
    last = cum[:, :, -1]                                  # (B, n, H)
    added = torch.einsum("bcin,bcihp->bchnp", bc,
                         torch.exp(last[:, :, None] - cum)[..., None] * xc)
    states = _carry(x.new_zeros((B, H, b.shape[-1], P)),
                    torch.exp(last)[..., None, None], added)
    y = y + torch.einsum("bctn,bchnp->bcthp", cc, states) \
        * torch.exp(cum)[..., None]
    return y.reshape(B, -1, H, P)[:, :T]


def wkv_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             logw: torch.Tensor, u: torch.Tensor,
             chunk: int = 32) -> torch.Tensor:
    """RWKV6's WKV with a decay per channel and the bonus u:
        o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T),
        S_t = diag(exp(logw_t)) S_{t-1} + k_t v_t^T,
    r, k, logw (B, T, H, K), v (B, T, H, V), u (H, K); S_0 = 0. Chunked,
    every chunk at once, with the decay between steps i < t of a chunk
    taken per channel as exp of the (non-positive) sum of logw over
    i+1 .. t-1; the chunks' start states follow one another. Returns o
    (B, T, H, V)."""
    B, T, H, K = r.shape
    rc, kc, vc, wc = (_chunked(t, chunk) for t in (r, k, v, logw))
    L = rc.shape[2]
    cum = torch.cumsum(wc, dim=2)                         # inclusive
    before = cum - wc                                     # exclusive
    lag = before[:, :, :, None] - cum[:, :, None, :]      # (B,n,t,i,H,K)
    strict = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=r.device), diagonal=-1)
    a = (rc[:, :, :, None] * kc[:, :, None, :]
         * torch.exp(torch.clamp(lag, max=0.0))).sum(-1)  # (B,n,t,i,H)
    a = torch.where(strict[:, :, None], a, 0.0)
    o = torch.einsum("bctih,bcihv->bcthv", a, vc)
    o = o + (rc * u * kc).sum(-1, keepdim=True) * vc
    last = cum[:, :, -1]                                  # (B, n, H, K)
    added = torch.einsum("bcihk,bcihv->bchkv",
                         kc * torch.exp(last[:, :, None] - cum), vc)
    states = _carry(r.new_zeros((B, H, K, v.shape[-1])),
                    torch.exp(last)[..., None], added)
    o = o + torch.einsum("bcthk,bchkv->bcthv", rc * torch.exp(before),
                         states)
    return o.reshape(B, -1, H, v.shape[-1])[:, :T]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Summed next-token cross-entropy: log-sum-exp minus the label's
    logit, over every position."""
    lse = torch.logsumexp(logits, dim=-1)
    return (lse - logits.gather(-1, labels[..., None])[..., 0]).sum()
