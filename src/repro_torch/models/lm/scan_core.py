"""Chunked decayed-outer-product scan — shared core for RWKV6 and SSD.

Port of `repro.models.lm.scan_core`. Both RWKV6's WKV recurrence and
Mamba-2/SSD's selective state space are instances of

    S_t = diag(w_t) S_{t-1} + k_t v_t^T          (state:  K x V per head)
    o_t = r_t^T S_{t-1}                  (+ a per-call diagonal term)

with per-step decay w_t in (0, 1]^K. The reference computes the chunked
form in jnp; the Pallas `wkv6` kernel computes the same function, and
here `chunked_decay_scan` is that kernel (`kernels.ops.wkv6_op`: CUDA on
the card, its plain version on the CPU). All decay products are exp of
differences of cumulative logs, which are <= 0: no overflow however long
the chunk. Callers add their own diagonal (i == t) term.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ops import wkv6_op


def chunked_decay_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       logw: torch.Tensor, s0: torch.Tensor, chunk: int = 64
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Strict-past decayed attention.

    Args:
      r, k, logw: (B, H, T, K); v: (B, H, T, V); s0: (B, H, K, V); f32.
      logw must be <= 0 (log of per-step decay). Any strides: broadcast
      views (stride 0) are read as they are, without a copy.
    Returns: (o: (B, H, T, V), s_final: (B, H, K, V)).

    T need not be a multiple of `chunk`: the op treats the tail as the
    reference's zero padding (`repro/models/lm/scan_core.py:39-42`) —
    zero r/k/v with logw = 0 leave the state unchanged — without copying
    the inputs (the kernel zero-fills its last tile in shared memory).
    """
    return wkv6_op(r, k, v, logw, s0, chunk=chunk)


def decay_scan_step(r, k, v, logw, s, u=None):
    """Single-token decode step (shapes (B, H, K) / (B, H, V), s (B,H,K,V)).

    Returns o = r.(s + u(.)k v^T) and s' = w(.)s + k v^T  — RWKV convention;
    pass u=ones for SSD (current-input passthrough)."""
    if u is None:
        u = torch.ones_like(k)
    kv = k[..., :, None] * v[..., None, :]                    # (B,H,K,V)
    o = torch.einsum("bhk,bhkv->bhv", r, s + u[..., :, None] * kv)
    s_new = torch.exp(logw)[..., :, None] * s + kv
    return o, s_new


def reference_scan(r, k, v, logw, s0, u):
    """O(T) step-by-step oracle for tests (RWKV convention with bonus u):
    r, k, logw (B, H, T, K), v (B, H, T, V), s0 (B, H, K, V), u (H, K) or
    broadcastable -> (o (B, H, T, V), s_final)."""
    s = s0
    outs = []
    for t in range(r.shape[2]):
        rt, kt, vt, wt = r[:, :, t], k[:, :, t], v[:, :, t], logw[:, :, t]
        kv = kt[..., :, None] * vt[..., None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", rt,
                                 s + u[..., :, None] * kv))
        s = torch.exp(wt)[..., :, None] * s + kv
    return torch.stack(outs, dim=2), s
