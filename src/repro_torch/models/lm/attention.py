"""GQA attention: prefill through the flash kernel, single-token decode,
ring cache.

Port of `repro.models.lm.attention`. The reference's prefill streams
query chunks against K/V in jnp at positions `q_pos` and `k_pos`; the
callers give it queries at 0..S-1 and keys at 0..S-1, or, for
cross-attention, at 0..Sk-1 (the encoder's frames) with no mask. Here
prefill is the `flash_attention` kernel, which takes exactly those:
`kernels.ops.flash_attention_op` (CUDA on the card, its plain version on
the CPU). The model's layout is
(B, S, H, D) and the kernel's (B, H, S, D): the kernel takes strides, so
the transposes below are views, and its output keeps q's memory layout,
so `o.reshape(B, S, -1)` needs no copy either.

Decode stays plain torch, as in the reference (no kernel there).
Sliding-window decode uses a ring cache of `window` slots: slot i holds
the most recent position p with p % window == i. `cache_update` writes
in place (the reference returns a new array): the decode cache is updated
where it lies, which saves a copy of every layer's cache per token.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.ops import flash_attention_op


def _softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def attention_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      window: int | None = None,
                      softcap: float | None = None,
                      causal: bool = True) -> torch.Tensor:
    """q: (B,S,H,D), k/v: (B,Sk,KV,D), queries at positions 0..S-1 and
    keys at 0..Sk-1. Returns (B,S,H,D). H must be a multiple of KV (GQA).
    Keys of their own length (Sk != S, cross-attention) take no causal or
    window mask: such a call raises ValueError."""
    if k.shape[1] != q.shape[1] and (causal or window is not None):
        raise ValueError(f"attention_prefill: {k.shape[1]} keys against "
                         f"{q.shape[1]} queries take no causal or window "
                         "mask")
    o = flash_attention_op(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), causal=causal, window=window,
                           softcap=softcap)
    return o.transpose(1, 2)


def ring_slot(pos: int, window: int | None, max_seq: int) -> int:
    """Cache slot for a token at `pos`."""
    return pos % window if window is not None else pos % max_seq


def cache_positions(pos: int, n_slots: int, window: int | None,
                    device=None) -> torch.Tensor:
    """The token position held in each cache slot after writing position
    `pos`. Slots not yet written get -1 (masked)."""
    idx = torch.arange(n_slots, device=resolve_device(device))
    if window is None:
        return torch.where(idx <= pos, idx, -1)
    # slot i holds the latest p <= pos with p % window == i
    kp = pos - (pos - idx) % window
    return torch.where(kp >= 0, kp, -1)


def attention_decode(q: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: int,
                     window: int | None = None,
                     softcap: float | None = None) -> torch.Tensor:
    """One-token attention against a (possibly ring) cache.

    q: (B,1,H,D); cache_k/v: (B,Smax,KV,D); pos: current position.
    """
    B, _, H, D = q.shape
    KV = cache_k.shape[2]
    rep = H // KV
    k_pos = cache_positions(pos, cache_k.shape[1], window, q.device)
    s = torch.einsum("bqgrd,bkgd->bgrqk",
                     q.reshape(B, 1, KV, rep, D), cache_k) * (D ** -0.5)
    s = _softcap(s, softcap)
    valid = (k_pos >= 0) & (k_pos <= pos)
    if window is not None:
        valid &= (pos - k_pos) < window
    s = torch.where(valid, s.float(), -1e30)
    p = torch.softmax(s, dim=-1).to(cache_v.dtype)
    o = torch.einsum("bgrqk,bkgd->bqgrd", p, cache_v)
    return o.reshape(B, 1, H, D)


def cache_update(cache: torch.Tensor, new: torch.Tensor, pos: int,
                 window: int | None) -> torch.Tensor:
    """Write one token's K or V (B,1,KV,D) into the cache at its ring
    slot, in place; returns the cache."""
    slot = ring_slot(pos, window, cache.shape[1])
    cache[:, slot:slot + 1] = new
    return cache
