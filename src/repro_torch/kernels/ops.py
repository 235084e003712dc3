"""Dispatch for the port's kernels, with launch counters.

A tensor on the CPU takes the kernel's plain PyTorch version
(`repro_torch.kernels.ref`); any other tensor goes to the CUDA kernel,
which launches or raises — there is no fallback. `LAUNCHES` counts kernel
launches (and only those), so a run can show that its main path went
through the kernels. Port of `repro.kernels.ops`: the simulator's two
kernels (`fedagg`, `prox_sgd`) and the LM's two (`flash_attention`,
`wkv6`).

`flash_attention_op` and `wkv6_op` are differentiable
(`torch.autograd.Function`): their backward is a kernel too
(`flash_attention_bwd`, `wkv6_bwd`, counted under those names), or on
the CPU the plain backward of `ref`, the kernel's own formulas written
out (not autograd of the plain forward). Where a gradient is wanted the
forward keeps what the backward would otherwise recompute: each
attention row's log-sum-exp, and each scan chunk's start state. The
reference has no backward kernel: it differentiates its jnp attention
and scan.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.fedagg import fedagg
from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_bwd,
)
from repro_torch.kernels.prox_sgd import prox_sgd
from repro_torch.kernels.wkv6 import wkv6, wkv6_bwd

LAUNCHES = {"fedagg": 0, "prox_sgd": 0, "flash_attention": 0, "wkv6": 0,
            "flash_attention_bwd": 0, "wkv6_bwd": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def fedagg_op(x: torch.Tensor, w: torch.Tensor,
              base: torch.Tensor | None = None,
              scale: float | torch.Tensor = 1.0,
              partial: bool = False) -> torch.Tensor:
    """sum_k w[k] * x[k] over (K, P), or its delta form against `base`
    (with `partial`, its weighted deltas alone: a mesh rank's share of
    the round); over (S, K, P) with a leading scenario axis (w (S, K),
    base (S, P), scale an (S,) float32 tensor), one launch for every
    scenario."""
    if x.device.type == "cpu":
        if x.dim() == 3:
            return ref.fedagg_batched_ref(x, w, base, scale)
        return ref.fedagg_ref(x, w, base, scale, partial)
    out = fedagg(x, w, base, scale, partial)
    LAUNCHES["fedagg"] += 1
    return out


def prox_sgd_op(w: torch.Tensor, g: torch.Tensor, w0: torch.Tensor,
                steps: torch.Tensor, step: int, lr: float,
                mu: float | torch.Tensor) -> torch.Tensor:
    """In-place masked proximal SGD step over a (C, P) client stack; `mu`
    a float or a (C,) tensor, `w0` (P,), (C, P) or (G, P) anchors (row c
    reads row c // (C / G))."""
    if w.device.type == "cpu":
        if isinstance(mu, torch.Tensor) or (
                w0.dim() == 2 and w0.shape[0] not in (1, w.shape[0])):
            return ref.prox_sgd_rows_ref_(w, g, w0, steps, step, lr, mu)
        return ref.prox_sgd_masked_ref_(w, g, w0, steps, step, lr, mu)
    prox_sgd(w, g, w0, steps, step, lr, mu)
    LAUNCHES["prox_sgd"] += 1
    return w


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        keep = any(ctx.needs_input_grad[:3])     # lse, for the backward
        if q.device.type == "cpu":
            out = ref.flash_attention_ref(q, k, v, causal, window, softcap,
                                          return_lse=keep)
        else:
            out = flash_attention(q, k, v, causal=causal, window=window,
                                  softcap=softcap, return_lse=keep)
            LAUNCHES["flash_attention"] += 1
        o, lse = out if keep else (out, None)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.masks = (causal, window, softcap)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, softcap = ctx.masks
        if q.device.type == "cpu":
            dq, dk, dv = ref.flash_attention_bwd_ref(q, k, v, o, do,
                                                     *ctx.masks, lse=lse)
        else:
            if do.stride(-1) != 1:
                do = do.contiguous()
            dq, dk, dv = flash_attention_bwd(q, k, v, o, do, lse,
                                             causal=causal, window=window,
                                             softcap=softcap)
            LAUNCHES["flash_attention_bwd"] += 1
        return dq, dk, dv, None, None, None


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       *, causal: bool = True, window: int | None = None,
                       softcap: float | None = None) -> torch.Tensor:
    """GQA attention of queries at positions 0..S-1 against keys at
    0..Sk-1: q (B, H, S, D), k (B, KV, Sk, D), v (B, KV, Sk, Dv) -> (B,
    H, S, Dv), Dv = D or MLA's smaller value head dim; Sk = S but for
    cross-attention, which takes no mask. The kernel's tiles are fixed,
    so the reference's `bq`/`bk` have no counterpart. Differentiable (dk
    and dv of the keys' length)."""
    return _FlashAttention.apply(q, k, v, causal, window, softcap)


class _Wkv6(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, logw, s0, chunk):
        # Each chunk's start state, for the backward (13 MB a layer at
        # full-width hymba-1.5b, batch 2 x 2048).
        keep = any(ctx.needs_input_grad[:5])
        if r.device.type == "cpu":
            out = ref.wkv6_ref(r, k, v, logw, s0, chunk, return_states=keep)
        else:
            out = wkv6(r, k, v, logw, s0, chunk=chunk, return_states=keep)
            LAUNCHES["wkv6"] += 1
        o, s_final, *states = out
        ctx.save_for_backward(r, k, v, logw, s0, *states)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return o, s_final

    @staticmethod
    def backward(ctx, do, ds_final):
        r, k, v, logw, s0, states = ctx.saved_tensors
        if do is None:
            do = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        if r.device.type == "cpu":
            grads = ref.wkv6_bwd_ref(r, k, v, logw, s0, do, ds_final,
                                     ctx.chunk, states)
        else:
            grads = wkv6_bwd(r, k, v, logw, s0, do, ds_final, states,
                             chunk=ctx.chunk)
            LAUNCHES["wkv6_bwd"] += 1
        return (*grads, None)


def wkv6_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            logw: torch.Tensor, s0: torch.Tensor, *,
            chunk: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """Strict-past chunked decay scan -> (o (B, H, T, V), s_final).
    Differentiable in every input (broadcast views too: autograd sums the
    dense gradients back over their expanded axes)."""
    return _Wkv6.apply(r, k, v, logw, s0, chunk)


__all__ = ["LAUNCHES", "reset_launches", "fedagg_op", "flash_attention_op",
           "prox_sgd_op", "wkv6_op", "ref"]
