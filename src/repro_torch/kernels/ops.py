"""Dispatch for the port's kernels, with launch counters.

A tensor on the CPU takes the kernel's plain PyTorch version
(`repro_torch.kernels.ref`); any other tensor goes to the CUDA kernel,
which launches or raises — there is no fallback. `LAUNCHES` counts kernel
launches (and only those), so a run can show that its main path went
through the kernels. Port of `repro.kernels.ops`: the simulator's two
kernels (`fedagg`, `prox_sgd`) and the LM's two (`flash_attention`,
`wkv6`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.fedagg import fedagg
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.prox_sgd import prox_sgd
from repro_torch.kernels.wkv6 import wkv6

LAUNCHES = {"fedagg": 0, "prox_sgd": 0, "flash_attention": 0, "wkv6": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def fedagg_op(x: torch.Tensor, w: torch.Tensor,
              base: torch.Tensor | None = None,
              scale: float | torch.Tensor = 1.0) -> torch.Tensor:
    """sum_k w[k] * x[k] over (K, P), or its delta form against `base`;
    over (S, K, P) with a leading scenario axis (w (S, K), base (S, P),
    scale an (S,) float32 tensor), one launch for every scenario."""
    if x.device.type == "cpu":
        if x.dim() == 3:
            return ref.fedagg_batched_ref(x, w, base, scale)
        return ref.fedagg_ref(x, w, base, scale)
    out = fedagg(x, w, base, scale)
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


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       *, causal: bool = True, window: int | None = None,
                       softcap: float | None = None) -> torch.Tensor:
    """GQA attention over positions 0..S-1: q (B, H, S, D), k/v
    (B, KV, S, D) -> (B, H, S, D). The kernel's tiles are fixed, so the
    reference's `bq`/`bk` have no counterpart."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal, window, softcap)
    out = flash_attention(q, k, v, causal=causal, window=window,
                          softcap=softcap)
    LAUNCHES["flash_attention"] += 1
    return out


def wkv6_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            logw: torch.Tensor, s0: torch.Tensor, *,
            chunk: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """Strict-past chunked decay scan -> (o (B, H, T, V), s_final)."""
    if r.device.type == "cpu":
        return ref.wkv6_ref(r, k, v, logw, s0, chunk)
    out = wkv6(r, k, v, logw, s0, chunk=chunk)
    LAUNCHES["wkv6"] += 1
    return out


__all__ = ["LAUNCHES", "reset_launches", "fedagg_op", "flash_attention_op",
           "prox_sgd_op", "wkv6_op", "ref"]
