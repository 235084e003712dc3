"""Plain PyTorch versions of the kernels (the correctness contract).

`repro_torch.kernels.ops` takes these for tensors that lie on the CPU;
`chip_smoke.py` holds each CUDA kernel against them on the card. Mirrors
`repro.kernels.ref`.
"""
from __future__ import annotations

import torch


def fedagg_ref(x: torch.Tensor, w: torch.Tensor,
               base: torch.Tensor | None = None,
               scale: float = 1.0) -> torch.Tensor:
    """x (K, P), w (K,) -> (P,): sum_k w[k] * x[k] in float32, stored in
    x.dtype. With `base` (P,): base + scale * sum_k w[k] * (x[k] - base)."""
    x32, w32 = x.float(), w.float()[:, None]
    if base is None:
        return (w32 * x32).sum(0).to(x.dtype)
    b32 = base.float()
    return (b32 + scale * (w32 * (x32 - b32)).sum(0)).to(x.dtype)


def prox_sgd_ref(w, g, w0, lr: float, mu: float) -> torch.Tensor:
    """w - lr * (g + mu * (w - w0)) elementwise in float32 (w0 broadcasts)."""
    w32, g32, w032 = w.float(), g.float(), w0.float()
    return (w32 - lr * (g32 + mu * (w32 - w032))).to(w.dtype)


def prox_sgd_masked_ref_(w: torch.Tensor, g: torch.Tensor,
                         w0: torch.Tensor, steps: torch.Tensor, step: int,
                         lr: float, mu: float) -> torch.Tensor:
    """In-place masked client step over a (C, P) buffer: rows with
    `step < steps[c]` take `prox_sgd_ref`, the others keep their bits."""
    live = (step < steps)[:, None]
    return w.copy_(torch.where(live, prox_sgd_ref(w, g, w0, lr, mu), w))
