"""Dispatch for the port's kernels, with launch counters.

A tensor on the CPU takes the kernel's plain PyTorch version
(`repro_torch.kernels.ref`); any other tensor goes to the CUDA kernel,
which launches or raises — there is no fallback. `LAUNCHES` counts kernel
launches (and only those), so a run can show that its main path went
through the kernels. Port of `repro.kernels.ops` for the simulator's two
kernels; `flash_attention` and `wkv6` are not ported yet (ROADMAP).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.fedagg import fedagg
from repro_torch.kernels.prox_sgd import prox_sgd

LAUNCHES = {"fedagg": 0, "prox_sgd": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def fedagg_op(x: torch.Tensor, w: torch.Tensor,
              base: torch.Tensor | None = None,
              scale: float = 1.0) -> torch.Tensor:
    """sum_k w[k] * x[k] over (K, P), or its delta form against `base`."""
    if x.device.type == "cpu":
        return ref.fedagg_ref(x, w, base, scale)
    out = fedagg(x, w, base, scale)
    LAUNCHES["fedagg"] += 1
    return out


def prox_sgd_op(w: torch.Tensor, g: torch.Tensor, w0: torch.Tensor,
                steps: torch.Tensor, step: int, lr: float,
                mu: float) -> torch.Tensor:
    """In-place masked proximal SGD step over a (C, P) client stack."""
    if w.device.type == "cpu":
        return ref.prox_sgd_masked_ref_(w, g, w0, steps, step, lr, mu)
    prox_sgd(w, g, w0, steps, step, lr, mu)
    LAUNCHES["prox_sgd"] += 1
    return w


__all__ = ["LAUNCHES", "reset_launches", "fedagg_op", "prox_sgd_op", "ref"]
