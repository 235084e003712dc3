"""CUDA kernel wrapper: fused FedProx client step over a client stack.

    w[c] <- w[c] - lr * (g[c] + mu * (w[c] - w0[c]))   where step < steps[c]

Port of the Pallas TPU kernel `repro.kernels.prox_sgd.prox_sgd`. The
kernel (`repro_torch/csrc/prox_sgd.cu`) updates `w` in place — the
reference returns a new array; in place saves the (C, P) output buffer
and a copy per local step — and leaves masked rows untouched, so a masked
step is an exact no-op. It is bound by bytes on the H100; see the
source's header note.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.stream import current_stream

_DTYPES = {torch.float32: "prox_sgd_f32", torch.bfloat16: "prox_sgd_bf16"}


def prox_sgd(w: torch.Tensor, g: torch.Tensor, w0: torch.Tensor,
             steps: torch.Tensor, step: int, lr: float,
             mu: float) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; returns `w`, updated in place.

    w, g: (C, P) contiguous f32 or bf16; w0: (C, P) per-client anchors or
    one (P,) anchor broadcast to every client, same dtype; steps: (C,)
    int32 step budgets; `step` the local step index.
    """
    index = w.get_device()
    for name, t in (("w", w), ("g", g), ("w0", w0), ("steps", steps)):
        if not t.is_cuda or t.get_device() != index:
            raise ValueError(f"prox_sgd: {name} must be a CUDA tensor on "
                             f"{w.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"prox_sgd: {name} must be contiguous")
    if w.dtype not in _DTYPES:
        raise TypeError(f"prox_sgd: dtype {w.dtype} not supported "
                        "(float32 or bfloat16)")
    if g.dtype != w.dtype or w0.dtype != w.dtype:
        raise TypeError("prox_sgd: w, g and w0 must share one dtype")
    if steps.dtype != torch.int32:
        raise TypeError("prox_sgd: steps must be int32")
    if w.dim() != 2 or g.shape != w.shape:
        raise ValueError(f"prox_sgd: w and g must be (C, P), got "
                         f"{tuple(w.shape)} and {tuple(g.shape)}")
    C, P = w.shape
    if w0.shape == w.shape:
        w0_stride = P
    elif w0.shape == (P,):
        w0_stride = 0
    else:
        raise ValueError(f"prox_sgd: w0 must be (C, P) or (P,), got "
                         f"{tuple(w0.shape)}")
    if steps.shape != (C,):
        raise ValueError(f"prox_sgd: steps must be ({C},), got "
                         f"{tuple(steps.shape)}")
    if C == 0 or P == 0:
        return w
    build.check(build.entry(_DTYPES[w.dtype])(
        w.data_ptr(), g.data_ptr(), w0.data_ptr(), w0_stride,
        steps.data_ptr(), int(step), C, P, float(lr), float(mu), index,
        current_stream(index)), "prox_sgd")
    return w
