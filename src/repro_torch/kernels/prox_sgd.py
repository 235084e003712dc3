"""CUDA kernel wrapper: fused FedProx client step over a client stack.

    w[c] <- w[c] - lr * (g[c] + mu[c] * (w[c] - w0[a(c)]))
                                              where step < steps[c]

Port of the Pallas TPU kernel `repro.kernels.prox_sgd.prox_sgd`. The
kernel (`repro_torch/csrc/prox_sgd.cu`) updates `w` in place — the
reference returns a new array; in place saves the (C, P) output buffer
and a copy per local step — and leaves masked rows untouched, so a masked
step is an exact no-op. `mu` is one float or, for a batch of scenarios
stacked as rows, an (C,) float32 vector; the anchor is one (P,) vector,
one row per client, or one row per group of C / G rows ((G, P): a
scenario's clients share its global model). It is bound by bytes on the
H100; see the source's header note.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.stream import current_stream

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def prox_sgd(w: torch.Tensor, g: torch.Tensor, w0: torch.Tensor,
             steps: torch.Tensor, step: int, lr: float,
             mu: float | torch.Tensor) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; returns `w`, updated in place.

    w, g: (C, P) contiguous f32 or bf16; w0: (P,) one anchor for every
    client, (C, P) per-client anchors or (G, P) with C % G == 0 (row c
    reads anchor row c // (C / G)), same dtype; steps: (C,) int32 step
    budgets; `step` the local step index; mu: a float or a (C,) float32
    tensor.
    """
    index = w.get_device()
    mu_rows = mu if isinstance(mu, torch.Tensor) else None
    named = [("w", w), ("g", g), ("w0", w0), ("steps", steps)]
    if mu_rows is not None:
        named.append(("mu", mu_rows))
    for name, t in named:
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
    if w0.shape == (P,):
        group = 0                       # one anchor for every row
    elif w0.dim() == 2 and w0.shape[1] == P and w0.shape[0] > 0 \
            and C % w0.shape[0] == 0:
        group = C // w0.shape[0]        # 1: per row
    else:
        raise ValueError(f"prox_sgd: w0 must be (P,), (C, P) or (G, P) "
                         f"with C % G == 0, got {tuple(w0.shape)}")
    if steps.shape != (C,):
        raise ValueError(f"prox_sgd: steps must be ({C},), got "
                         f"{tuple(steps.shape)}")
    if mu_rows is not None and (mu_rows.dtype != torch.float32
                                or mu_rows.shape != (C,)):
        raise ValueError(f"prox_sgd: a mu tensor must be ({C},) float32, "
                         f"got {tuple(mu_rows.shape)} {mu_rows.dtype}")
    if C == 0 or P == 0:
        return w
    suffix = _DTYPES[w.dtype]
    if mu_rows is None and group <= 1:
        # The unextended form: a float mu, a shared or per-client anchor.
        err = build.entry(f"prox_sgd_{suffix}")(
            w.data_ptr(), g.data_ptr(), w0.data_ptr(), 0 if group == 0
            else P, steps.data_ptr(), int(step), C, P, float(lr), float(mu),
            index, current_stream(index))
    else:
        err = build.entry(f"prox_sgd_rows_{suffix}")(
            w.data_ptr(), g.data_ptr(), w0.data_ptr(), group,
            None if mu_rows is None else mu_rows.data_ptr(), steps.data_ptr(),
            int(step), C, P, float(lr), 0.0 if mu_rows is not None
            else float(mu), index, current_stream(index))
    build.check(err, "prox_sgd")
    return w
