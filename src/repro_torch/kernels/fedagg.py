"""CUDA kernel wrapper: federated weighted aggregation (paper Eq. 1).

    out[p] = sum_k w[k] * x[k, p]
    out[p] = base[p] + scale * sum_k w[k] * (x[k, p] - base[p])   (with base)
    out[p] = sum_k w[k] * (x[k, p] - base[p])          (with base, partial)

Port of the Pallas TPU kernel `repro.kernels.fedagg.fedagg`, plus the
delta form that `weighted_delta_update` (FedBuff) needs, in the same
single pass, the partial form that one rank of a mesh round contributes
to the all-reduce of `masked_delta_allreduce` (its block's weighted
deltas, the base not added back), and a batched form over a leading
scenario axis (x (S, K, P), w (S, K), base (S, P), a per-scenario scale
(S,)) that aggregates a whole batch of scenarios in one launch. The kernel is
`repro_torch/csrc/fedagg.cu`; it is bound by bytes on the H100 (see the
source's header note).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.stream import current_stream

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _check(x: torch.Tensor, named: list) -> int:
    index = x.get_device()
    for name, t in named:
        if not t.is_cuda or t.get_device() != index:
            raise ValueError(f"fedagg: {name} must be a CUDA tensor on "
                             f"{x.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"fedagg: {name} must be contiguous")
    if x.dtype not in _DTYPES:
        raise TypeError(f"fedagg: dtype {x.dtype} not supported "
                        "(float32 or bfloat16)")
    return index


def fedagg(x: torch.Tensor, w: torch.Tensor,
           base: torch.Tensor | None = None,
           scale: float | torch.Tensor = 1.0,
           partial: bool = False) -> torch.Tensor:
    """Launch the kernel on CUDA tensors. x: (K, P) contiguous f32 or
    bf16; w: (K,) f32; base: optional (P,) in x's dtype; `partial` (with
    a base) leaves the base and `scale` out. Returns (P,) in x's dtype,
    accumulated in f32. With a leading scenario axis — x (S, K, P), w
    (S, K), base (S, P), scale an (S,) float32 tensor — returns (S, P)."""
    if partial and base is None:
        raise ValueError("fedagg: the partial form needs a base")
    if x.dim() == 3:
        if partial:
            raise ValueError("fedagg: no partial form over a scenario axis")
        return fedagg_batched(x, w, base, scale)
    named = [("x", x), ("w", w)] + ([("base", base)] if base is not None
                                    else [])
    index = _check(x, named)
    if w.dtype != torch.float32:
        raise TypeError("fedagg: weights must be float32")
    if x.dim() != 2:
        raise ValueError(f"fedagg: x must be (K, P) or (S, K, P), got "
                         f"{tuple(x.shape)}")
    K, P = x.shape
    if w.shape != (K,):
        raise ValueError(f"fedagg: w must be ({K},), got {tuple(w.shape)}")
    if base is not None and (base.shape != (P,) or base.dtype != x.dtype):
        raise ValueError(f"fedagg: base must be ({P},) {x.dtype}, got "
                         f"{tuple(base.shape)} {base.dtype}")
    out = torch.empty((P,), dtype=x.dtype, device=x.device)
    if P == 0:
        return out
    build.check(build.entry(f"fedagg_{_DTYPES[x.dtype]}")(
        x.data_ptr(), w.data_ptr(), None if base is None else base.data_ptr(),
        float(scale), int(partial), out.data_ptr(), K, P, index,
        current_stream(index)), "fedagg")
    return out


def fedagg_batched(x: torch.Tensor, w: torch.Tensor,
                   base: torch.Tensor | None = None,
                   scale: float | torch.Tensor = 1.0) -> torch.Tensor:
    """The batched form: x (S, K, P), w (S, K) f32, base (S, P) and scale
    (S,) f32, or base None (scale unused) -> (S, P)."""
    S, K, P = x.shape
    if base is not None and not (isinstance(scale, torch.Tensor)
                                 and scale.shape == (S,)
                                 and scale.dtype == torch.float32):
        raise ValueError(f"fedagg: scale must be an ({S},) float32 tensor, "
                         f"got {scale!r}")
    named = [("x", x), ("w", w)] + ([("base", base), ("scale", scale)]
                                    if base is not None else [])
    index = _check(x, named)
    if w.dtype != torch.float32 or w.shape != (S, K):
        raise ValueError(f"fedagg: w must be ({S}, {K}) float32, got "
                         f"{tuple(w.shape)} {w.dtype}")
    if base is not None and (base.shape != (S, P)
                             or base.dtype != x.dtype):
        raise ValueError(f"fedagg: base must be ({S}, {P}) {x.dtype}, got "
                         f"{tuple(base.shape)} {base.dtype}")
    out = torch.empty((S, P), dtype=x.dtype, device=x.device)
    if S == 0 or P == 0:
        return out
    build.check(build.entry(f"fedagg_batched_{_DTYPES[x.dtype]}")(
        x.data_ptr(), w.data_ptr(),
        None if base is None else base.data_ptr(),
        None if base is None else scale.data_ptr(), out.data_ptr(), S, K, P,
        index, current_stream(index)), "fedagg")
    return out
