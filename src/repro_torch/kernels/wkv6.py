"""CUDA kernel wrapper: RWKV6/SSD chunked decayed-outer-product scan.

Port of the Pallas TPU kernel `repro.kernels.wkv6` (`wkv6`,
`_wkv6_kernel`): strict-past outputs, the (K, V) state carried from chunk
to chunk, every decay an exp of a difference of cumulative logs that is
<= 0, so nothing overflows however strong the decay. Unlike the TPU
kernel, T need not be a multiple of the chunk: the kernel zero-fills the
tail of its last chunk (zero r/k/v with logw = 0 leave the state as it
is), which is the reference's zero padding without a copy. The kernel is
`repro_torch/csrc/wkv6.cu`; see its header for the design and its bound.

The kernel takes all four strides of every input, so broadcast views
(stride 0, as the SSD heads pass k and logw) and transposed views are read
where they lie. `o` keeps v's memory layout where v is dense
(`torch.empty_like`).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# Shared memory a block may use on the H100 (227 KB).
MAX_SMEM_BYTES = 232_448


def smem_bytes(K: int, V: int, chunk: int) -> int:
    """Shared memory of one block: the (K, V) state, four (L, K+1) tiles,
    the (L, V) value tile and the (L, L+1) intra-chunk scores."""
    L = chunk
    return 4 * (K * V + 4 * L * (K + 1) + L * V + L * (L + 1))


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         logw: torch.Tensor, s0: torch.Tensor, *,
         chunk: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on CUDA f32 tensors. r/k/logw: (B, H, T, K); v:
    (B, H, T, V); s0: (B, H, K, V); logw <= 0. Returns (o (B, H, T, V),
    s_final (B, H, K, V))."""
    named = (("r", r), ("k", k), ("v", v), ("logw", logw), ("s0", s0))
    for name, t in named:
        if t.device.type != "cuda" or t.device != r.device:
            raise ValueError(f"wkv6: {name} must be a CUDA tensor on "
                             f"{r.device}, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"wkv6: {name} must be float32, got {t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"wkv6: {name} must be 4-D")
    B, H, T, K = r.shape
    V = v.shape[-1]
    if k.shape != r.shape or logw.shape != r.shape \
            or v.shape != (B, H, T, V) or s0.shape != (B, H, K, V):
        raise ValueError(
            f"wkv6: expected r/k/logw (B,H,T,K), v (B,H,T,V), s0 (B,H,K,V); "
            f"got {tuple(r.shape)}, {tuple(k.shape)}, {tuple(logw.shape)}, "
            f"{tuple(v.shape)}, {tuple(s0.shape)}")
    if chunk < 1 or smem_bytes(K, V, chunk) > MAX_SMEM_BYTES:
        raise ValueError(f"wkv6: (K={K}, V={V}, chunk={chunk}) needs "
                         f"{smem_bytes(K, V, chunk)} B of shared memory; "
                         f"a block has {MAX_SMEM_BYTES}")
    o = torch.empty_like(v)
    s_final = torch.empty((B, H, K, V), dtype=torch.float32, device=r.device)
    if B * H == 0 or K * V == 0:
        return o, s_final
    strides = (ctypes.c_int64 * 28)(*(
        s for t in (r, k, v, logw, s0, o, s_final) for s in t.stride()))
    fn = build.library().wkv6_f32
    stream = torch.cuda.current_stream(r.device).cuda_stream
    build.check(fn(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                   logw.data_ptr(), s0.data_ptr(), o.data_ptr(),
                   s_final.data_ptr(), strides, B, H, T, K, V, chunk,
                   r.device.index, stream), "wkv6")
    return o, s_final
