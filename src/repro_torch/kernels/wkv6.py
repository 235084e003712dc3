"""CUDA kernel wrapper: RWKV6/SSD chunked decayed-outer-product scan.

Port of the Pallas TPU kernel `repro.kernels.wkv6` (`wkv6`,
`_wkv6_kernel`): strict-past outputs, the (K, V) state carried from chunk
to chunk, every decay an exp of a difference of cumulative logs that is
<= 0, so nothing overflows however strong the decay. Unlike the TPU
kernel, T need not be a multiple of the chunk: the kernel zero-fills the
tail of its last chunk (zero r/k/v with logw = 0 leave the state as it
is), which is the reference's zero padding without a copy. The kernel is
`repro_torch/csrc/wkv6.cu`: one block per chunk, all in one launch, each
block handing its chunk's end state to the next through a buffer and a
flag that this wrapper allocates; see its header for the design and its
bound.

The kernel takes all four strides of every input, so broadcast views
(stride 0, as the SSD heads pass k and logw) and transposed views are read
where they lie. `o` keeps v's memory layout where v is dense
(`torch.empty_like`).

Each launch counts under `wkv6.fixed` or `wkv6.generic` (`repro_torch.
obs`, while tracing is on): the build it ran, so a profile shows whether
a path took the faster fixed build.

`wkv6(..., return_states=True)` also returns the chunk start states the
kernel hands from block to block, which `wkv6_bwd` takes to launch the
gradient's kernel (`repro_torch/csrc/wkv6_bwd.cu`, one block per (b, h,
chunk) again, the gradient of each chunk's end state handed back from
block to block): dr, dk, dv, dlogw and ds0 from the inputs, the gradient
of o and (optionally) that of the end state. Its outputs are dense,
whatever the inputs' strides.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.stream import current_stream
from repro_torch.obs import count

# The scan's default chunk length (the reference kernel's too).
DEFAULT_CHUNK = 64
# The (K, V, chunk) that `wkv6_f32` launches through a build fixed at them
# (`csrc/wkv6.cu` `run`): hymba's SSD heads and rwkv6's time mix.
FIXED_BUILDS = ((16, 64, 64), (64, 64, 64))
# Shared memory a block may use on the H100 (227 KB).
MAX_SMEM_BYTES = 232_448
# The backward kernel's register tiles: K, V and the chunk multiples of 4,
# at most 64.
BWD_MAX_DIM = 64


def bwd_smem_bytes(K: int, V: int, chunk: int) -> int:
    """Shared memory of one backward block (`wkv6_bwd.cu`): six (L, K)
    tiles, two (L, V), the (K, V) start state, two (L, L) (the first also
    holding dS later), each row padded by 4 floats, and five (K)
    vectors."""
    L = chunk
    return 4 * (6 * L * (K + 4) + 2 * L * (V + 4) + K * (V + 4)
                + max(L * (L + 4), K * (V + 4)) + L * (L + 4) + 5 * K)


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def build_name(K: int, V: int, chunk: int, generic: bool = False) -> str:
    """The build a forward launch at (K, V, chunk) runs: "fixed" or
    "generic"."""
    return "generic" if generic or (K, V, chunk) not in FIXED_BUILDS \
        else "fixed"


def smem_bytes(K: int, V: int, chunk: int) -> int:
    """Shared memory of one block: three (K, LT) transposed tiles, two
    that hold a (K, LT) tile and later a (K, V) state, the (L, K) staging
    of r, k and logw (later the (L, L) scores), the (L, V) values, the (K)
    total decay and its exp, plus the block's ticket; LT = L + 4 and V
    rounded up to 16 bytes."""
    L, VP, LT = chunk, _round4(V), _round4(chunk) + 4
    raw = max(_round4(3 * L * K), _round4(L) ** 2)
    return 4 * (3 * K * LT + 2 * K * max(LT, VP) + raw + L * VP
                + 2 * _round4(K)) + 16


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         logw: torch.Tensor, s0: torch.Tensor, *,
         chunk: int = DEFAULT_CHUNK, return_states: bool = False,
         generic: bool = False) -> tuple[torch.Tensor, ...]:
    """Launch the kernel on CUDA f32 tensors. r/k/logw: (B, H, T, K); v:
    (B, H, T, V); s0: (B, H, K, V); logw <= 0. Returns (o (B, H, T, V),
    s_final (B, H, K, V)); with `return_states`, also the start states of
    chunks 1 .. n - 1 of the n = ceil(T / chunk), a dense
    (n - 1, B, H, K, V) tensor (`wkv6_bwd` takes it). (K, V, chunk) =
    (16, 64, 64) and (64, 64, 64) launch builds fixed at those sizes;
    `generic` takes the build with sizes from the arguments there too
    (to compare the two)."""
    B, H, T, K, V = _check(r, k, v, logw, s0, "wkv6")
    if chunk < 1 or smem_bytes(K, V, chunk) > MAX_SMEM_BYTES:
        raise ValueError(f"wkv6: (K={K}, V={V}, chunk={chunk}) needs "
                         f"{smem_bytes(K, V, chunk)} B of shared memory; "
                         f"a block has {MAX_SMEM_BYTES}")
    o = torch.empty_like(v)
    s_final = torch.empty((B, H, K, V), dtype=torch.float32, device=r.device)
    # The end state of every chunk but the last (the next one's start), and
    # the flags that publish them (zero on entry), then the kernel's ticket
    # counter.
    n_chunks = -(-T // chunk)
    states = torch.empty((max(n_chunks - 1, 0), B, H, K, V),
                         dtype=torch.float32, device=r.device)
    out = (o, s_final, states) if return_states else (o, s_final)
    if B * H == 0 or K * V == 0:
        return out
    flags = torch.zeros((B * H * n_chunks + 1,), dtype=torch.int32,
                        device=r.device)
    strides = (ctypes.c_int64 * 28)(*(
        s for t in (r, k, v, logw, s0, o, s_final) for s in t.stride()))
    fn = build.entry("wkv6_generic_f32" if generic else "wkv6_f32")
    count("wkv6." + build_name(K, V, chunk, generic))
    build.check(fn(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                   logw.data_ptr(), s0.data_ptr(), o.data_ptr(),
                   s_final.data_ptr(), strides, B, H, T, K, V, chunk,
                   states.data_ptr(), flags.data_ptr(), r.device.index,
                   current_stream(r.device.index)), "wkv6")
    return out


def _check(r, k, v, logw, s0, what: str, extra=()):
    """Raise on inputs the kernels do not take; returns (B, H, T, K, V)."""
    named = (("r", r), ("k", k), ("v", v), ("logw", logw), ("s0", s0),
             *extra)
    for name, t in named:
        if t.device.type != "cuda" or t.device != r.device:
            raise ValueError(f"{what}: {name} must be a CUDA tensor on "
                             f"{r.device}, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32, got {t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{what}: {name} must be 4-D")
    B, H, T, K = r.shape
    V = v.shape[-1]
    if k.shape != r.shape or logw.shape != r.shape \
            or v.shape != (B, H, T, V) or s0.shape != (B, H, K, V):
        raise ValueError(
            f"{what}: expected r/k/logw (B,H,T,K), v (B,H,T,V), s0 "
            f"(B,H,K,V); got {tuple(r.shape)}, {tuple(k.shape)}, "
            f"{tuple(logw.shape)}, {tuple(v.shape)}, {tuple(s0.shape)}")
    return B, H, T, K, V


def wkv6_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             logw: torch.Tensor, s0: torch.Tensor, do: torch.Tensor,
             ds_final: torch.Tensor | None, states: torch.Tensor, *,
             chunk: int = DEFAULT_CHUNK) -> tuple[torch.Tensor, ...]:
    """Launch the backward kernel on CUDA f32 tensors: the inputs of
    `wkv6`, do (B, H, T, V) the gradient of o, ds_final (B, H, K, V) that
    of the end state or None (zero), and the forward's chunk start
    states (`wkv6(..., return_states=True)`). K, V and the chunk are
    multiples of 4, at most BWD_MAX_DIM. Returns dense (dr, dk, dv,
    dlogw, ds0)."""
    extra = (("do", do),) + (() if ds_final is None
                             else (("ds_final", ds_final),))
    B, H, T, K, V = _check(r, k, v, logw, s0, "wkv6_bwd", extra)
    if do.shape != v.shape or (ds_final is not None
                               and ds_final.shape != s0.shape):
        raise ValueError(f"wkv6_bwd: do must be {tuple(v.shape)} and "
                         f"ds_final {tuple(s0.shape)}")
    if any(n % 4 or not 0 < n <= BWD_MAX_DIM for n in (K, V, chunk)):
        raise ValueError(f"wkv6_bwd: K={K}, V={V} and chunk={chunk} must "
                         f"be multiples of 4 in [4, {BWD_MAX_DIM}]")
    n_chunks = -(-T // chunk)
    want = (max(n_chunks - 1, 0), B, H, K, V)
    if states.shape != want or not states.is_contiguous() \
            or states.dtype != torch.float32 or states.device != r.device:
        raise ValueError(f"wkv6_bwd: states must be a dense float32 {want} "
                         f"tensor on {r.device}, got {tuple(states.shape)} "
                         f"{states.dtype} on {states.device}")
    dev = r.device
    dr, dk, dlogw = (torch.empty((B, H, T, K), dtype=torch.float32,
                                 device=dev) for _ in range(3))
    dv = torch.empty((B, H, T, V), dtype=torch.float32, device=dev)
    ds0 = torch.empty((B, H, K, V), dtype=torch.float32, device=dev)
    if T == 0:                           # no step: ds0 is ds_final
        return dr, dk, dv, dlogw, (ds0.zero_() if ds_final is None
                                   else ds0.copy_(ds_final))
    if B * H == 0 or K * V == 0:
        return dr, dk, dv, dlogw, ds0
    # The (dS, dlogw carry) each chunk hands to the one before it, the
    # flags that publish them (zero on entry), then the ticket counter.
    xfer = torch.empty(((n_chunks - 1) * B * H * (K * V + K),),
                       dtype=torch.float32, device=dev)
    flags = torch.zeros((B * H * n_chunks + 1,), dtype=torch.int32,
                        device=dev)
    # Without an end-state gradient the kernel gets a null pointer, and
    # s0's strides fill its slot.
    ds_t = s0 if ds_final is None else ds_final
    strides = (ctypes.c_int64 * 28)(*(
        s for t in (r, k, v, logw, s0, do, ds_t) for s in t.stride()))
    fn = build.entry("wkv6_bwd_f32")
    build.check(fn(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                   logw.data_ptr(), s0.data_ptr(), do.data_ptr(),
                   None if ds_final is None else ds_final.data_ptr(),
                   dr.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                   dlogw.data_ptr(), ds0.data_ptr(), states.data_ptr(),
                   xfer.data_ptr(), flags.data_ptr(), strides, B, H, T, K, V,
                   chunk, dev.index, current_stream(dev.index)), "wkv6_bwd")
    return dr, dk, dv, dlogw, ds0
