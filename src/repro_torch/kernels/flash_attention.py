"""CUDA kernel wrapper: flash attention (causal / sliding-window /
softcapped GQA) of S queries at positions 0..S-1 against Sk keys at
0..Sk-1, with values of head dim Dv, which may differ from the queries'
and keys' D (MLA). Sk = S but for cross-attention (whisper's decoder
against its encoder's frames), which takes no mask: a causal or windowed
call at Sk != S raises, since what such a mask means across two lengths
is not defined by the reference.

Port of the Pallas TPU kernel `repro.kernels.flash_attention`
(`flash_attention`, `_flash_kernel`): online-softmax attention with f32
running max, denominator (clamped at 1e-30) and accumulator; tiles that
no query row of a block can reach are skipped. Unlike the TPU kernel, S
need not be a multiple of a block size: the tail tile is masked. The
kernel is `repro_torch/csrc/flash_attention.cu`; see its header for the
design and what bounds it on the H100.

The kernel takes strides for the batch, head and sequence axes (the head
dim must be contiguous), so the model's (B, S, H, D) tensors go in as
transposed views, and the output keeps q's memory layout (its (B, H, S)
axes in q's order where Dv differs from D). The bf16 kernel loads rows
with 16-byte copies, so a bf16 input whose rows do not start on 16 bytes
is copied first.

`flash_attention(..., return_lse=True)` also returns each row's
log-sum-exp, which `flash_attention_bwd` takes to launch the gradient's
kernels (`repro_torch/csrc/flash_attention_bwd.cu`): dq, dk, dv from q,
k, v, the forward's output, its lse and the output's gradient, with the
same masks and strides.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.stream import current_stream

_DTYPES = {torch.float32: "flash_attention_f32",
           torch.bfloat16: "flash_attention_bf16"}
# (D, Dv) pairs per input type, D the head dim of q and k and Dv that of
# v and o: (D, D) for GQA, and MLA's (192, 128) (deepseek-v3) and
# (96, 64) (its reduced form, lm_moe_tiny). The bf16 kernels' wgmma tiles
# are 64 columns wide, so D = 32 (lm_tiny) and D = 96 take the f32
# kernels only.
HEAD_DIM_PAIRS = {
    torch.float32: ((32, 32), (64, 64), (128, 128), (256, 256), (96, 64),
                    (192, 128)),
    torch.bfloat16: ((64, 64), (128, 128), (256, 256), (192, 128))}
# The backward's: the forward's pairs (D = 96 takes the f32 kernels only).
BWD_HEAD_DIM_PAIRS = {
    torch.float32: HEAD_DIM_PAIRS[torch.float32],
    torch.bfloat16: ((64, 64), (128, 128), (256, 256), (192, 128))}
_BWD_ENTRIES = {torch.float32: "flash_attention_bwd_f32",
                torch.bfloat16: "flash_attention_bwd_bf16"}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None, return_lse: bool = False):
    """Launch the kernel on CUDA tensors. q: (B, H, S, D); k: (B, KV, Sk,
    D) and v: (B, KV, Sk, Dv) with H % KV == 0 and Sk >= 1 (Sk = S where
    `causal` or `window` is set); one dtype, f32 or bf16; (D, Dv) in
    HEAD_DIM_PAIRS of that dtype; the scale is D^-1/2. A (q, k) pair
    counts if `kpos <= qpos` (causal) and `qpos - kpos < window`. Returns
    (B, H, S, Dv) in q's dtype and memory layout; with `return_lse`, also
    each row's log-sum-exp, a dense (B, H, S) float32 tensor."""
    B, H, S, D, KV, Dv, Sk = _check(q, k, v, HEAD_DIM_PAIRS, causal, window,
                                    softcap, "flash_attention")
    out = _empty_like(q, Dv)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if out.numel() > 0:
        if q.dtype == torch.bfloat16:
            q, k, v = (_aligned(t) for t in (q, k, v))
        strides = (ctypes.c_int64 * 12)(*(
            s for t in (q, k, v, out) for s in t.stride()[:3]))
        fn = build.entry(_DTYPES[q.dtype])
        build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), None if lse is None else lse.data_ptr(),
                       strides, B, H, KV, S, Sk, D, Dv, float(D ** -0.5),
                       int(causal), int(window or 0), float(softcap or 0.0),
                       q.device.index, current_stream(q.device.index)),
                    "flash_attention")
    return (out, lse) if return_lse else out


def _empty_like(q: torch.Tensor, width: int) -> torch.Tensor:
    """An empty (B, H, S, width) tensor with q's dtype and device, its
    (B, H, S) axes in the memory order of q's (so that the model's
    transposed views give an output that reshapes without a copy)."""
    if width == q.shape[-1]:
        return torch.empty_like(q)
    order = sorted(range(3), key=lambda i: (-q.stride(i), i))
    out = torch.empty([q.shape[i] for i in order] + [width], dtype=q.dtype,
                      device=q.device)
    return out.permute(*[order.index(i) for i in range(3)], 3)


def _check(q, k, v, pairs, causal, window, softcap, what: str):
    """Raise on inputs the kernels do not take; returns (B, H, S, D, KV,
    Dv, Sk)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{what}: {name} must be a CUDA tensor on "
                             f"{q.device}, got {t.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{what}: q, k and v must share one dtype")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"{what}: {name} must be 4-D with a contiguous "
                             "last axis")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {q.dtype} not supported (float32 or "
                        "bfloat16)")
    B, H, S, D = q.shape
    KV, Sk, Dv = k.shape[1], k.shape[2], v.shape[-1]
    if k.shape != (B, KV, Sk, D) or v.shape != (B, KV, Sk, Dv) or Sk < 1:
        raise ValueError(f"{what}: k must be ({B}, KV, Sk, {D}) and v "
                         f"({B}, KV, Sk, Dv) with Sk >= 1, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if Sk != S and (causal or window is not None):
        raise ValueError(f"{what}: keys of their own length ({Sk} against "
                         f"{S} queries) take no causal or window mask")
    if KV == 0 or H % KV:
        raise ValueError(f"{what}: H = {H} is not a multiple of KV = {KV}")
    if (D, Dv) not in pairs[q.dtype]:
        raise ValueError(f"{what}: head dim {D} (values {Dv}) not in the "
                         f"(D, Dv) pairs {pairs[q.dtype]} for {q.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"{what}: window must be >= 1, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"{what}: softcap must be > 0, got {softcap}")
    return B, H, S, D, KV, Dv, Sk


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                        *, causal: bool = True, window: int | None = None,
                        softcap: float | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernels (`csrc/flash_attention_bwd.cu`) on CUDA
    tensors: q, k, v as for `flash_attention`, o its output, do the
    gradient of o (both (B, H, S, Dv), q's dtype) and lse the forward's
    (`return_lse`; dense (B, H, S) float32). Returns (dq, dk, dv) in the
    input dtype, each in its input's memory layout (dk and dv of the keys'
    length Sk). (D, Dv) in
    BWD_HEAD_DIM_PAIRS of that dtype: in bf16, (D, D) at D in {64, 128,
    256} and deepseek-v3's (192, 128); any other pair raises."""
    B, H, S, D, KV, Dv, Sk = _check(q, k, v, BWD_HEAD_DIM_PAIRS, causal,
                                    window, softcap, "flash_attention_bwd")
    for name, t in (("o", o), ("do", do)):
        if t.shape != (B, H, S, Dv) or t.dtype != q.dtype \
                or t.device != q.device or t.stride(-1) != 1:
            raise ValueError(f"flash_attention_bwd: {name} must be "
                             f"({B}, {H}, {S}, {Dv}), {q.dtype} on "
                             f"{q.device}, with a contiguous last axis")
    if lse.shape != (B, H, S) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd: lse must be a contiguous "
                         f"({B}, {H}, {S}) float32 tensor on {q.device}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0:                   # no query reaches a key
        return dq, dk.zero_(), dv.zero_()
    if q.dtype == torch.bfloat16:
        q, k, v, o, do = (_aligned(t) for t in (q, k, v, o, do))
    # dO . O per row: computed by the dq kernel, read by the dk/dv kernel.
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 24)(*(
        s for t in (q, k, v, o, do, dq, dk, dv) for s in t.stride()[:3]))
    fn = build.entry(_BWD_ENTRIES[q.dtype])
    build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                   do.data_ptr(), lse.data_ptr(), dq.data_ptr(),
                   dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), strides,
                   B, H, KV, S, Sk, D, Dv, float(D ** -0.5), int(causal),
                   int(window or 0), float(softcap or 0.0), q.device.index,
                   current_stream(q.device.index)),
                "flash_attention_bwd")
    return dq, dk, dv


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a dense copy where a (b, h, s) row of t does not start on 16
    bytes (the bf16 tensor-core kernels load rows with 16-byte copies)."""
    if t.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in t.stride()[:3]):
        return t
    return t.clone(memory_format=torch.contiguous_format)
