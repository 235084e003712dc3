"""Operations and bytes of the port's kernels at their launched shapes,
and the least time they allow: the yardstick of the `*.roofline` metrics.

A frozen copy of the arithmetic of `chip_smoke.py` (`bound_ms`,
`_flash_pairs`, and the counts in `check_flash`, `check_flash_bwd`,
`check_wkv6` and `check_wkv6_bwd`, as of the tree that wrote this
benchmark), kept here so that no later change of the program moves it.
Each input byte is counted read once (a broadcast input's distinct
elements) and each output byte written once; operations are what the
algorithm needs, not what a kernel recomputes.

`KERNELS` maps each metric's kernel to the device kernel names that the
program's CUDA sources define (`csrc/*.cu`), as they appear in a
profiler trace.
"""
from __future__ import annotations

import importlib
import json
from pathlib import Path

import numpy as np

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())

KERNELS = {
    "flash_attention": ("flash_bf16_kernel", "flash_f32_kernel"),
    "flash_attention_bwd": ("flash_bwd_dq_tc", "flash_bwd_dkdv_tc",
                            "flash_bwd_dq_kernel", "flash_bwd_dkdv_kernel"),
    "wkv6": ("wkv6_chunk_kernel",),
    "wkv6_bwd": ("wkv6_bwd_kernel",),
}


def family(name: str) -> str | None:
    """The kernel (a key of KERNELS) whose device kernel `name` is."""
    for kernel, names in KERNELS.items():
        if any(n in name for n in names):
            return kernel
    return None


def bound_s(n_bytes: float, n_flops: float, flops_per_s: float) -> float:
    """The least time: the larger of bytes over HBM bandwidth and
    operations over the peak rate."""
    return max(n_bytes / PEAKS["hbm_bytes_per_s"], n_flops / flops_per_s)


def flash_pairs(S: int, causal: bool, window: int | None,
                Sk: int | None = None) -> int:
    """(q, k) pairs that the masks leave, queries at 0..S-1 and keys at
    0..Sk-1 (Sk = S unless given: cross-attention, with no mask)."""
    if Sk is not None and Sk != S:
        return S * Sk
    q = np.arange(S)
    lo = np.maximum(0, q - window + 1) if window else np.zeros(S, np.int64)
    hi = q + 1 if causal else np.full(S, S)
    return int((hi - lo).sum())


def _flops_rate(dtype: str) -> float:
    return PEAKS["bf16_flops_per_s"] if dtype == "bfloat16" \
        else PEAKS["f32_flops_per_s"]


def flash_attention(B, H, KV, S, D, Dv, dtype, causal=True, window=None,
                    Sk=None) -> float:
    """Least seconds of one forward launch."""
    Sk = Sk or S
    pairs = B * H * flash_pairs(S, causal, window, Sk)
    item = 2 if dtype == "bfloat16" else 4
    n_bytes = (B * H * S + B * KV * Sk) * (D + Dv) * item
    # q.k (2 D flops) and p v (2 Dv) a counted pair.
    return bound_s(n_bytes, 2 * (D + Dv) * pairs, _flops_rate(dtype))


def flash_attention_bwd(B, H, KV, S, D, Dv, dtype, causal=True,
                        window=None, Sk=None) -> float:
    """Least seconds of one backward launch (dq, dk, dv)."""
    Sk = Sk or S
    pairs = B * H * flash_pairs(S, causal, window, Sk)
    item = 2 if dtype == "bfloat16" else 4
    # q, k, dq, dk of D columns; v, o, dO, dv of Dv; lse.
    n_bytes = (2 * (B * H * S + B * KV * Sk) * (D + Dv) * item
               + B * H * S * 4)
    # Q K^T, dS K, dS^T Q over D; dO V^T, P^T dO over Dv.
    return bound_s(n_bytes, 2 * (3 * D + 2 * Dv) * pairs, _flops_rate(dtype))


def _wkv6_inputs(B, H, T, K, V, shared_k: bool, shared_decay: bool) -> int:
    """Distinct f32 elements of r, k, v, logw and s0 as the model passes
    them: the SSD heads share k over heads and their decay over the state
    dim (broadcast views); RWKV6's are dense."""
    k = B * T * K if shared_k else B * H * T * K
    logw = B * T * H if shared_decay else B * H * T * K
    return B * H * T * K + k + B * H * T * V + logw + B * H * K * V


def wkv6(B, H, T, K, V, shared_k=False, shared_decay=False) -> float:
    """Least seconds of one forward launch: inputs read once, o and the
    final state written once; o = r.S (2 K V) and S = w S + k v^T (3 K V)
    a step."""
    n_bytes = (_wkv6_inputs(B, H, T, K, V, shared_k, shared_decay)
               + B * H * T * V + B * H * K * V) * 4
    return bound_s(n_bytes, 5 * B * H * T * K * V, PEAKS["f32_flops_per_s"])


def wkv6_bwd(B, H, T, K, V, shared_k=False, shared_decay=False) -> float:
    """Least seconds of one backward launch: the forward's inputs and dO
    read once, dense dr, dk, dv, dlogw and ds0 written once (the chunk
    states it reads are not counted: they can be recomputed); the state
    recurrence (3 K V) and its gradients (dS 3, dr 2, dk 2, dv 2, dlogw 2
    K V) a step."""
    n_in = _wkv6_inputs(B, H, T, K, V, shared_k, shared_decay) \
        + B * H * T * V
    n_out = 3 * B * H * T * K + B * H * T * V + B * H * K * V
    return bound_s((n_in + n_out) * 4, 14 * B * H * T * K * V,
                   PEAKS["f32_flops_per_s"])


def kind(name: str):
    """The counts of the segment kind `name`: `bench/counts/kinds/<name>
    .py`. A kind with no file raises: its layers would be counted as
    some other kind's."""
    try:
        return importlib.import_module(f"bench.counts.kinds.{name}")
    except ModuleNotFoundError as e:
        raise ValueError(f"no counts for the segment kind {name!r}: add "
                         f"bench/counts/kinds/{name}.py") from e


def launches(model: dict, rows: int, seq: int) -> dict:
    """The launches of one local step (forward and backward) of a model
    of the configuration file's "model" section on (rows, seq) tokens:
    {kernel: [least seconds of each launch]}."""
    out = {k: [] for k in KERNELS}
    for seg in model["segments"]:
        counts = kind(seg["kind"])
        for _ in range(seg["n_layers"]):
            counts.launches(model, seg, rows, seq, out)
    return out


def roofline_pct(obs: dict, kernel: str) -> float | None:
    """`kernel`'s share of its roofline in the profiled round, in %: the
    least time of its launches (each local step's, as `launches` counts
    them from the configuration) over the device time of its kernels in
    the trace. None where the trace holds none of its kernels, or where
    the program's launch counter disagrees with the count."""
    per_step = obs["launch_bounds"][kernel]
    counted = obs["launches"].get(kernel, 0)
    device_s = sum(s for name, s in obs["trace"]["kernel_s"].items()
                   if family(name) == kernel)
    if not per_step or device_s <= 0:
        return None
    if counted != len(per_step) * obs["local_steps"]:
        return None
    return 100.0 * sum(per_step) * obs["local_steps"] / device_s
