"""Counts of one layer of the `rwkv` segment kind (rwkv6-1.6b): the time
mix (five token-shift LoRAs of rank 32, the decay LoRA of rank 64, the
r, k, v, g and output projections, `wkv6` with K = V = the head size) and
the channel mix. The functions are those that `hybrid.py` describes."""
from __future__ import annotations

from bench.counts import kernels

MIX_RANK, DECAY_RANK = 32, 64        # RWKV6's two LoRAs


def gemm_mults(model: dict) -> int:
    d, ff = model["d_model"], model["d_ff"]
    return (d * 5 * MIX_RANK + 5 * MIX_RANK * d + d * DECAY_RANK
            + DECAY_RANK * d + 5 * d * d + 2 * d * ff + d * d)


def flops(model: dict, seg: dict, rows: int, seq: int) -> tuple[int, int]:
    d, hd = model["d_model"], model["head_dim"]
    return 0, 16 * rows * (d // hd) * seq * hd * hd


def launches(model: dict, seg: dict, rows: int, seq: int, out: dict) -> None:
    d, hd = model["d_model"], model["head_dim"]
    shape = (rows, d // hd, seq, hd, hd)
    out["wkv6"].append(kernels.wkv6(*shape))
    out["wkv6_bwd"].append(kernels.wkv6_bwd(*shape))


def params(model: dict) -> int:
    """The dry run's count: ~ the time mix, then the channel mix."""
    d = model["d_model"]
    return 5 * d * d + d * 7 * 64 + 64 * d + 2 * d * model["d_ff"] + d * d
