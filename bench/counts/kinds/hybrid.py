"""Counts of one layer of the `hybrid` segment kind (hymba-1.5b): grouped
-query attention with rotary positions under the segment's causal window
(`flash_attention`), SSD heads beside it (`wkv6` with K = the state size,
the input shared by the heads), and a SwiGLU or GeGLU MLP.

Each kind's file gives, for one layer of its segment kind:
  gemm_mults(model)              multiply-adds of its weight products a
                                 token, forward
  flops(model, seg, rows, seq)   (attention, scan) FLOPs, forward and
                                 backward, on (rows, seq) tokens
  launches(model, seg, rows, seq, out)   each kernel launch's least
                                 seconds, forward and backward, appended
                                 to out[kernel]
  params(model)                  parameters
and raises on a feature of the configuration that it does not count.
"""
from __future__ import annotations

from bench.counts import kernels


def _check(model: dict) -> None:
    for key in ("mla", "moe", "n_experts"):
        if model.get(key):
            raise ValueError(f"the hybrid counts do not count {key!r}")
    if model.get("mlp", "swiglu") not in ("swiglu", "geglu"):
        raise ValueError(f"the hybrid counts do not count mlp "
                         f"{model['mlp']!r}")


def _window(model: dict, seg: dict):
    return None if seg.get("full_attention") else model.get("sliding_window")


def _ssd(model: dict) -> tuple[int, int, int, int]:
    """(d_inner, heads, head_dim, state_dim) of the SSD heads."""
    s = model["ssm"]
    di = s["expand"] * model["d_model"]
    return di, di // s["head_dim"], s["head_dim"], s["state_dim"]


def _attention_mults(model: dict) -> int:
    d, hd = model["d_model"], model["head_dim"]
    H, KV = model["n_heads"], model["n_kv_heads"]
    return d * H * hd + 2 * d * KV * hd + H * hd * d


def gemm_mults(model: dict) -> int:
    _check(model)
    d = model["d_model"]
    di, H, _, N = _ssd(model)
    return (_attention_mults(model) + 3 * d * model["d_ff"]
            + d * 2 * di + d * H + 2 * d * N + di * d
            + N)                                  # the C.B dot


def flops(model: dict, seg: dict, rows: int, seq: int) -> tuple[int, int]:
    _check(model)
    hd = model["head_dim"]
    pairs = kernels.flash_pairs(seq, True, _window(model, seg))
    attention = rows * model["n_heads"] * pairs * 12 * hd
    _, H, P, N = _ssd(model)
    return attention, 16 * rows * H * seq * N * P


def launches(model: dict, seg: dict, rows: int, seq: int, out: dict) -> None:
    _check(model)
    hd = model["head_dim"]
    att = (rows, model["n_heads"], model["n_kv_heads"], seq, hd, hd,
           model["dtype"], True, _window(model, seg))
    out["flash_attention"].append(kernels.flash_attention(*att))
    out["flash_attention_bwd"].append(kernels.flash_attention_bwd(*att))
    _, H, P, N = _ssd(model)
    shape = (rows, H, seq, N, P)
    out["wkv6"].append(kernels.wkv6(*shape, shared_k=True,
                                    shared_decay=True))
    out["wkv6_bwd"].append(kernels.wkv6_bwd(*shape, shared_k=True,
                                            shared_decay=True))


def params(model: dict) -> int:
    _check(model)
    d = model["d_model"]
    di, H, _, N = _ssd(model)
    return (_attention_mults(model) + d * 2 * di + di * d + d * H + 2 * d * N
            + 3 * d * model["d_ff"])
