"""Model FLOPs of one local training step, from a configuration file's
"model" section: the numerator of `round_mfu`.

  matmul     every product with a weight (projections, LoRAs, MLPs, the
             output head) and the SSD heads' C.B dot, forward (2 m n a
             token for an m x n weight) and backward (twice the forward:
             the input's and the weight's gradient), over every position
  attention  q.k and p.v of each pair the causal window leaves, forward
             (2 (D + Dv) a pair and head) and backward without
             recomputing the scores (dS K, dS^T Q, dO V^T, P^T dO:
             2 (2 D + 2 Dv))
  scan       the decayed state recurrence, forward (o = r.S 2 K V,
             S = w S + k v^T 3 K V a step and head) and backward (dS 3,
             dr 2, dk 2, dv 2, dlogw 2 K V)

Recompute is not counted, nor elementwise work. Each layer's share
comes from its segment kind's file, `bench/counts/kinds/<kind>.py`; a
kind with no file raises. `param_count` is a frozen copy of
`repro_torch.analysis.roofline.param_count` (the dry run's analytic
count), for the 6 N D comparison that PERF.md gives.
"""
from __future__ import annotations

from bench.counts import kernels as _kernels


def _gemm_mults_per_token(model: dict) -> int:
    """Multiply-adds of the weight products of one token's forward."""
    total = model["d_model"] * model["vocab_size"]    # output head
    for seg in model["segments"]:
        total += seg["n_layers"] * _kernels.kind(seg["kind"]).gemm_mults(
            model)
    return total


def step_flops(model: dict, rows: int, seq: int) -> dict:
    """FLOPs of one local step (forward and backward) on (rows, seq)."""
    matmul = 3 * 2 * _gemm_mults_per_token(model) * rows * seq
    attention = scan = 0
    for seg in model["segments"]:
        a, s = _kernels.kind(seg["kind"]).flops(model, seg, rows, seq)
        attention += seg["n_layers"] * a
        scan += seg["n_layers"] * s
    return {"matmul": matmul, "attention": attention, "scan": scan,
            "total": matmul + attention + scan}


def param_count(model: dict) -> int:
    """Analytic parameter count (a copy of the dry run's, per segment
    kind in `bench/counts/kinds/`)."""
    total = model["vocab_size"] * model["d_model"]
    if not model.get("tie_embeddings"):
        total += model["d_model"] * model["vocab_size"]
    for seg in model["segments"]:
        total += seg["n_layers"] * _kernels.kind(seg["kind"]).params(model)
    return int(total)
