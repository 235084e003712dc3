"""Collective bytes and counts from the dry run's record of collectives.

Port of `repro.analysis.collectives`. The reference parses the compiled
HLO's all-gather / all-reduce / reduce-scatter / all-to-all /
collective-permute ops out of `compiled.as_text()`; the port's dry run
records the collectives DTensor issues on rank 0 (the functional
collectives of `torch.ops._c10d_functional`, and DTensor's own
shard-to-shard all-to-all), each as `(op name, ((dtype, shape), ...))`
with the shapes of its outputs (`launch.dryrun.CostMode`). Kinds and
byte semantics are the reference's: the *output* bytes of each
collective, and an async pair counted once — `wait_tensor`, the
counterpart of an HLO `-done` op, is skipped.
"""
from __future__ import annotations

import math

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16,
}

_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
          "collective-permute")

# torch op name (namespace::name, overload dropped) -> reference kind.
_OP_KINDS = {
    "_c10d_functional::all_gather_into_tensor": "all-gather",
    "_c10d_functional::all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional::all_reduce": "all-reduce",
    "_c10d_functional::all_reduce_": "all-reduce",
    "_c10d_functional::all_reduce_coalesced": "all-reduce",
    "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional::reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional::all_to_all_single": "all-to-all",
    "_dtensor::shard_dim_alltoall": "all-to-all",
}
# Not collectives of their own: the wait (the counterpart of an HLO
# `-done` op) and the autograd wrapper of a collective's output.
_WAITS = ("_c10d_functional::wait_tensor",
          "_c10d_functional::_wrap_tensor_autograd")


def kind_of(op: str) -> str | None:
    """The reference's kind of a recorded op; None for a wait or a
    wrapper. Raises on
    an op of a collective namespace that has no kind here, so that no
    collective goes uncounted."""
    if op in _WAITS:
        return None
    if op not in _OP_KINDS:
        raise KeyError(f"collective {op!r} has no kind; known: "
                       f"{sorted(_OP_KINDS)}")
    return _OP_KINDS[op]


def _shape_bytes(dtype: str, dims) -> int:
    return math.prod(dims) * _DTYPE_BYTES.get(dtype, 4)


def collective_bytes_by_kind(records) -> dict[str, float]:
    """Total *output* bytes per collective kind across the records.

    Waits are skipped so async pairs are not double-counted.
    """
    out: dict[str, float] = {k: 0.0 for k in _KINDS}
    for op, outputs in records:
        kind = kind_of(op)
        if kind is None:
            continue
        for dtype, dims in outputs:
            out[kind] += _shape_bytes(dtype, dims)
    return {k: v for k, v in out.items() if v > 0}


def count_collectives(records) -> dict[str, int]:
    counts: dict[str, int] = {}
    for op, _ in records:
        kind = kind_of(op)
        if kind is not None:
            counts[kind] = counts.get(kind, 0) + 1
    return counts
