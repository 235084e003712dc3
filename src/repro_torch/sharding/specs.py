"""Sharding rules: parameter / batch / cache PartitionSpecs.

Port of `repro.sharding.specs`. Strategy: FSDP over the ("pod", "data")
axes + tensor parallelism over "model".

  * projections (…, d_in, d_out): d_in over fsdp, d_out over model for the
    "up" family (wq/wk/wv/w1/w3, gates); transposed for the "down" family
    (wo/w2, out_proj).
  * MoE expert stacks (E, d, ff): E over fsdp when divisible (expert-FSDP),
    else d over fsdp; expert ff always over model.
  * embeddings (V, d): V over model (TP vocab), d over fsdp.
  * norms / scalars / tiny LoRA factors: replicated.

Rules match on the *leaf key name*; a leading stacked-layer axis (every
leaf under "segments" / "encoder") is padded with None. Divisibility is
checked against the mesh so e.g. grok's 8 experts fall back gracefully.

The rules read a mesh's axis names and sizes only (`compat.abstract_mesh`)
and a tree's leaf shapes (the port's param and cache trees, on any
device). A spec is `P`, a tuple with one entry per tensor dim: None, a
mesh axis name, or a tuple of names (sharded over their product, major
to minor), equal to the tuple of jax's `PartitionSpec` of the same
entries.
`placements` lays a spec onto DTensor placements.
"""
from __future__ import annotations

import dataclasses

from torch.distributed.tensor import Replicate, Shard


class P(tuple):
    """PartitionSpec: `P("data", None)`; compares as the tuple of its
    entries. As jax's, a one-name tuple entry is stored as the name and
    an empty one as None."""

    def __new__(cls, *entries):
        def canonical(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else (e[0] if len(e) == 1 else e)
            return e
        return super().__new__(cls, (canonical(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    fsdp: tuple[str, ...] = ("data",)      # ("pod","data") when multi-pod
    model: str = "model"

    @classmethod
    def from_mesh(cls, mesh) -> "MeshAxes":
        names = mesh.axis_names
        fsdp = tuple(n for n in names if n in ("pod", "data"))
        return cls(fsdp=fsdp, model="model" if "model" in names else None)


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        out = 1
        for a in axis:
            out *= mesh.shape[a]
        return out
    return mesh.shape[axis]


def _fits(dim: int, mesh, axis) -> bool:
    n = _axis_size(mesh, axis)
    return n > 1 and dim % n == 0


# Leaf-name -> base rule. Receives (shape_without_layer_axis, ax,
# mesh) and returns a PartitionSpec of the same arity.
def _rule(name: str, shape, ax: MeshAxes, mesh):
    F, M = ax.fsdp, ax.model
    nd = len(shape)

    up = {"wq", "wk", "wv", "wg", "wr", "w1", "w3", "in_proj", "wq_b",
          "wk_b", "wv_b", "lm_head", "mtp_head"}
    down = {"wo", "w2", "out_proj"}
    fsdp_only = {"wq_a", "wkv_a", "td_w1", "tm_w1", "dt_w", "b_proj",
                 "c_proj", "router"}

    if name == "embed" and nd == 2:
        return P(M if _fits(shape[0], mesh, M) else None,
                 F if _fits(shape[1], mesh, F) else None)
    if name in up and nd == 2:
        return P(F if _fits(shape[0], mesh, F) else None,
                 M if _fits(shape[1], mesh, M) else None)
    if name in down and nd == 2:
        return P(M if _fits(shape[0], mesh, M) else None,
                 F if _fits(shape[1], mesh, F) else None)
    if name in fsdp_only and nd == 2:
        return P(F if _fits(shape[0], mesh, F) else None, None)
    if name in ("w1", "w3") and nd == 3:          # MoE experts (E, d, ff)
        e_f = _fits(shape[0], mesh, F)
        return P(F if e_f else None,
                 None if e_f else (F if _fits(shape[1], mesh, F) else None),
                 M if _fits(shape[2], mesh, M) else None)
    if name == "w2" and nd == 3:                  # (E, ff, d)
        e_f = _fits(shape[0], mesh, F)
        return P(F if e_f else None,
                 M if _fits(shape[1], mesh, M) else None,
                 None if e_f else (F if _fits(shape[2], mesh, F) else None))
    if name == "conv_w" and nd == 2:              # (K, d_inner)
        return P(None, M if _fits(shape[1], mesh, M) else None)
    return P(*([None] * nd))                      # replicate


# Params + f32 Adam state (2 + 4 + 4 + 4 bytes/param) per chip below this
# threshold => drop the FSDP axes entirely (TP-only). Small models on big
# meshes are otherwise *collective-bound on weight all-gathers* (the
# reference's measurement: rwkv6-1.6b's collective term per train step
# went from 7.8 s to ~0 s).
AUTO_TP_ONLY_BYTES = 4 << 30


def _map_with_path(fn, tree, path=()):
    """`fn(path, leaf)` over a param or cache tree (dicts and lists);
    a path holds dict keys (str) and list indices (int)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_path(fn, v, path + (i,))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def _leaf_name(path) -> str | None:
    for entry in reversed(path):
        if isinstance(entry, str):
            return entry
    return None


def _shape(leaf) -> tuple[int, ...]:
    return tuple(getattr(leaf, "shape", ()))


def _tp_only_fits(params, mesh, ax: "MeshAxes") -> bool:
    if ax.model is None:
        return False
    sizes = []
    _map_with_path(lambda _, leaf: sizes.append(leaf.numel()), params)
    per_chip = sum(sizes) * 14 / _axis_size(mesh, ax.model)
    return per_chip <= AUTO_TP_ONLY_BYTES


def small_model_mode(params, mesh) -> bool:
    """True when the TP-only / replicate-weights-in-step regime applies."""
    ax = MeshAxes.from_mesh(mesh)
    return _tp_only_fits(params, mesh, ax)


def param_pspecs(params, mesh, *, allow_tp_only: bool = True,
                 mode: str = "train"):
    """PartitionSpec tree matching `params` (handles stacked-layer axes).

    mode="serve": weights must be RESIDENT — re-all-gathering FSDP shards
    every decode step costs collective bytes ~ param_bytes x (fsdp-1)/fsdp
    per token batch. Serve mode therefore shards weights over "model"
    (+ "pod" when present) only and replicates across "data", which
    carries the request batch / KV cache instead.
    """
    ax = MeshAxes.from_mesh(mesh)
    if mode == "serve":
        ax = dataclasses.replace(
            ax, fsdp=tuple(a for a in ax.fsdp if a == "pod"))
    elif allow_tp_only and _tp_only_fits(params, mesh, ax):
        ax = dataclasses.replace(ax, fsdp=())

    def spec_for(path, leaf):
        # Stacked layer axis: every leaf under "segments"/"encoder" has it.
        stacked = any(e in ("segments", "encoder") for e in path)
        shape = _shape(leaf)
        base = _rule(_leaf_name(path) or "", shape[1:] if stacked else shape,
                     ax, mesh)
        return P(None, *base) if stacked else base

    return _map_with_path(spec_for, params)


def batch_pspec(mesh, batch_size: int):
    """Token batches shard over the data-parallel axes when divisible."""
    ax = MeshAxes.from_mesh(mesh)
    dp = ax.fsdp if _fits(batch_size, mesh, ax.fsdp) else None
    return dp


def cache_pspecs(cache, mesh, batch_size: int):
    """Decode-cache specs: batch over dp; the sequence (else kv-heads,
    else head_dim) over model when divisible, else replicated. The port's
    `pos` is a Python int (one position a batch, kept on the host); its
    spec is the reference's, P()."""
    ax = MeshAxes.from_mesh(mesh)
    dp = ax.fsdp if _fits(batch_size, mesh, ax.fsdp) else None
    M = ax.model

    def spec_for(path, leaf):
        name = _leaf_name(path)
        stacked = "segments" in path
        shape = _shape(leaf)
        shape = shape[1:] if stacked else shape
        if name == "pos":
            return P()
        if name in ("k", "v", "xk", "xv") and len(shape) == 4:
            # Sequence-sharded cache: attention over a seq-sharded cache
            # reduces to small partial-softmax all-reduces, vs large
            # gathers for head/hd sharding when kv_heads < mesh model size.
            s_m = _fits(shape[1], mesh, M)
            kv_m = (not s_m) and _fits(shape[2], mesh, M)
            hd_m = (not s_m and not kv_m) and _fits(shape[3], mesh, M)
            base = P(dp, M if s_m else None, M if kv_m else None,
                     M if hd_m else None)
        elif name in ("c_kv", "k_rope") and len(shape) == 3:
            base = P(dp, M if _fits(shape[1], mesh, M) else None, None)
        elif name == "s" and len(shape) == 4:      # rwkv state (B,H,K,V)
            base = P(dp, M if _fits(shape[1], mesh, M) else None, None, None)
        elif name == "ssm_s" and len(shape) == 4:
            base = P(dp, M if _fits(shape[1], mesh, M) else None, None, None)
        elif name in ("tm_x", "cm_x") and len(shape) == 2:
            base = P(dp, None)
        elif name == "conv_tail" and len(shape) == 3:
            base = P(dp, None, M if _fits(shape[2], mesh, M) else None)
        else:
            base = P(*([dp] + [None] * (len(shape) - 1))) if shape else P()
        return P(None, *base) if stacked else base

    return _map_with_path(spec_for, cache)


def placements(spec: P, mesh) -> tuple:
    """DTensor placements (one per axis of `mesh`, an abstract mesh or a
    `DeviceMesh` with dim names) of a tensor laid out by
    `spec`: a dim sharded over an axis is `Shard(dim)` on that axis, over
    a tuple of axes `Shard(dim)` on each (DTensor splits a dim sharded on
    several mesh axes in mesh order, which must be the tuple's major to
    minor); the other axes `Replicate()`."""
    names = tuple(getattr(mesh, "axis_names", None)
                  or mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"placements: {spec} shards dim {dim} over "
                             f"{axes}, not in the mesh's order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"placements: {spec} uses mesh axis "
                                 f"{names[i]!r} twice")
            out[i] = Shard(dim)
    return tuple(out)
