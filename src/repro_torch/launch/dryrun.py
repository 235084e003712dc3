"""Dry run: every (arch x input shape) on the production meshes, proving
the partition specs coherent and counting one device's program.

Port of `repro.launch.dryrun`. The reference lowers and compiles each
pair with XLA on 512 fake host devices and reads FLOPs, bytes and
collective bytes from the compiled artifact. No machine here has 256 or
512 devices, so the port runs each pair as DTensors: every param, Adam
moment, batch and decode-cache leaf is laid out by its partition spec
(`sharding.specs`, `specs.placements`) on a `DeviceMesh` over torch's
fake process group (`sharding.compat.device_mesh`), with the local shards
on the `meta` device, and the port's own steps (`train.step`) run on
them under the activation-sharding hints (`sharding.ctx`). DTensor's
sharding propagation then plays GSPMD's part: an op whose inputs' layouts
do not compose raises, and a layout change it needs is a collective it
issues. Nothing is allocated and nothing is computed.

Usage (no GPU; the dry run owns its process, since it makes the fake
process group):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b \
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] \
      --out results/dryrun.json

Per-device figures are rank 0's program, as XLA reports the SPMD per-
device program. `CostMode` sits under DTensor (it lets every DTensor op
desugar first, as `CommDebugMode` does) and sees the ops rank 0 runs on
its local shards: the FLOPs of each (`torch.utils.flop_counter`'s
registry, with `FlopCounterMode`'s decompositions), the bytes it reads
and writes (its tensor inputs and outputs, views and allocations
excepted: an eager op reads and writes each of them in full), and each
collective with its output shapes (`analysis.collectives`). On a one-
device mesh (`make_host_mesh()`) no group is made and the same counter
runs on plain `meta` tensors. `compile_s` is the wall time of that
symbolic run. `memory` holds rank 0's argument and output bytes (its
local shards); XLA's temporaries, aliases and code size have no
counterpart in an eager run and are left out, as the reference's
`_mem_dict` leaves out what it cannot read.

Where the port's ops need what GSPMD gives the reference for free:
  * a plain tensor meeting a DTensor (positions, masks, RoPE tables,
    constants) is taken as replicated (`implicit_replication`);
  * the decode cache's in-place writes (`attention.cache_update`,
    `mla_decode`, the state copies) go into sequence- or head-sharded
    DTensors: DTensor redistributes the written view where its layout
    asks for it, and those collectives are counted;
  * the kernels' plain versions run on `meta` (`kernels.ops`), the scans
    as one step over their chunk axis (`kernels.ref._wkv6_shapes`);
  * the prefill cache takes the prompt's batch layout
    (`sharding.ctx.batch_zeros`), and a gradient its param's layout
    before AdamW (`train.step`);
  * where DTensor has no strategy, `LayoutMode` redistributes explicitly
    (its docstring lists each case); every collective it adds is
    counted.
No sharding strategy is registered with DTensor.

`--ep` declares the reference's expert-parallel context
(`sharding.ctx.expert_parallel(dp, "data", mesh)`) for the train and
prefill pairs of a MoE config whose expert count divides the `data`
axis, the full pair and every probe alike. Each routed layer then runs
`models.lm.moe.apply_moe_ep_mesh`, the reference's `shard_map`: every
rank routes and dispatches its own tokens on its local tensors, one
all-to-all over `data` takes them to their experts (E sharded over
`data`) and one brings them back, and the aux losses are averaged over
the dp axes; the model axis stays tensor-parallel inside the block. The
count holds the two all-to-alls a layer (two more in the backward, and
two again where remat recomputes the layer), the aux all-reduces, the
router's gather, the model axis's partial-sum reductions and, where the
params lay E over ("pod", "data"), the experts' reshard to `data`.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis.calibration import (
    Metrics,
    probe_configs,
    probe_identity,
)
from repro_torch.analysis.collectives import (
    collective_bytes_by_kind,
    kind_of,
)
from repro_torch.analysis.roofline import model_flops, roofline_terms
from repro_torch.configs import get_config, lm_arch_ids
from repro_torch.configs.shapes import (
    INPUT_SHAPES,
    input_specs,
    longctx_variant,
)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.lm.params import map_tree
from repro_torch.models.lm.transformer import init_params, prefill
from repro_torch.obs import log_record, set_logging, span
from repro_torch.optim.adam import adam_init
from repro_torch.sharding.compat import (
    COLLECTIVES,
    device_mesh,
    reset_collectives,
)
from repro_torch.sharding.ctx import (
    activation_sharding,
    expert_parallel,
    model_axis,
)
from repro_torch.sharding.specs import (
    P,
    batch_pspec,
    cache_pspecs,
    param_pspecs,
    placements,
    small_model_mode,
)
from repro_torch.train.step import (
    make_prefill_step,
    make_serve_step,
    make_train_step,
)

# Op namespaces whose ops are collectives (`analysis.collectives`); an op
# of one that has no kind there raises.
_COLLECTIVE_NS = ("_c10d_functional", "_dtensor", "c10d")
# Ops that allocate without writing: no bytes moved.
_ALLOCS = ("aten::empty", "aten::empty_strided", "aten::empty_like",
           "aten::new_empty", "aten::new_empty_strided")
_HLO_DTYPES = {torch.bfloat16: "bf16", torch.float16: "f16",
               torch.float32: "f32", torch.float64: "f64",
               torch.int8: "s8", torch.uint8: "u8", torch.int16: "s16",
               torch.int32: "s32", torch.int64: "s64", torch.bool: "pred",
               torch.complex64: "c64", torch.complex128: "c128"}


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _fake_active() -> bool:
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None


class CostMode(TorchDispatchMode):
    """Counts rank 0's program: FLOPs and bytes of every op it runs on
    its local tensors, and the collectives (op name and output shapes,
    as `analysis.collectives` reads them). DTensor ops are let through
    to desugar first (NotImplemented), so only local ops are counted."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives: list[tuple[str, tuple]] = []
        self._gathered: dict[int, torch.Tensor] = {}
        self._registry = FlopCounterMode(display=False).flop_registry

    def metrics(self) -> Metrics:
        return Metrics(self.flops, float(self.bytes),
                       collective_bytes_by_kind(self.collectives))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if isinstance(func, torch._ops.HigherOrderOperator) or _fake_active():
            # DTensor's sharding propagation runs each op once on fake
            # tensors of the global shape to learn its output's metadata:
            # no op of rank 0's program.
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet not in self._registry:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        if func.namespace in _COLLECTIVE_NS:
            kind_of(func._schema.name)
        out = func(*args, **kwargs)
        if func.namespace in _COLLECTIVE_NS:
            self.collectives.append((func._schema.name, tuple(
                (_HLO_DTYPES[t.dtype], tuple(t.shape))
                for t in _tensors(out))))
            # Held, so that no later tensor takes a storage's address.
            self._gathered.update((_storage(t), t) for t in _tensors(out))
            return out
        if func._schema.name == "aten::cat" and args[0] and all(
                _storage(t) in self._gathered for t in args[0]):
            # The chunks of one collective's output put back in order
            # (an all-gather along a dim other than 0): part of the
            # collective, whose output bytes the collective term counts.
            # Whether it copies at all depends on the leading dims (a
            # view where they are all 1), not on the program.
            return out
        if packet in self._registry:
            self.flops += int(self._registry[packet](*args, **kwargs,
                                                     out_val=out))
        if not _is_view(func) and func._schema.name not in _ALLOCS:
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in _tensors(out))
        return out


# ----------------------------------------------------------------------- #
# Where DTensor has no strategy: explicit redistributions
# ----------------------------------------------------------------------- #
_VIEWS = ("aten::view", "aten::_unsafe_view")
_ARG_REDUCTIONS = ("aten::argmax", "aten::argmin")
# Row lookups in a 2-D table (the token embedding: `F.embedding`, and
# `table[tokens]` in prefill and decode) and the embedding's backward.
_ROW_LOOKUPS = ("aten::embedding", "aten::index")
_ROW_LOOKUP_BWD = "aten::embedding_dense_backward"
# Other indexing (the MoE dispatch's gathers and their backward).
_INDEXING = ("aten::index", "aten::index_put", "aten::index_put_",
             "aten::_index_put_impl_")
# Ops that move elements along the dims of their args[index] (every dim
# when it is empty): computed on the local shard once those dims are
# whole. torch 2.11's DTensor has no strategy for them.
_ALONG = {"aten::roll": 2, "aten::flip": 1}


def _view_groups(a, b) -> list[tuple[list[int], list[int]]]:
    """The dims of shape `a` and of shape `b` a view maps onto each other,
    group by group (equal products)."""
    groups, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        I, O, pa, pb = [i], [j], a[i], b[j]
        i, j = i + 1, j + 1
        while pa != pb:
            if pa < pb:
                I.append(i)
                pa *= a[i]
                i += 1
            else:
                O.append(j)
                pb *= b[j]
                j += 1
        groups.append((I, O))
    return groups


def _resolved(a, shape) -> tuple[int, ...]:
    """A view's target shape with its -1 worked out."""
    b = tuple(shape)
    if -1 in b:
        known = math.prod(n for n in b if n != -1)
        b = tuple(math.prod(a) // known if n == -1 else n for n in b)
    return b


def _uneven_view_dims(x, shape) -> set[int]:
    """Mesh dims whose shards of `x` the view to `shape` would split
    unevenly: a sharded dim that is not the outermost of the dims it
    merges with, that its shard count does not divide, or whose
    outermost piece the shard count does not divide. DTensor cannot
    express these; GSPMD can."""
    a = tuple(x.shape)
    b = _resolved(a, shape)
    bad = set()
    for I, O in _view_groups(a, b):
        I1 = [d for d in I if a[d] != 1]
        O1 = [d for d in O if b[d] != 1]
        if not any(b[d] == 1 for d in O):     # a sharded size-1 dim
            bad.update(m for m, p in enumerate(x.placements)
                       if isinstance(p, Shard) and p.dim in I
                       and a[p.dim] == 1)
        if len(I1) <= 1 and len(O1) <= 1:
            continue
        for dim in I1:
            mesh_dims = [m for m, p in enumerate(x.placements)
                         if isinstance(p, Shard) and p.dim == dim]
            # Keep the major mesh dims while their shards divide.
            n = 1
            for k, m in enumerate(mesh_dims):
                n *= x.device_mesh.size(m)
                if dim != I1[0] or not O1 or b[O1[0]] % n or a[dim] % n:
                    bad.update(mesh_dims[k:])
                    break
    return bad


def _local_view(func, x, shape) -> torch.Tensor:
    """A view of a DTensor whose sharded dims are each the outermost of
    their view group and divide evenly (`_uneven_view_dims` gathered the
    others), taken on the local shard: a sharded dim's shards become the
    outermost dim of its group's. DTensor's own view strategy refuses a
    dim sharded over two mesh dims in torch 2.11; this is its rule for
    one. A shard whose strides do not allow a view (an einsum's expanded
    operand) is copied first."""
    a = tuple(x.shape)
    b = _resolved(a, shape)
    local = x.to_local()
    out_dim, target = {}, list(b)
    for I, O in _view_groups(a, b):
        I1 = [d for d in I if a[d] != 1]
        O1 = [d for d in O if b[d] != 1]
        ones = [d for d in O if b[d] == 1]
        for d in I:
            if a[d] == 1 and ones:            # a size-1 dim stays one
                out_dim[d] = ones[0]
                target[ones[0]] = local.shape[d]
        if len(I1) == 1 and len(O1) == 1:
            out_dim[I1[0]] = O1[0]
            target[O1[0]] = local.shape[I1[0]]
        elif I1 and O1:
            out_dim[I1[0]] = O1[0]
    place = []
    for m, p in enumerate(x.placements):
        if isinstance(p, Shard):
            od = out_dim[p.dim]
            place.append(Shard(od))
            if target[od] == b[od]:       # a merge or split: even shards
                target[od] = b[od] // math.prod(
                    x.device_mesh.size(k) for k, q in enumerate(x.placements)
                    if isinstance(q, Shard) and q.dim == p.dim)
        else:
            place.append(p)
    if func._schema.name == "aten::view":
        try:
            out = func(local, target)
        except RuntimeError:          # strides that admit no view
            out = func(local.contiguous(), target)
    else:
        out = func(local, target)
    return DTensor.from_local(out, x.device_mesh, place, run_check=False,
                              shape=torch.Size(b),
                              stride=_contiguous_stride(b))


def _replicate_dims(x, mesh_dims) -> torch.Tensor:
    if not mesh_dims:
        return x
    place = [Replicate() if m in mesh_dims else p
             for m, p in enumerate(x.placements)]
    return x.redistribute(x.device_mesh, place)


def _whole_along(x, dim: int | None) -> torch.Tensor:
    """x with dim `dim` (every dim for None) gathered whole, and its
    pending sums (`Partial`) reduced."""
    return _whole_along_dims(x, range(x.ndim) if dim is None else [dim])


def _whole_along_dims(x, dims) -> torch.Tensor:
    dims = [d % x.ndim for d in dims]
    return _replicate_dims(x, {
        m for m, p in enumerate(x.placements)
        if p.is_partial() or (isinstance(p, Shard) and p.dim in dims)})


def _row_index(name: str, args):
    """The integer index tensor of a row lookup (`embedding(table, idx)`,
    `index(table, [idx])`), or None for another indexing."""
    idx = args[1] if name == "aten::embedding" else (
        args[1][0] if len(args[1]) == 1 else None)
    if isinstance(idx, torch.Tensor) and not idx.is_floating_point() \
            and idx.dtype != torch.bool:
        return idx
    return None


def _row_lookup(func, args, kwargs) -> torch.Tensor:
    """A row lookup on the local shards: the table's rows (vocab) whole,
    its columns where the indices are not sharded; each rank looks up
    its own indices in its own columns. The result is sharded as the
    indices are, then as the table's columns."""
    table, idx = args[0], _row_index(func._schema.name, args)
    if not isinstance(idx, DTensor):
        idx = DTensor.from_local(idx, table.device_mesh,
                                 [Replicate()] * table.device_mesh.ndim,
                                 run_check=False)
    by_idx = {m for m, p in enumerate(idx.placements) if isinstance(p, Shard)}
    table = _replicate_dims(table, {
        m for m, p in enumerate(table.placements) if p.is_partial() or (
            isinstance(p, Shard) and (p.dim == 0 or m in by_idx))})
    local = func(table.to_local(), idx.to_local(), *args[2:], **kwargs) \
        if func._schema.name == "aten::embedding" else \
        func(table.to_local(), [idx.to_local()])
    place = [p if isinstance(p, Shard) else (
        Shard(idx.ndim) if isinstance(tp, Shard) else Replicate())
        for p, tp in zip(idx.placements, table.placements)]
    shape = tuple(idx.shape) + (table.shape[1],)
    return DTensor.from_local(local, table.device_mesh, place,
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def _row_lookup_backward(func, args, kwargs) -> torch.Tensor:
    """The table's gradient of `_row_lookup`, on the local shards: each
    rank scatters its own rows' gradients (a pending sum over the mesh
    dims that shard the indices), its columns sharded as the incoming
    gradient's last dim is."""
    grad, idx = args[0], args[1]
    if not isinstance(idx, DTensor):
        idx = DTensor.from_local(idx, grad.device_mesh,
                                 [Replicate()] * grad.device_mesh.ndim,
                                 run_check=False)
    # Rows follow the indices' layout, the last dim its own.
    want = [p if isinstance(p, Shard) else (
        gp if isinstance(gp, Shard) and gp.dim == grad.ndim - 1
        else Replicate()) for p, gp in zip(idx.placements, grad.placements)]
    grad = grad.redistribute(grad.device_mesh, want)
    local = func(grad.to_local(), idx.to_local(), *args[2:], **kwargs)
    place = [Partial() if isinstance(p, Shard) else (
        Shard(1) if isinstance(gp, Shard) else Replicate())
        for p, gp in zip(idx.placements, grad.placements)]
    shape = (args[2], grad.shape[-1])
    return DTensor.from_local(local, grad.device_mesh, place,
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def _into_plain(func, args) -> bool:
    """Whether `func` writes in place into a plain (non-DTensor) tensor."""
    return bool(func._schema.is_mutable and args
                and not isinstance(args[0], DTensor))


def _one_mesh_dim_a_dim(x):
    """x (a DTensor; anything else as it is) with each tensor dim sharded
    over one mesh dim at most, the major one: the minor ones gathered."""
    if not isinstance(x, DTensor):
        return x
    seen, minor = set(), set()
    for m, p in enumerate(x.placements):
        if isinstance(p, Shard):
            if p.dim in seen:
                minor.add(m)
            seen.add(p.dim)
    return _replicate_dims(x, minor)


def _contiguous_stride(shape) -> tuple[int, ...]:
    out, n = [], 1
    for d in reversed(shape):
        out.append(n)
        n *= d
    return tuple(reversed(out))


class LayoutMode(TorchDispatchMode):
    """Sits above DTensor and redistributes, explicitly, where DTensor
    has no strategy for an op the port runs (each collective is then
    counted by `CostMode` below it):
      * a view that splits a sharded dim unevenly (heads of a projection
        sharded 16 ways over 8 KV heads, tokens sharded 256 ways over 32
        rows) first gathers the mesh dims it cannot keep; every view then
        runs on the local shard (`_local_view`);
      * argmax / argmin over a sharded dim first gathers that dim;
      * roll and flip (the prefill's ring cache, the scan's suffix sums)
        gather the dims they move along and run on the local shard;
      * the cross-entropy's gather of the label's logit along a sharded
        (vocab) dim first gathers that dim: DTensor's own way, a masked
        partial sum (`MaskPartial`), reads its mask's values, which
        `meta` shards do not have;
      * the token embedding's row lookup (and its backward) runs on the
        local shards with the table's vocab rows gathered whole: each
        rank looks up its own tokens (torch 2.11's DTensor has no
        strategy for indices sharded over two mesh dims, the
        ("pod", "data") batch); other indexing (the MoE dispatch's)
        keeps the major of such mesh dims and gathers the minor ones;
      * an in-place write into a tensor the model made plainly (the MoE
        dispatch's buffers, the router's expert counts) takes its
        DTensor operands whole (`full_tensor()`, gathered): the write
        is then rank 0's on the whole, as for every replicated tensor.
        The expert-parallel block (`--ep`) never meets this rule: its
        dispatch runs on each rank's local tensors.
    """

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name
        if name in _VIEWS and isinstance(args[0], DTensor):
            x = _replicate_dims(args[0], _uneven_view_dims(*args[:2]))
            return _local_view(func, x, args[1])
        elif name in _ARG_REDUCTIONS and isinstance(args[0], DTensor):
            dim = args[1] if len(args) > 1 else kwargs.get("dim")
            args = (_whole_along(args[0], dim), *args[1:])
        elif name == "aten::gather" and isinstance(args[0], DTensor):
            args = (_whole_along(args[0], args[1]), *args[1:])
        elif name in _ROW_LOOKUPS and isinstance(args[0], DTensor) \
                and args[0].ndim == 2 and _row_index(name, args) is not None:
            return _row_lookup(func, args, kwargs)
        elif name == _ROW_LOOKUP_BWD and isinstance(args[0], DTensor):
            return _row_lookup_backward(func, args, kwargs)
        elif name in _INDEXING and any(issubclass(t, DTensor)
                                       for t in types) and not _into_plain(
                                           func, args):
            args = tuple([_one_mesh_dim_a_dim(i) for i in a]
                         if isinstance(a, (list, tuple))
                         else _one_mesh_dim_a_dim(a) for a in args)
        elif name in _ALONG and isinstance(args[0], DTensor):
            i = _ALONG[name]
            dims = args[i] if len(args) > i else kwargs.get("dims", [])
            dims = [dims] if isinstance(dims, int) else list(dims)
            x = _whole_along_dims(args[0], dims or range(args[0].ndim))
            local = func(x.to_local(), *args[1:], **kwargs)
            return DTensor.from_local(local, x.device_mesh, x.placements,
                                      run_check=False, shape=x.shape,
                                      stride=x.stride())
        if _into_plain(func, args) and any(issubclass(t, DTensor)
                                           for t in types):
            whole = lambda t: t.full_tensor() if isinstance(t, DTensor) \
                else t
            args = tuple(whole(t) if not isinstance(t, (list, tuple))
                         else type(t)(whole(u) for u in t) for t in args)
            kwargs = {k: whole(v) for k, v in kwargs.items()}
        return func(*args, **kwargs)


# ----------------------------------------------------------------------- #
# Laying trees out on the mesh
# ----------------------------------------------------------------------- #
def _shard(t: torch.Tensor, spec: P, dmesh) -> torch.Tensor:
    """A DTensor of `t`'s global shape laid out by `spec` on `dmesh`,
    its local shard (rank 0's) an empty meta tensor; `t` itself on a
    one-device mesh (dmesh None)."""
    if dmesh is None:
        return t
    place = placements(spec, dmesh)
    local = list(t.shape)
    for mesh_dim, p in enumerate(place):
        if isinstance(p, Shard):
            local[p.dim] = math.ceil(local[p.dim] / dmesh.size(mesh_dim))
    return DTensor.from_local(
        torch.empty(local, dtype=t.dtype, device="meta"), dmesh, place,
        run_check=False, shape=t.shape, stride=t.stride())


def _layout(tree, spec_tree, dmesh):
    """`_shard` over a tree and its spec tree (ints, as the cache's
    `pos`, pass through)."""
    return map_tree(lambda t, s: _shard(t, s, dmesh)
                    if isinstance(t, torch.Tensor) else t, tree, spec_tree)


def _local_bytes(tree) -> int:
    out = []
    map_tree(lambda t: out.append(
        _nbytes(t.to_local() if isinstance(t, DTensor) else t))
        if isinstance(t, torch.Tensor) else None, tree)
    return sum(out)


def _meta_params(cfg):
    return init_params(cfg, torch.Generator().manual_seed(0), "meta")


def _regime(cfg, shape, mesh, force_small):
    """(small, dp): the sharding regime of the reference's `_compile`."""
    small = small_model_mode(_meta_params(cfg), mesh) \
        if force_small is None else force_small
    if small and shape.kind == "train":
        # Pure-DP regime: weights replicated inside the step, batch over
        # EVERY mesh axis (data x model) — see train.step.make_train_step.
        dp = tuple(mesh.axis_names)
        if shape.global_batch % mesh.size:
            dp = batch_pspec(mesh, shape.global_batch)
    else:
        dp = batch_pspec(mesh, shape.global_batch)
    return small, dp


def _decode_cache(cfg, params, B: int, S: int):
    """The decode cache as `prefill` builds it (plain meta, uncounted)."""
    kw = {}
    if cfg.encoder is not None:
        kw["enc_embeds"] = torch.empty(
            (B, cfg.encoder.n_frames, cfg.d_model),
            dtype=getattr(torch, cfg.dtype), device="meta")
    return prefill(cfg, params, torch.zeros((B, 1), dtype=torch.int32,
                                            device="meta"), S, **kw)[1]


def _clear_sharding_caches() -> None:
    """Empty DTensor's sharding-propagation caches (Python and, where
    this torch has it, C++). DTensor's first, uncached strategy for an op
    can differ from the one it caches, so without this a count would
    depend on which pairs ran before it in the process, and a model's
    first layer would not cost what its others do."""
    prop = DTensor._op_dispatcher.sharding_propagator
    prop.propagate_op_sharding.cache_clear()
    prop._propagate_tensor_meta_cached.cache_clear()
    native = getattr(torch._C, "_clear_DTensor_sharding_propagator_cache",
                     None)
    if native is not None:
        native()


def use_ep(cfg, shape, mesh, dp, ep: bool) -> bool:
    """The reference's predicate: `--ep` on a MoE config, not decode, a
    batch over mesh axes, and the expert count divides the `data` axis."""
    return (ep and cfg.moe is not None and shape.kind != "decode"
            and isinstance(dp, tuple)
            and cfg.moe.n_experts % mesh.shape["data"] == 0)


def run_step(cfg, shape, mesh, dmesh, *, remat: bool = True,
             force_small: bool | None = None,
             ep: bool = False) -> tuple[Metrics, dict]:
    """One step of (cfg, shape) on `mesh` (its `DeviceMesh` `dmesh`, None
    for one device), counted. Returns (Metrics, memory dict).

    force_small pins the sharding regime — calibration probes (1-2 layer
    variants) must run under the FULL model's regime or their body costs
    are measured under the wrong parallelism. `ep` asks for the
    expert-parallel MoE where `use_ep` allows it."""
    _clear_sharding_caches()
    small, dp = _regime(cfg, shape, mesh, force_small)
    params = _meta_params(cfg)
    mode = "serve" if shape.kind == "decode" else "train"
    specs = param_pspecs(params, mesh, mode=mode, allow_tp_only=small)
    batch = input_specs(cfg, shape)
    batch_specs = {k: P(dp, *([None] * (v.dim() - 1)))
                   for k, v in batch.items()}
    cm = CostMode()
    if shape.kind == "train":
        opt = adam_init(params)
        opt_specs = {"mu": specs, "nu": specs, "step": P()}
        args = (_layout(params, specs, dmesh), _layout(opt, opt_specs, dmesh),
                _layout(batch, batch_specs, dmesh))
        step = make_train_step(cfg, remat=remat, replicate_weights=small)
    elif shape.kind == "prefill":
        args = (_layout(params, specs, dmesh),
                _layout(batch, batch_specs, dmesh))
        step = make_prefill_step(cfg, max_seq=shape.seq_len)
    else:
        B = shape.global_batch
        cache = _decode_cache(cfg, params, B, shape.seq_len)
        cache_specs = cache_pspecs(cache, mesh, B)
        args = (_layout(params, specs, dmesh),
                _shard(batch["tokens"], P(batch_pspec(mesh, B), None),
                       dmesh),
                _layout(cache, cache_specs, dmesh))
        step = make_serve_step(cfg)
    dtensors = dmesh is not None
    epctx = expert_parallel(dp, "data", dmesh) \
        if use_ep(cfg, shape, mesh, dp, ep) else contextlib.nullcontext()
    with activation_sharding(dp if isinstance(dp, tuple) else None), \
            model_axis("model" if shape.kind == "decode" else None), epctx, \
            implicit_replication() if dtensors else contextlib.nullcontext(), \
            cm, LayoutMode() if dtensors else contextlib.nullcontext():
        out = step(*args)
    memory = {"argument_size_in_bytes": _local_bytes(list(args)),
              "output_size_in_bytes": _local_bytes(list(out))}
    return cm.metrics(), memory


def lower_pair(arch: str, shape_name: str, mesh, *, remat: bool = True,
               donate: bool = True, calibrate: bool = True,
               ep: bool = False):
    """Run one (arch, shape, mesh) symbolically. Returns a result dict.

    With calibrate=True the count is checked against 1- and 2-layer
    probes per segment (analysis/calibration.py): a pair whose count
    breaks the probe identity raises. `donate` is the reference's flag:
    the port's steps update params, moments and the cache in place
    (always donated), so it changes nothing here."""
    del donate
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    note = ""
    if shape_name == "long_500k":
        cfg, note = longctx_variant(cfg)
        if cfg is None:
            return {"arch": arch, "shape": shape_name, "status": "skipped",
                    "note": note}
    dmesh = device_mesh(mesh)

    t0 = time.perf_counter()
    reset_collectives()
    with span("launch.compile", arch=arch, shape=shape_name):
        full, mem = run_step(cfg, shape, mesh, dmesh, remat=remat, ep=ep)
    compile_s = time.perf_counter() - t0
    # The expert-parallel block's own exchanges (`sharding.compat` counts
    # them); the count's all-to-all bytes hold them and DTensor's own.
    experts = {"ep_all_to_all": COLLECTIVES["all_to_all"],
               "ep_all_to_all_bytes": COLLECTIVES["all_to_all_bytes"]}

    calibration_note = "unchecked (--no-calibrate)"
    if calibrate:
        full_small = small_model_mode(_meta_params(cfg), mesh)
        probes = [(run_step(c1, shape, mesh, dmesh, remat=remat,
                            force_small=full_small, ep=ep)[0],
                   run_step(c2, shape, mesh, dmesh, remat=remat,
                            force_small=full_small, ep=ep)[0], n)
                  for _, c1, c2, n in probe_configs(cfg)]
        if probes:
            check = probe_identity(full, probes)
            if not check["ok"]:
                raise RuntimeError(f"{arch} x {shape_name}: the count breaks "
                                   f"the probe identity: {check['gaps']}")
            calibration_note = ("probe-checked (eager: every layer "
                                "counted)")
        else:
            calibration_note = "no probes (every segment one layer)"

    result = {
        "arch": arch, "shape": shape_name, "status": "ok", "note": note,
        "mesh": "x".join(str(s) for s in mesh.axis_sizes),
        "chips": int(mesh.size),
        "compile_s": round(compile_s, 1),
        "memory": mem,
        # Per-device numbers: rank 0's program.
        "cost_flops": full.flops,
        "cost_bytes": full.bytes,
        "collective_bytes": full.coll,
        "raw_cost_flops": full.flops,
        "calibration": calibration_note,
        "model_flops": model_flops(cfg, shape),
        **(experts if ep else {}),
    }
    result["roofline"] = roofline_terms(result)
    return result


def _release_group() -> None:
    """Destroy the fake group a mesh made (the next mesh has another
    size)."""
    if dist.is_initialized() and dist.get_backend() == "fake":
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(INPUT_SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--no-calibrate", action="store_true",
                    help="skip the probe check (multi-pod proof pass)")
    ap.add_argument("--ep", action="store_true",
                    help="expert-parallel token all-to-all MoE (train and "
                         "prefill pairs whose experts divide the data axis)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--log", action="store_true",
                    help="emit structured progress records on stderr "
                         "(same as REPRO_LOG=1)")
    args = ap.parse_args(argv)
    if args.log:
        set_logging(True)

    if args.both_meshes:
        meshes = [make_production_mesh(), make_production_mesh(multi_pod=True)]
    else:
        meshes = [make_production_mesh(multi_pod=args.multi_pod)]

    archs = lm_arch_ids() if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    pairs = [(a, s) for a in archs for s in shapes]

    results = []
    for mesh in meshes:
        mesh_tag = "x".join(str(s) for s in mesh.axis_sizes)
        for arch, shape in pairs:
            try:
                r = lower_pair(arch, shape, mesh, remat=not args.no_remat,
                               calibrate=not args.no_calibrate, ep=args.ep)
                results.append(r)
                if r["status"] == "ok":
                    log_record("dryrun.pair", arch=arch, shape=shape,
                               mesh=mesh_tag, status="ok",
                               compile_s=r["compile_s"],
                               flops=r["cost_flops"],
                               bytes=r["cost_bytes"],
                               collective_bytes=sum(
                                   r["collective_bytes"].values()),
                               bound=r["roofline"]["dominant"])
                else:
                    log_record("dryrun.pair", arch=arch, shape=shape,
                               mesh=mesh_tag, status="skipped",
                               note=r["note"])
            except Exception as e:  # noqa: BLE001 — report and continue
                results.append({"arch": arch, "shape": shape,
                                "status": "error", "error": repr(e)[:500]})
                log_record("dryrun.pair", arch=arch, shape=shape,
                           mesh=mesh_tag, status="error",
                           error=repr(e)[:300])
            sys.stderr.flush()
        _release_group()

    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        log_record("dryrun.wrote", path=args.out)
    n_err = sum(1 for r in results if r["status"] == "error")
    log_record("dryrun.done", pairs=len(results), errors=n_err)
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
