"""Activation-sharding and expert-parallel contexts.

Port of `repro.sharding.ctx`. Model code is mesh-agnostic; a launcher
declares which mesh axes carry the batch (data-parallel) dimension before
it runs the model, and layers call `constrain_batch` / `constrain_kv` as
hints (the reference's GSPMD `with_sharding_constraint`). Under a
declared context a DTensor argument is redistributed to the reference's
spec: its batch dim over the declared axes, every other dim replicated
(`constrain_kv`: the fresh K/V of a decode step replicated across
"model"). A plain tensor, or any call without a declared context, is
returned as it is: the simulator, serving and training paths run
unchanged. Only the dry run (`repro_torch.launch.dryrun`) declares one.

`expert_parallel` / `ep_axis` declare what carries expert parallelism
(the MoE layers read it: under a declared context a routed-expert layer
over full sequences dispatches its tokens with one all-to-all each way):
a process group (`models.lm.moe.apply_moe_ep` on plain tensors), or the
reference's (dp axes, axis, mesh) on a `DeviceMesh` (`MeshEP`, the dry
run's: `models.lm.moe.apply_moe_ep_mesh` on DTensors). Without one (the
default) they dispatch row-locally.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.sharding.specs import P, placements

_DP_AXES: contextvars.ContextVar = contextvars.ContextVar(
    "activation_sharding", default=None)
_MODEL_AXIS: contextvars.ContextVar = contextvars.ContextVar(
    "model_axis", default=None)
_EP: contextvars.ContextVar = contextvars.ContextVar("expert_parallel",
                                                     default=None)


@contextlib.contextmanager
def activation_sharding(dp_axes: tuple[str, ...] | None):
    """Declare the data-parallel mesh axes for the enclosed calls."""
    token = _DP_AXES.set(tuple(dp_axes) if dp_axes else None)
    try:
        yield
    finally:
        _DP_AXES.reset(token)


def _constrain(x: torch.Tensor, spec) -> torch.Tensor:
    """Redistribute a DTensor to `spec` (a `specs.P`) on its own mesh."""
    target = placements(spec, x.device_mesh)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(x.device_mesh, target)


def constrain_batch(x: torch.Tensor, trailing: tuple | None = None, *,
                    dim: int = 0) -> torch.Tensor:
    """Constrain axis `dim` of x to the declared data-parallel axes (the
    others to `trailing`, else replicated). The port's training forward
    keeps a leading client axis, so its batch is axis 1 there."""
    dp = _DP_AXES.get()
    if dp is None or x.ndim == 0 or not isinstance(x, DTensor):
        return x
    rest = list(trailing if trailing is not None else (None,) * (x.ndim - 1))
    return _constrain(x, P(*rest[:dim], dp, *rest[dim:]))


def batch_zeros(shape, like: torch.Tensor,
                batch_dim: int = 0) -> torch.Tensor:
    """`torch.zeros(shape)` in `like`'s dtype, on its device. When
    `like` is a DTensor, a DTensor on its mesh: dim
    `batch_dim` laid out as `like`'s dim 0 (its batch) is, every other
    dim replicated — the layout GSPMD gives the reference's prefill cache
    from the batch-sharded K/V written into it."""
    if not isinstance(like, DTensor):
        return torch.zeros(shape, dtype=like.dtype, device=like.device)
    mesh = like.device_mesh
    place, local = [], list(shape)
    for i, p in enumerate(like.placements):
        if isinstance(p, Shard) and p.dim == 0:
            place.append(Shard(batch_dim))
            local[batch_dim] = -(-local[batch_dim] // mesh.size(i))
        else:
            place.append(Replicate())
    return DTensor.from_local(
        torch.zeros(local, dtype=like.dtype, device=like.to_local().device),
        mesh, place, run_check=False, shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride())


@contextlib.contextmanager
def model_axis(name: str | None):
    """Declare the tensor-parallel axis (for KV-cache layout alignment)."""
    token = _MODEL_AXIS.set(name)
    try:
        yield
    finally:
        _MODEL_AXIS.reset(token)


def constrain_kv(x: torch.Tensor,
                 mesh_model_size: int | None = None) -> torch.Tensor:
    """Align a (B, S, KV, hd) K/V tensor with the decode-cache layout:
    batch over dp. Without this hint the freshly-projected token's
    sharding mismatches the cache, and GSPMD replicates the whole cache
    to write it (the reference measured 86 GB a step of all-gather in
    qwen1.5-110b's decode). Mirrors sharding.specs.cache_pspecs."""
    if _MODEL_AXIS.get() is None or x.ndim != 4:
        return constrain_batch(x)
    if not isinstance(x, DTensor):
        return x
    # The cache itself is sequence-sharded (specs.cache_pspecs); the fresh
    # token is one position, so it enters replicated across the model axis
    # and the in-place update becomes a local write.
    return _constrain(x, P(_DP_AXES.get(), None, None, None))


@dataclasses.dataclass(frozen=True)
class MeshEP:
    """The mesh form of an expert-parallel context: the batch's
    data-parallel axes, the axis the experts and the all-to-alls lie on,
    and the `DeviceMesh` (its size along `axis` is the shard count)."""

    dp_axes: tuple[str, ...]
    axis: str
    mesh: object

    @property
    def size(self) -> int:
        return self.mesh.size(self.mesh.mesh_dim_names.index(self.axis))

    @functools.cached_property
    def dp_group(self):
        """One process group over the product of the dp axes (the aux
        losses' mean): the axis's own group, or a `dist.new_group` of
        this rank's sub-mesh, made once a context. Not the mesh's
        `_flatten()`: DTensor plans every later redistribution over a
        flattened mesh's axes with it, so the count of what follows
        would depend on whether a routed layer ran before."""
        sub = self.mesh[self.dp_axes]
        if sub.ndim == 1:
            return sub.get_group()
        return dist.new_group(sub.mesh.flatten().tolist())


@contextlib.contextmanager
def expert_parallel(group_or_dp_axes, axis: str | None = None, mesh=None):
    """Declare the expert-parallel axis for the enclosed calls. None
    disables; layers then dispatch row-locally.

    Two forms. `expert_parallel(group)`: a process group, whose world
    size is the shard count (a group has one axis and one size, so the
    reference's other arguments are not taken). `expert_parallel(dp_axes,
    axis, mesh)`: the reference's, on a `DeviceMesh` of DTensors (the dry
    run's), its size read from the mesh."""
    ep = group_or_dp_axes
    if axis is not None:
        ep = MeshEP(tuple(group_or_dp_axes), axis, mesh)
    token = _EP.set(ep)
    try:
        yield
    finally:
        _EP.reset(token)


def ep_axis():
    """The declared expert-parallel context (a process group or a
    `MeshEP`), or None."""
    return _EP.get()
