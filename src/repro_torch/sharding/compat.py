"""The `torch.distributed` seam of the port, in one file.

The reference keeps jax's version split of `shard_map` here; the port
keeps what its collectives need from `torch.distributed`:

  * `default_group(device)` — the process group a mesh round runs on
    when the caller gives none: the default group if the program has
    initialised one, else a one-rank group on an in-memory `HashStore`
    (the counterpart of JAX's implicit one-device mesh), so the
    collective really runs at world size 1. With CUDA present it is made
    with `backend="cpu:gloo,cuda:nccl"`: CPU tensors reduce through gloo,
    CUDA tensors through NCCL.
  * `all_reduce_sum(t, group)` — an in-place sum over the group;
    `all_reduce_mean(t, group)` — its differentiable mean (the
    reference's `pmean`), whose backward is the mean of the incoming
    gradients;
  * `all_to_all(t, group)` — `all_to_all_single` with equal splits over
    dim 0, differentiable: its backward is the reverse all-to-all
    (which, with equal splits, is the same exchange).

Each runs as the functional collective of `torch.ops._c10d_functional`
(`all_reduce_`, `all_to_all_single`, then `wait_tensor`): on gloo and
NCCL the same exchange as `dist.all_reduce` / `dist.all_to_all_single`,
and on the dry run's fake group over `meta` tensors an op that the dry
run's `CostMode` records as the collective it is. Every collective
counts itself and its bytes in `COLLECTIVES` (reset and read like
`kernels.ops.LAUNCHES`), and refuses a CUDA tensor on a group whose
CUDA backend is not NCCL: a CUDA tensor never goes through gloo.

And what the dry run needs (`repro_torch.launch.dryrun`):

  * `abstract_mesh(axis_sizes, axis_names)` — a device-free mesh: axis
    names, a name -> size `shape` and the device count, all that the
    partition specs read (the reference's `jax.sharding.AbstractMesh`);
  * `device_mesh(mesh)` — a `DeviceMesh` of its shape over torch's
    `"fake"` process group (no communication; collectives return at
    once), for DTensors whose shards lie on the `meta` device. It makes
    the group if the process has none, and refuses one of another size
    or backend: the dry run owns its process, as the reference's does
    (its XLA flag precedes every jax import). The fake group's store
    lives in a private torch module (`torch.testing._internal`), imported
    here only, so that a move between torch versions touches this file.
"""
from __future__ import annotations

import dataclasses
import datetime
import math

import torch
import torch.distributed as dist

# Seconds a collective waits for the other ranks before it raises.
TIMEOUT = datetime.timedelta(seconds=60)

COLLECTIVES = {"all_reduce": 0, "all_to_all": 0, "all_reduce_bytes": 0,
               "all_to_all_bytes": 0}


def reset_collectives() -> None:
    for name in COLLECTIVES:
        COLLECTIVES[name] = 0


def default_group(device: str | torch.device | None = None):
    """The default process group, initialised as a one-rank group if the
    program has none. On a CUDA `device` the card is made current first
    and passed as the group's `device_id` (NCCL binds to it)."""
    if dist.is_initialized():
        return dist.group.WORLD
    device = torch.device(device) if device is not None else None
    kw = {}
    if torch.cuda.is_available() and dist.is_nccl_available():
        backend = "cpu:gloo,cuda:nccl"
        if device is not None and device.type == "cuda":
            torch.cuda.set_device(device)
            kw["device_id"] = torch.device(
                "cuda", torch.cuda.current_device())
    else:
        backend = "cpu:gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1, timeout=TIMEOUT, **kw)
    return dist.group.WORLD


def backend_for(t: torch.Tensor, group) -> str:
    """The backend `group` runs `t`'s collectives on; raises for a CUDA
    tensor unless that backend is NCCL. A `meta` tensor (a dry-run
    shard) goes through the fake group's backend and no other."""
    config = dict(part.split(":") for part in
                  dist.get_backend_config(group).split(","))
    name = config.get(t.device.type)
    if t.device.type == "meta" and "fake" in config.values():
        name = "fake"
    if t.is_cuda and name != "nccl":
        raise RuntimeError(
            f"collective on a CUDA tensor needs an NCCL backend; the group "
            f"runs {dist.get_backend_config(group)!r}")
    if name is None:
        raise RuntimeError(f"the group has no backend for {t.device.type} "
                           f"tensors ({dist.get_backend_config(group)!r})")
    return name


_FUNCTIONAL = torch.ops._c10d_functional


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """Sum `t` over the group, in place; returns `t`."""
    backend_for(t, group)
    _FUNCTIONAL.wait_tensor(_FUNCTIONAL.all_reduce_(t, "sum",
                                                    group.group_name))
    COLLECTIVES["all_reduce"] += 1
    COLLECTIVES["all_reduce_bytes"] += t.numel() * t.element_size()
    return t


class _AllReduceMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_sum(t.clone(), group) / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_sum(g.clone(), ctx.group)
        return g / dist.get_world_size(ctx.group), None


def all_reduce_mean(t: torch.Tensor, group) -> torch.Tensor:
    """The group's mean of `t` on every rank (the reference's `pmean`),
    differentiable."""
    return _AllReduceMean.apply(t, group)


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    backend_for(t, group)
    split = [t.shape[0] // dist.get_world_size(group)] * \
        dist.get_world_size(group)
    out = _FUNCTIONAL.wait_tensor(_FUNCTIONAL.all_to_all_single(
        t.contiguous(), split, split, group.group_name))
    COLLECTIVES["all_to_all"] += 1
    COLLECTIVES["all_to_all_bytes"] += t.numel() * t.element_size()
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_to_all(t, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Rank r's `t[j]` goes to rank j's `out[r]`: dim 0 (of the group's
    size) is split evenly, one chunk for each rank. Differentiable."""
    if t.shape[0] % dist.get_world_size(group):
        raise ValueError(f"all_to_all: dim 0 ({t.shape[0]}) is not a "
                         f"multiple of the group size "
                         f"{dist.get_world_size(group)}")
    return _AllToAll.apply(t, group)


# ----------------------------------------------------------------------- #
# Device-free meshes for the dry run
# ----------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh without devices: what the partition specs read of one."""

    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"{self.axis_sizes} sizes for "
                             f"{self.axis_names} axes")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, in mesh order."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        """The number of devices."""
        return math.prod(self.axis_sizes)


def abstract_mesh(axis_sizes: tuple[int, ...],
                  axis_names: tuple[str, ...]) -> AbstractMesh:
    """Device-free mesh for symbolic runs (the reference's)."""
    return AbstractMesh(tuple(int(n) for n in axis_sizes), tuple(axis_names))


def device_mesh(mesh: AbstractMesh):
    """A `DeviceMesh` of `mesh`'s shape and axis names over a fake
    process group of `mesh.size` ranks, this process rank 0; None for a
    one-device mesh (no group is made: plain tensors stand for it)."""
    if mesh.size == 1:
        return None
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        backend, world = dist.get_backend(), dist.get_world_size()
        if backend != "fake" or world != mesh.size:
            raise RuntimeError(
                f"device_mesh: this process already has a {backend!r} "
                f"group of {world} ranks; a {mesh.size}-device dry-run mesh "
                "needs a fake group of its own (run the dry run in a "
                "process of its own)")
    else:
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=mesh.size)
    # A mesh of H100s: DTensor plans its collectives for "cuda" meshes
    # (on a "cpu" one it would gather where the card exchanges shards
    # all-to-all); no CUDA tensor is made, the shards lie on `meta`.
    return init_device_mesh("cuda", mesh.axis_sizes,
                            mesh_dim_names=mesh.axis_names)
