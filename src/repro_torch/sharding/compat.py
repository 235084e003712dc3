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

Every collective counts itself and its bytes in `COLLECTIVES` (reset and
read like `kernels.ops.LAUNCHES`), and refuses a CUDA tensor on a group
whose CUDA backend is not NCCL: a CUDA tensor never goes through gloo.
"""
from __future__ import annotations

import datetime

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
    tensor unless that backend is NCCL."""
    config = dict(part.split(":") for part in
                  dist.get_backend_config(group).split(","))
    name = config.get(t.device.type)
    if t.is_cuda and name != "nccl":
        raise RuntimeError(
            f"collective on a CUDA tensor needs an NCCL backend; the group "
            f"runs {dist.get_backend_config(group)!r}")
    if name is None:
        raise RuntimeError(f"the group has no backend for {t.device.type} "
                           f"tensors ({dist.get_backend_config(group)!r})")
    return name


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """Sum `t` over the group, in place; returns `t`."""
    backend_for(t, group)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
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
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
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
