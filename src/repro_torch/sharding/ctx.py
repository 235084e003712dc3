"""Expert-parallel context. Port of the part of `repro.sharding.ctx`
that runs on the port: `expert_parallel` and `ep_axis`.

Model code is group-agnostic; a launcher declares the process group that
carries expert parallelism before it runs the model, and the MoE layers
(`repro_torch.models.lm.transformer`) read it: under a declared context a
routed-expert layer over full sequences dispatches its tokens with one
all-to-all each way (`models.lm.moe.apply_moe_ep`). Without one (the
default) they dispatch row-locally.
"""
from __future__ import annotations

import contextlib
import contextvars

_EP: contextvars.ContextVar = contextvars.ContextVar("expert_parallel",
                                                     default=None)


@contextlib.contextmanager
def expert_parallel(group):
    """Declare `group` as the expert-parallel axis for the enclosed
    calls; its size is the group's world size. None disables; layers
    then dispatch row-locally.

    The reference also takes a mesh axis name and a size; a process
    group has one axis and one size, so neither is taken here."""
    token = _EP.set(group)
    try:
        yield
    finally:
        _EP.reset(token)


def ep_axis():
    """The process group of the declared expert-parallel context, or
    None."""
    return _EP.get()
