"""Plain / momentum SGD (the satellites' on-board optimizer).

Port of `repro.optim.sgd` over the port's param trees (nested dicts and
the LM's `"segments"` list of tensors). `sgd_update` returns new tensors
as the reference does; `momentum_update` does too.
"""
from __future__ import annotations

import torch

from repro_torch.models.lm.params import map_tree


@torch.no_grad()
def sgd_update(params, grads, lr: float):
    return map_tree(lambda p, g: p - lr * g.to(p.dtype), params, grads)


def momentum_init(params):
    return map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


@torch.no_grad()
def momentum_update(params, grads, state, lr: float, beta: float = 0.9):
    new_state = map_tree(lambda m, g: beta * m + g.float(), state, grads)
    new_params = map_tree(lambda p, m: (p.float() - lr * m).to(p.dtype),
                          params, new_state)
    return new_params, new_state
