"""AdamW on the port's param trees.

Port of `repro.optim.adam`: f32 moments whatever the param dtype, the
update computed in f32 and cast back to the param's dtype, bias
corrections from an int32 step count. Unlike the reference, which
returns new arrays, `adam_update` writes the moments and the params in
place (and returns them): at full width the moments alone are 8 bytes a
parameter, and a second copy of them would not fit beside the
activations.
"""
from __future__ import annotations

import torch

from repro_torch.models.lm.params import map_tree, tree_leaves


def adam_init(params):
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return {"mu": map_tree(zeros, params), "nu": map_tree(zeros, params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=tree_leaves(params)[0].device)}


@torch.no_grad()
def adam_update(params, grads, state, lr: float = 3e-4, b1: float = 0.9,
                b2: float = 0.95, eps: float = 1e-8,
                weight_decay: float = 0.0):
    """One AdamW step; params, state["mu"] and state["nu"] are updated in
    place. Returns (params, state)."""
    step = state["step"] + 1
    t = step.float()
    c1 = 1.0 - b1 ** t
    c2 = 1.0 - b2 ** t

    def upd(p, g, m, v):
        g32 = g.float()
        m.mul_(b1).add_((1 - b1) * g32)
        v.mul_(b2).add_((1 - b2) * torch.square(g32))
        u = (m / c1) / (torch.sqrt(v / c2) + eps)
        if weight_decay:
            u = u + weight_decay * p.float()
        p.copy_((p.float() - lr * u).to(p.dtype))

    map_tree(upd, params, grads, state["mu"], state["nu"])
    return params, {"mu": state["mu"], "nu": state["nu"], "step": step}
