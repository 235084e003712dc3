"""The federated round, written out plainly: what the reference computes
for the round that the program's `fl_round` driver times.

A round takes the global weights as the pod's anchor p0 and runs
`local_steps` steps of proximal SGD on the pod's batch,

    p <- p - lr (g + mu (p - p0)),   g = d loss / dp at p,

then sets the global weights to p0 + server_lr sum_k (w_k / sum_j w_j)
(p_k - p0) over the pods. The loss is the mean next-token cross-entropy
of the model's `loss_sum`. Gradients, losses and the update arithmetic
are float32 (TF32 off); the weights are held between steps in the
configuration's parameter type, as the configuration states ("bf16
parameters and update": no float32 master copy), so each update is
rounded to that type as it is stored.

The loss and gradient of a batch are computed in blocks of rows, each
block's summed cross-entropy over the batch's token count, so that the
gradient of a full-width batch fits beside the weights.
"""
from __future__ import annotations

import torch

ROWS_PER_BLOCK = 2


def _items(tree, prefix=""):
    if isinstance(tree, dict):
        return [it for k in sorted(tree) for it in _items(tree[k],
                                                         f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [it for i, v in enumerate(tree)
                for it in _items(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def _build(tree, leaves):
    it = iter(leaves)

    def rec(t):
        if isinstance(t, dict):
            return {k: rec(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [rec(v) for v in t]
        return next(it)
    return rec(tree)


def loss_and_grads(loss_sum, cfg: dict, weights: list, layout, tokens,
                   mm):
    """Mean next-token loss of `tokens` (B, S) and its float32 gradient
    in each of `weights` (float32 leaves in `_items` order)."""
    B, S = tokens.shape
    count = B * (S - 1)
    total = torch.zeros((), dtype=torch.float64, device=tokens.device)
    grads = [torch.zeros_like(w) for w in weights]
    for lo in range(0, B, ROWS_PER_BLOCK):
        leaves = [w.detach().requires_grad_(True) for w in weights]
        loss = loss_sum(cfg, _build(layout, leaves),
                        tokens[lo:lo + ROWS_PER_BLOCK], mm) / count
        for acc, g in zip(grads, torch.autograd.grad(loss, leaves)):
            acc += g
        total += loss.detach().double()
        del loss, leaves
    return float(total), grads


def run_rounds(loss_sum, cfg: dict, params0, batches: list, *, lr: float,
               prox_mu: float, local_steps: int, server_lr: float,
               pod_weights: list, param_dtype: torch.dtype, mm) -> dict:
    """The rounds over `batches` from `params0` (a tree in the program's
    layout, any float type) with one pod. Returns {"losses": each local
    step's loss in order, "grad_norms": each leaf's first-step gradient
    norm, "change_norms": after each round, each leaf's norm of (global
    weights - params0), "moved": after each round, each leaf's count of
    elements that differ from params0, "paths": the leaves' paths in
    `_items` order}."""
    if len(pod_weights) != 1:
        raise ValueError("the reference runs one pod a round")
    paths = [p for p, _ in _items(params0)]
    glob = [t.to(param_dtype) for _, t in _items(params0)]
    start = glob
    share = pod_weights[0] / sum(pod_weights)
    losses, grad_norms, changes, moved = [], None, [], []
    for tokens in batches:
        anchor = [t.float() for t in glob]
        local = glob
        for _ in range(local_steps):
            cur = [t.float() for t in local]
            loss, grads = loss_and_grads(loss_sum, cfg, cur, params0, tokens,
                                         mm)
            losses.append(loss)
            if grad_norms is None:
                grad_norms = [float(g.double().norm()) for g in grads]
            local = [(p - lr * (g + prox_mu * (p - p0))).to(param_dtype)
                     for p, g, p0 in zip(cur, grads, anchor)]
            del cur, grads
        glob = [(p0 + server_lr * share * (p.float() - p0)).to(param_dtype)
                for p, p0 in zip(local, anchor)]
        del anchor, local
        changes.append([float((p.float() - p0.float()).double().norm())
                        for p, p0 in zip(glob, start)])
        moved.append([int((p != p0).sum()) for p, p0 in zip(glob, start)])
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": changes, "moved": moved, "paths": paths}
