"""ClientUpdate — the on-board local training step (paper Algorithms 1-3).

Port of `repro.core.client`. The reference vmaps one client's masked
`fori_loop` over a stacked client axis; here the client axis is written
out on the flat (C, P) parameter buffer:

  * each local step gathers every client's minibatch, takes the data
    gradient by autograd of `sum_c mean CE_c` (clients are independent,
    so the gradient of the sum is each client's own gradient), and
    applies ONE `prox_sgd` launch over the whole (C, P) buffer;
  * the per-client budget `steps[c]` masks later steps inside the kernel
    (`live = i < steps[c]`); a masked step leaves the row bitwise
    untouched, so the loop stops at `max(steps)`;
  * minibatch indices come in precomputed, (C, bound, B), from the
    engine's sampler (the reference draws them with `jax.random.randint`
    inside the loop).

FedAvg is prox_mu = 0; FedProx / FedBuff anchor on the round's global
model (or, for FedBuff, each client's download version) with prox_mu > 0.
A batch of scenarios (`repro_torch.sim.batched`) stacks every scenario's
clients as rows of one buffer, with one prox_mu per row and one anchor
row per scenario (or per client), still one launch per local step.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import prox_sgd_op
from repro_torch.params import FEMNIST_MLP, ParamLayout


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-sample cross-entropy over the last axis; labels are int64."""
    flat = F.cross_entropy(logits.flatten(0, -2), labels.flatten(),
                           reduction="none")
    return flat.view(labels.shape)


def classification_loss(apply_fn: Callable) -> Callable:
    """Mean cross-entropy over logits, per client: (..., B) -> (...)."""

    def loss_fn(params: dict, xb: torch.Tensor, yb: torch.Tensor):
        return cross_entropy(apply_fn(params, xb), yb).mean(-1)

    return loss_fn


def vmapped_client_update(loss_fn: Callable, *, lr: float = 0.05,
                          batch_size: int = 32, max_steps: int = 64,
                          layout: ParamLayout = FEMNIST_MLP) -> Callable:
    """ClientUpdate over an explicit client axis.

    Returns fn(params0, anchor, x, y, steps, prox_mu, idx) -> params:
      params0: (C, P) start params (not modified);
      anchor:  (P,) shared anchor (sync barrier), (C, P) per client, or
               (G, P) with C % G == 0, row c anchoring on row c // (C / G)
               (one anchor per scenario of a batch);
      x: (C, N, *sample_shape); y: (C, N) int64;
      steps: C ints <= max_steps (host side);
      prox_mu: a float, or a (C,) float32 tensor on params0's device;
      idx: (C, >= max(steps), batch_size) int64 minibatch indices.
    `loss_fn(views, xb, yb)` returns the (C,) per-client data losses.
    """

    def client_update(params0: torch.Tensor, anchor: torch.Tensor,
                      x: torch.Tensor, y: torch.Tensor,
                      steps: Sequence[int], prox_mu: float | torch.Tensor,
                      idx: torch.Tensor) -> torch.Tensor:
        steps = [int(s) for s in steps]
        if max(steps, default=0) > max_steps:
            raise ValueError(f"steps {steps} exceed max_steps={max_steps}")
        n_live = max(steps, default=0)
        if idx.shape[0] != len(steps) or idx.shape[1] < n_live \
                or idx.shape[2] != batch_size:
            raise ValueError(f"idx {tuple(idx.shape)} does not cover "
                             f"{len(steps)} clients x {n_live} steps x "
                             f"{batch_size}")
        dev = params0.device
        steps_t = torch.tensor(steps, dtype=torch.int32, device=dev)
        rows = torch.arange(len(steps), device=dev)[:, None]
        # A private copy that the steps update in place; the caller's
        # params0 (often the global model's broadcast) stays untouched.
        params = params0.detach().clone(
            memory_format=torch.contiguous_format).requires_grad_(True)
        for i in range(n_live):
            xb = x[rows, idx[:, i]]                       # (C, B, ...)
            yb = y[rows, idx[:, i]]                       # (C, B)
            loss = loss_fn(layout.views(params), xb, yb).sum()
            (g,) = torch.autograd.grad(loss, params)
            with torch.no_grad():
                prox_sgd_op(params, g, anchor, steps_t, i, lr, prox_mu)
        return params.detach()

    return client_update


def make_batched_client_update(apply_fn: Callable, lr: float = 0.05,
                               batch_size: int = 32, max_steps: int = 64, *,
                               layout: ParamLayout = FEMNIST_MLP) -> Callable:
    """Seed-contract convenience: `vmapped_client_update` with the
    cross-entropy data term of an image classifier's `apply_fn`, over
    the flat (C, P) client stack (the reference jits its vmapped form).
    Called as `vmapped_client_update`'s result is."""
    return vmapped_client_update(classification_loss(apply_fn), lr=lr,
                                 batch_size=batch_size, max_steps=max_steps,
                                 layout=layout)


def make_client_update(apply_fn: Callable | None = None, lr: float = 0.05,
                       batch_size: int = 32, max_steps: int = 64, *,
                       loss_fn: Callable | None = None,
                       layout: ParamLayout = FEMNIST_MLP) -> Callable:
    """ClientUpdate for ONE client (the client axis of
    `vmapped_client_update` at size 1).

    Provide `apply_fn` (classification: cross-entropy over logits) or a
    `loss_fn(views, xb, yb)` with a leading client axis. Returns
    fn(params0 (P,), anchor (P,), x (N, ...), y (N,), steps: int,
    prox_mu, idx (steps, B)) -> params (P,).
    """
    if loss_fn is None:
        if apply_fn is None:
            raise ValueError("make_client_update needs apply_fn or loss_fn")
        loss_fn = classification_loss(apply_fn)
    stacked = vmapped_client_update(loss_fn, lr=lr, batch_size=batch_size,
                                    max_steps=max_steps, layout=layout)

    def client_update(params0, anchor, x, y, steps, prox_mu, idx):
        return stacked(params0[None], anchor, x[None], y[None], [steps],
                       prox_mu, idx[None])[0]

    return client_update


@torch.no_grad()
def evaluate(apply_fn: Callable, params: torch.Tensor, x: torch.Tensor,
             y: torch.Tensor, n_valid: torch.Tensor,
             layout: ParamLayout = FEMNIST_MLP) -> torch.Tensor:
    """Weighted accuracy over stacked eval clients.

    params: (P,); x: (K, N, ...); y: (K, N); n_valid: (K,). Returns a
    0-d float32 tensor.
    """
    K, N = y.shape
    logits = apply_fn(layout.views(params), x.flatten(0, 1))  # (K*N, classes)
    correct = (logits.argmax(-1).view(K, N) == y).float()
    mask = (torch.arange(N, device=x.device)[None, :]
            < n_valid[:, None]).float()
    return (correct * mask).sum() / torch.clamp(mask.sum(), min=1.0)
