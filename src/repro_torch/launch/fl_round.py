"""The federated round as a collective — the paper's technique, mesh-native.

Port of `repro.launch.fl_round`. Each participating satellite is a pod
slot on the "pod" axis of a `ClientMesh` (the ranks of a
`torch.distributed` process group: NCCL for CUDA tensors, gloo for CPU
ones); a round's aggregation (Eq. 1) is a *masked* weighted all-reduce
across that axis: satellites with no ground contact this round
contribute zero weight, which is FedBuff's buffer semantics expressed as
a dense collective instead of point-to-point sends.

Two builders, one collective:

  * `make_fl_round_step` — the launch-style contract: a dict batch (its
    leading dim split over the pods) and one SGD stream per pod, one pod
    per rank. Any `loss_fn(params, batch)` works; local steps may vary
    per pod, and weights follow FedBuff's semantics (staleness discount
    and server lr), so sync rounds and buffer flushes are the same
    collective.
  * `make_mesh_round_step` — the simulator's contract: every argument
    carries the padded pod axis; each rank trains its contiguous block
    of slots as one client stack (`vmapped_client_update`, one
    `prox_sgd` launch a local step), then `masked_delta_allreduce` folds
    every block into the global model (one `fedagg` launch and two
    all-reduces), so `ConstellationSim(..., execution="mesh")` matches
    the host path client for client on any number of ranks, and bit for
    bit on one.

Every rank makes the same call with the same global arguments; each
moves only its own pods' rows to its device. Deviation: in
`make_fl_round_step` the number of pods must equal the group's size
(the reference's pod body reads the first pod's weight, steps and
staleness, so more pods than ranks would train a rank's whole block as
one pod); the call raises otherwise.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.comms.codec import client_roundtrip
from repro_torch.core.aggregation import (
    masked_delta_allreduce,
    participation_masked_psum,
    staleness_discount,
)
from repro_torch.core.client import vmapped_client_update
from repro_torch.models.lm.params import map_tree, tree_leaves
from repro_torch.params import FEMNIST_MLP, ParamLayout
from repro_torch.sharding.flmesh import ClientMesh, client_mesh

# Rank of each launch-style batch key (leading dim split over the pods).
BATCH_DIMS = {"tokens": 2, "prefix_embeds": 3, "enc_embeds": 3}


def _workload_loss(workload) -> tuple[Callable, dict[str, int]]:
    """A `Workload`'s per-client loss as `loss_fn(flat_params, batch)` on
    one model, and its dict-batch schema: the first key feeds the sample
    stream, an optional "labels" key the targets (classification
    workloads default to {"x": ..., "labels": 1})."""
    dims = dict(workload.mesh_batch_dims or
                {"x": 1 + len(workload.sample_shape), "labels": 1})
    x_key = next(iter(dims))
    layout = workload.layout

    def as_index(t):
        return t.long() if t is not None and not t.is_floating_point() \
            else t

    def loss_fn(params: torch.Tensor, batch: dict) -> torch.Tensor:
        xb, yb = as_index(batch[x_key]), as_index(batch.get("labels"))
        return workload.loss_fn(layout.views(params[None]), xb[None],
                                None if yb is None else yb[None])[0]

    return loss_fn, dims


def make_fl_round_step(cfg=None, mesh: ClientMesh | None = None,
                       lr: float = 1e-3, local_steps: int = 1,
                       prox_mu: float = 0.0, *, loss_fn=None, workload=None,
                       server_lr: float = 1.0,
                       batch_dims: dict[str, int] | None = None):
    """One federated round: every pod runs up to `local_steps` of
    (proximal) SGD on its own shard of the batch, then the global model
    takes the participation-masked weighted average of the pod deltas.

    The loss comes from one of three sources:
      * `cfg` — a `ModelConfig` driving `lm_loss` over a {"tokens": ...}
        batch (params: the model's tree);
      * `loss_fn(params, batch) -> 0-d` — any dict batch and params tree;
      * `workload` — a `Workload`: its `mesh_batch_dims` declare the
        batch schema and its `loss_fn` the math, on its flat (P,) params.
    `batch_dims` maps extra batch keys to their rank.

    Returns ``fn(params, batch, weights, steps=None, staleness=None)``:
      * ``weights`` (n_pods,) — n_k for participating pods, 0 for
        out-of-contact ones; n_pods must equal the mesh's size;
      * ``steps`` (n_pods,) ints cap each pod's live SGD steps (default:
        every pod runs `local_steps`);
      * ``staleness`` (n_pods,) ints apply FedBuff's 1/sqrt(1+tau)
        discount.
    The local update ``p - lr * (g + mu * (p - p0))`` runs in the params'
    dtype with plain torch ops on the tree, as the reference's runs in
    jnp outside any kernel. `params` is not modified. With `mesh` None
    the round runs on `client_mesh(device=...)` of the params' device.
    """
    if loss_fn is None and workload is not None:
        loss_fn, wl_dims = _workload_loss(workload)
        batch_dims = {**wl_dims, **(batch_dims or {})}
    if loss_fn is None:
        if cfg is None:
            raise ValueError(
                "make_fl_round_step needs cfg, loss_fn, or workload")
        from repro_torch.train.step import lm_loss

        def loss_fn(params, batch):
            return lm_loss(cfg, params, batch)[0]

    n_batch_dims = {**BATCH_DIMS, **(batch_dims or {})}

    def round_step(params, batch: dict, weights, steps=None, staleness=None):
        n_pods = len(weights)
        first = tree_leaves(params)[0]
        m = mesh if mesh is not None else client_mesh(device=first.device)
        if n_pods != m.size:
            raise ValueError(
                f"{n_pods} pods on a group of {m.size} ranks: the port runs "
                "one pod per rank")
        r = m.rank
        my_steps = local_steps if steps is None else int(steps[r])
        tau = 0 if staleness is None else int(staleness[r])
        weight = torch.as_tensor(weights[r], dtype=torch.float32,
                                 device=first.device)
        w = weight * staleness_discount(tau).to(first.device)
        shard = {}
        for k, v in batch.items():
            if k not in n_batch_dims:
                raise KeyError(f"batch key {k!r} has no declared rank; pass "
                               "batch_dims")
            if v.dim() != n_batch_dims[k]:
                raise ValueError(f"batch[{k!r}] has rank {v.dim()}, "
                                 f"declared {n_batch_dims[k]}")
            if v.shape[0] % n_pods:
                raise ValueError(f"batch[{k!r}] has {v.shape[0]} rows, not "
                                 f"a multiple of {n_pods} pods")
            rows = v.shape[0] // n_pods
            shard[k] = v[r * rows:(r + 1) * rows].to(first.device)

        anchor = map_tree(lambda p: p.detach(), params)
        local = map_tree(lambda p: p.detach().clone(), params)
        leaves, anchors = tree_leaves(local), tree_leaves(anchor)
        # A masked step (i >= steps) leaves a pod's params unchanged, so
        # the loop stops at the pod's own budget.
        for _ in range(min(local_steps, my_steps)):
            for p in leaves:
                p.requires_grad_(True)
            try:
                grads = torch.autograd.grad(loss_fn(local, shard), leaves)
            finally:
                for p in leaves:
                    p.requires_grad_(False)
            with torch.no_grad():
                for p, g, p0 in zip(leaves, grads, anchors):
                    if prox_mu:
                        g = g + torch.sub(p, p0).mul_(prox_mu)
                    p.sub_(g.mul(lr))
            del grads
        with torch.no_grad():
            delta = map_tree(lambda p, p0: p.sub_(p0), local, anchor)
            agg = participation_masked_psum(delta, w, m)
            return map_tree(lambda p, d: p + d.mul_(server_lr), anchor, agg)

    return round_step


def make_mesh_round_step(loss_fn: Callable, mesh: ClientMesh, *, lr: float,
                         batch_size: int, max_steps: int,
                         server_lr: float = 1.0,
                         layout: ParamLayout = FEMNIST_MLP, codec=None,
                         delta: bool = True):
    """ClientUpdate and aggregation over the mesh, with the simulator's
    contract.

    Returns ``fn(global_params, anchors, x, y, steps, weights, staleness,
    prox_mu, idx, uniforms=None) -> new_global_params`` where
    global_params is (P,) and every per-pod argument carries the padded
    pod axis of n slots, a multiple of the mesh's size (pad with weight 0
    and steps 0: the slot contributes nothing, as an out-of-contact
    satellite): anchors (n, P), or one (P,) anchor every slot shares (the
    sync barrier); x (n, N, ...); y (n, N); steps n ints; weights (n,)
    and staleness (n,); idx (n, >= max(steps), batch_size) minibatch
    indices; uniforms (n, P) for a stochastic codec. Each rank trains its
    block of slots from their anchors, round-trips a lossy `codec`
    against them, discounts the weights by staleness, and joins
    `masked_delta_allreduce`: FedBuff's delta update, or with `delta`
    False the synchronous weighted average (Eq. 1), each rounded as the
    host path's strategy rounds it.
    """
    update = vmapped_client_update(loss_fn, lr=lr, batch_size=batch_size,
                                   max_steps=max_steps, layout=layout)
    lossy = codec is not None and codec.lossy

    def round_step(global_params: torch.Tensor, anchors: torch.Tensor,
                   x: torch.Tensor, y: torch.Tensor, steps: Sequence[int],
                   weights: torch.Tensor, staleness: torch.Tensor,
                   prox_mu: float, idx: torch.Tensor,
                   uniforms: torch.Tensor | None = None) -> torch.Tensor:
        blk = mesh.block(len(steps))
        anchor = anchors if anchors.dim() == 1 else anchors[blk]
        params0 = (anchor.expand(blk.stop - blk.start, -1)
                   if anchor.dim() == 1 else anchor)
        client_params = update(params0, anchor, x[blk], y[blk], steps[blk],
                               prox_mu, idx[blk])
        if lossy:
            client_params = client_roundtrip(
                codec, client_params, anchor, layout,
                None if uniforms is None else uniforms[blk])
        dev = global_params.device
        w = (torch.as_tensor(weights[blk], dtype=torch.float32, device=dev)
             * staleness_discount(staleness[blk]).to(dev))
        return masked_delta_allreduce(global_params, client_params, w, mesh,
                                      server_lr=server_lr, delta=delta)

    return round_step
