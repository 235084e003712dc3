"""Server-side aggregation math (paper Eq. 1). Port of `repro.core.aggregation`.

Client models arrive as one stacked (K, P) flat buffer and the global
model is a (P,) buffer, so both reductions are one `fedagg` launch: the
weighted average in the kernel's plain form, FedBuff's
staleness-discounted delta update in its delta form. A batch of scenarios
(`weighted_delta_update_batched`: (S, C, P) returns, (S, P) models) is
one launch of the kernel's batched delta form.

The mesh round's forms (`masked_delta_allreduce` for a rank's block of
clients, `participation_masked_psum` for one pod's update tree) sum over
the ranks of a `ClientMesh` (`repro_torch.sharding`): the weights' total
first, then the weighted deltas, as one flat bucket each.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ops import fedagg_op
from repro_torch.models.lm.params import map_tree
from repro_torch.sharding.compat import all_reduce_sum


def normalized_weights(weights: torch.Tensor) -> torch.Tensor:
    """n_k / m_t with a zero-sum guard (all-zero weights stay zero, so a
    delta update of an empty round keeps the old model)."""
    weights = torch.as_tensor(weights, dtype=torch.float32)
    total = weights.sum()
    return torch.where(total > 0, weights / torch.clamp(total, min=1e-12),
                       weights)


def weighted_average(stacked: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """w <- sum_k (n_k / m) w_k over the leading (client) axis."""
    w = normalized_weights(weights).to(stacked.device)
    return fedagg_op(stacked, w)


def staleness_discount(staleness) -> torch.Tensor:
    """FedBuff's staleness discount s(tau) = 1/sqrt(1+tau)."""
    return 1.0 / torch.sqrt(1.0 + torch.as_tensor(staleness,
                                                  dtype=torch.float32))


def admission_weights(ns, staleness, max_staleness: int):
    """FedBuff admission rule: updates staler than the bound get zero
    weight. Works on numpy arrays or tensors (`ns` are raw sample counts)."""
    admit = staleness <= max_staleness
    return ns * admit


def weighted_delta_update(global_params: torch.Tensor, stacked: torch.Tensor,
                          weights: torch.Tensor, staleness: torch.Tensor,
                          server_lr: float = 1.0) -> torch.Tensor:
    """Buffered-async update (FedBuff):

        w <- w + lr_g * sum_k s(tau_k) * (n_k/m) * (w_k - w)

    with s(tau) = 1/sqrt(1+tau). Weights of inadmissible (over-stale)
    clients must already be zeroed.
    """
    disc = staleness_discount(staleness)
    w = normalized_weights(torch.as_tensor(weights, dtype=torch.float32)
                           * disc).to(stacked.device)
    return fedagg_op(stacked, w, base=global_params, scale=server_lr)


def weighted_delta_update_batched(global_params: torch.Tensor,
                                  stacked: torch.Tensor,
                                  weights: list, staleness: list,
                                  server_lr: torch.Tensor,
                                  delta: list[bool]) -> torch.Tensor:
    """One round's server update for every scenario of a batch, in one
    launch of the kernel's batched form.

    global_params (S, P); stacked (S, C, P) client returns, scenario s's
    first len(weights[s]) rows live and the rest padding; weights[s],
    staleness[s]: scenario s's (n_s,) sample counts and staleness on the
    device, as `weighted_average` / `weighted_delta_update` take them;
    server_lr (S,) float32. A scenario with `delta[s]` takes FedBuff's
    `weighted_delta_update` (a round of no clients keeps its params: the
    zero-total guard leaves all-zero weights); the others take the
    synchronous `weighted_average`, as the delta form from a zero base at
    server_lr 1 (x - 0 and 0 + acc are exact). Each scenario's weights are
    normalized with the single-scenario ops on its own clients, so every
    scenario's update is bitwise the one its own run would make.
    """
    S, C, _ = stacked.shape
    rows = []
    for s in range(S):
        if delta[s]:
            w = normalized_weights(
                torch.as_tensor(weights[s], dtype=torch.float32)
                * staleness_discount(staleness[s]))
        else:
            w = normalized_weights(weights[s])
        rows.append(torch.nn.functional.pad(w.to(stacked.device),
                                            (0, C - w.shape[0])))
    plain = torch.tensor([not d for d in delta], device=stacked.device)
    base = torch.where(plain[:, None], 0.0, global_params)
    return fedagg_op(stacked, torch.stack(rows), base=base,
                     scale=torch.where(plain, 1.0, server_lr))


def _masked_scale(weights: torch.Tensor, mesh) -> torch.Tensor:
    """w_k / sum_j w_j with the total taken over every rank of `mesh`,
    0 where the total is 0 (an empty round keeps the old model)."""
    weights = torch.as_tensor(weights, dtype=torch.float32)
    total = all_reduce_sum(weights.sum().reshape(1), mesh.group)[0]
    return torch.where(total > 0, weights / torch.clamp(total, min=1e-12),
                       torch.zeros_like(weights))


def masked_delta_allreduce(global_params: torch.Tensor,
                           stacked: torch.Tensor, weights: torch.Tensor,
                           mesh, server_lr: float = 1.0,
                           delta: bool = True) -> torch.Tensor:
    """The mesh form of the server update, for a rank holding a block of
    clients: global_params (P,), stacked (C_local, P) client returns,
    weights the matching (C_local,) block.

        w <- w + lr_g * sum_k (w_k / sum_j w_j) * (p_k - w)

    with the weight total and the weighted deltas summed over every rank
    of `mesh` (two all-reduces), so masking (weight 0) and the empty-round
    guard are global. The block's weighted deltas are one launch of the
    `fedagg` kernel's partial form over the flat buffer (one bucket,
    whatever the model's tree). With discounted weights and lr_g this is
    `weighted_delta_update`.

    With `delta` False it is Eq. 1 as `weighted_average` computes it,
    sum_k (w_k / sum_j w_j) * p_k (the block's share through the kernel's
    plain form, then the all-reduce; lr_g unused; no weight at all gives
    0, as there): the same function for weights summing over
    participants, rounded as the host path rounds it, so a one-rank round
    is bitwise the host's. Local training
    amplifies a last-bit difference in the model (c10s10/g13, fedprox: 6e-8
    after one round, 5e-3 after 20), so only the same rounding keeps a
    long run on the host path's trajectory."""
    scale = _masked_scale(torch.as_tensor(weights).to(stacked.device), mesh)
    if not delta:
        return all_reduce_sum(fedagg_op(stacked, scale), mesh.group)
    part = fedagg_op(stacked, scale, base=global_params, partial=True)
    return global_params + server_lr * all_reduce_sum(part, mesh.group)


def participation_masked_psum(update, weight: torch.Tensor, mesh):
    """Each rank of `mesh` is one pod; `weight` is its 0-d participation
    weight (n_k, or 0 for a pod with no contact this round). Returns, on
    every rank, sum over pods of (w_k / sum_j w_j) * update_k for an
    update tree (dicts, lists, tensors): the leaves of each dtype go
    through one all-reduce as one flat bucket."""
    leaves: list[torch.Tensor] = []
    map_tree(leaves.append, update)
    scale = _masked_scale(torch.as_tensor(weight).to(leaves[0].device)
                          .reshape(1), mesh)[0]
    out: dict[int, torch.Tensor] = {}
    for dtype in dict.fromkeys(t.dtype for t in leaves):
        idx = [i for i, t in enumerate(leaves) if t.dtype == dtype]
        bucket = torch.cat([leaves[i].reshape(-1) for i in idx])
        bucket *= scale.to(device=bucket.device, dtype=dtype)
        all_reduce_sum(bucket, mesh.group)
        for i, piece in zip(idx, torch.split(
                bucket, [leaves[i].numel() for i in idx])):
            out[i] = piece.view(leaves[i].shape)
    order = iter(range(len(leaves)))
    return map_tree(lambda _: out[next(order)], update)
