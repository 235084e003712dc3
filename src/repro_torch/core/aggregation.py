"""Server-side aggregation math (paper Eq. 1). Port of `repro.core.aggregation`.

Client models arrive as one stacked (K, P) flat buffer and the global
model is a (P,) buffer, so both reductions are one `fedagg` launch: the
weighted average in the kernel's plain form, FedBuff's
staleness-discounted delta update in its delta form. A batch of scenarios
(`weighted_delta_update_batched`: (S, C, P) returns, (S, P) models) is
one launch of the kernel's batched delta form.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ops import fedagg_op


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
