"""FedBuffSat — space-ified FedBuff (paper Algorithm 3).

FedBuff (Nguyen et al. 2022) aggregates asynchronously: *every* satellite
trains continuously and uploads whenever it passes a ground station; the
server folds updates into the global model once a buffer of D returns has
filled. Satellites therefore never idle waiting for a round barrier
(Figure 9c) — at the price of *stale* updates, admitted only within a
bounded staleness and discounted by 1/sqrt(1+tau).

Like FedProx, clients use the proximal term to bound local drift.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.aggregation import weighted_delta_update
from repro_torch.core.strategies.base import ClientWorkMode, Strategy


@dataclasses.dataclass(frozen=True)
class FedBuffSat(Strategy):
    name: str = "fedbuff"
    work_mode: ClientWorkMode = ClientWorkMode.UNTIL_CONTACT
    synchronous: bool = False
    prox_mu: float = 0.1
    max_staleness: int = 4
    server_lr: float = 1.0

    def aggregate(self, global_params, client_params, weights: torch.Tensor,
                  staleness: torch.Tensor):
        return weighted_delta_update(
            global_params, client_params, weights, staleness,
            server_lr=self.server_lr)
