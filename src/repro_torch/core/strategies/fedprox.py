"""FedProxSat — space-ified FedProx (paper Algorithm 2).

FedProx (Li et al. 2020) tolerates *partial work*: a client may run any
number of local steps, with a proximal term (mu/2)||w - w_t||^2 anchoring
the local model to the round's global parameters. In orbit this is the
natural fit for heterogeneous revisit times: a satellite trains **until it
next reaches a ground station** instead of idling after E epochs.

Server aggregation is the same Eq. 1 weighted average; the difference
lives entirely in the client regime (`work_mode=UNTIL_CONTACT`, prox_mu>0)
and, for the SchedV2 augmentation, a minimum-epoch floor enforced by the
simulator before a satellite is allowed to return parameters.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.strategies.base import ClientWorkMode, Strategy


@dataclasses.dataclass(frozen=True)
class FedProxSat(Strategy):
    name: str = "fedprox"
    work_mode: ClientWorkMode = ClientWorkMode.UNTIL_CONTACT
    synchronous: bool = True
    prox_mu: float = 0.1
