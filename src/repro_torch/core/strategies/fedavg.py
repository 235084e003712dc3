"""FedAvgSat — space-ified FedAvg (paper Algorithm 1).

Satellite-specific changes vs terrestrial FedAvg (McMahan et al. 2017):
  * clients are the first `c = min(C, K)` *idle* satellites to contact any
    ground station (no random sampling — every pass is precious);
  * a round completes only after *every* selected satellite has re-contacted
    a ground station and returned its parameters;
  * clients train a fixed number of local epochs E, then idle until their
    next pass (the idle time Figure 9a quantifies).
Aggregation itself is unchanged: the Eq. 1 weighted average.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.strategies.base import ClientWorkMode, Strategy


@dataclasses.dataclass(frozen=True)
class FedAvgSat(Strategy):
    name: str = "fedavg"
    work_mode: ClientWorkMode = ClientWorkMode.FIXED_EPOCHS
    synchronous: bool = True
    prox_mu: float = 0.0
