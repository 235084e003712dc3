"""GroundAssistedSat — per-visit synchronous aggregation at the station.

Ground-assisted orbital FL (Razmi et al., arXiv 2109.01348) keeps the
synchronous weighted-average aggregation but drops the all-clients
barrier: the ground segment aggregates whatever subset of scheduled
returns has arrived by the end of a station visit, rather than holding
the round open until the slowest satellite's next pass. Satellites
train across their inter-pass gaps (UNTIL_CONTACT regime, like
FedProx), and a selection whose returns straddle several visits
produces several partial aggregations — each one a RoundRecord.

Two hooks express this on top of the stock sync event feed:

  * `should_flush` closes the partial set whenever the gap to the next
    scheduled return exceeds `visit_gap_s` (the arrivals of one station
    visit cluster within minutes; the next visit is tens of minutes to
    hours away);
  * `next_sync_point` anchors each round's clock at the constellation's
    next ground contact (per the `ContactOutlook`), so reported idle
    time measures waiting *within* the protocol rather than the
    dead time before any station is visible.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.strategies.base import (
    BufferState,
    ClientWorkMode,
    Strategy,
)


@dataclasses.dataclass(frozen=True)
class GroundAssistedSat(Strategy):
    name: str = "ground_assisted"
    work_mode: ClientWorkMode = ClientWorkMode.UNTIL_CONTACT
    synchronous: bool = True
    prox_mu: float = 0.0
    # Returns further apart than this belong to different station
    # visits and aggregate separately (15 min ≈ the upper end of one
    # LEO pass).
    visit_gap_s: float = 900.0

    def should_flush(self, state: BufferState, outlook) -> bool:
        del outlook
        if len(state.updates) >= state.target_size:
            return True
        if not state.updates:
            return False
        if state.next_arrival_s is None:
            return True      # last scheduled return: close the visit
        return state.next_arrival_s - state.now > self.visit_gap_s

    def next_sync_point(self, outlook, t: float) -> float:
        nxt = outlook.next_contact_s(t)
        return t if nxt is None else max(t, nxt)
