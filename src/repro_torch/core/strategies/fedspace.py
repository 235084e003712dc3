"""FedSpaceSat — contact-schedule-aware aggregation scheduling.

FedSpace (So et al., arXiv 2202.01267) observes that in orbital FL the
server *knows* the future: ground passes are deterministic, so the
choice of when to aggregate a partially filled buffer can weigh the
idle time of waiting for more uploads against the staleness cost of
aggregating early — per schedule, not per heuristic.

This reduced form keeps FedBuff's client regime and staleness-discounted
delta aggregation (so it rides the same mesh / batched aggregation
family) and replaces the fixed size-D flush barrier with a
schedule-aware rule:

  * a full buffer always flushes (FedBuff's barrier is the ceiling);
  * a partial buffer flushes early when the contact schedule says the
    next upload is more than `max_wait_s` away — satellites re-download
    a *fresh* global model at their next pass instead of training
    another lap against a stale one;
  * a connectivity lull (no satellite sees any station for longer than
    `max_wait_s`, per the `ContactOutlook`) forces the flush for the
    same reason;
  * when nothing more is in flight the tail is flushed rather than
    dropped.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.strategies.base import BufferState
from repro_torch.core.strategies.fedbuff import FedBuffSat


@dataclasses.dataclass(frozen=True)
class FedSpaceSat(FedBuffSat):
    name: str = "fedspace"
    # Longest the server will sit on a nonempty buffer waiting for the
    # next scheduled upload before aggregating early (~4 LEO orbits).
    max_wait_s: float = 6 * 3600.0

    def should_flush(self, state: BufferState, outlook) -> bool:
        if len(state.updates) >= state.target_size:
            return True
        if not state.updates:
            return False
        if state.next_arrival_s is None:
            return True      # nothing more in flight: don't drop the tail
        if state.next_arrival_s - state.now > self.max_wait_s:
            return True      # next upload too far out: aggregate early
        lull = outlook.next_contact_s(state.now)
        return lull is not None and lull - state.now > self.max_wait_s
