"""Orbital client selection (paper section 3 stage 1 + section 4 augmentations).

Port of `repro.core.selection` for planning over `AccessWindows` (the
seed's free-relay behaviour). Planning against a `ContactPlan` — routed
ISL relays, rate-priced windows — comes with the comms slice (ROADMAP).

Three selectors, all producing `ClientPlan`s — a fully-timed itinerary for
one satellite's participation in one FL round:

  * `BaseSelector`      — Algorithm 1/2 selection: the first `c = min(C,K)`
                          idle satellites to contact any ground station.
  * `ScheduleSelector`  — Algorithm 4 (FLSchedule): the satellites with the
                          earliest projected parameter return.
  * `IntraCCSelector`   — Algorithm 5 (FLIntraCC): a trained satellite may
                          return its update through any same-cluster peer
                          that can reach a ground station (the original
                          satellite keeps priority on ties).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.strategies.base import ClientWorkMode, Strategy
from repro_torch.core.timing import HardwareModel
from repro_torch.orbits.access import AccessWindows

# Bounded retry for the download-fit check: a candidate slides to at most
# this many later passes looking for one long enough to hold the download
# before being dropped from the round.
MAX_PASS_SLIDES = 8


def _no_plan(plan) -> None:
    if plan is not None:
        raise NotImplementedError("ContactPlan planning: ROADMAP comms slice")


@dataclasses.dataclass(frozen=True)
class ClientPlan:
    """A timed itinerary for satellite `k` in one round."""

    k: int
    rx_start: float          # global-model download begins (ground contact)
    rx_end: float            #   ... ends
    train_start: float
    train_end: float
    epochs: int
    tx_start: float          # parameter return begins
    tx_end: float            #   ... ends (server receives the update)
    relay: int = -1          # peer satellite uplinking the return (-1: none)
    relay_path: tuple[int, ...] = ()   # full store-and-forward path (k, ...)
    isl_hops: int = 0        # ISL legs paid for the return (0: direct/free)
    comm_bytes: float = 0.0  # bytes on the wire: download + every return leg

    @property
    def round_trip(self) -> float:
        return self.tx_end - self.rx_start


def _plan_prefix(
    k: int,
    t: float,
    aw: AccessWindows,
    strategy: Strategy,
    hw: HardwareModel,
    local_epochs: int,
    min_epochs: int,
    plan=None,
) -> tuple | None:
    """Download pass + training timing for one candidate. Returns
    (rx_start, rx_end, train_start, train_end, epochs, earliest_return),
    with train_end None for UNTIL_CONTACT (resolved once the departure is
    known), or None when no download pass exists."""
    _no_plan(plan)
    # --- download pass ---------------------------------------------------
    # A pass too short for the download slides the candidate to the next
    # pass, which must pass the same check; the retry is bounded
    # (MAX_PASS_SLIDES) and exhaustion drops the candidate.
    w = aw.next_window(k, t)
    if w is None:
        return None
    rx_start = w[0]
    rx_end = rx_start + hw.tx_time_s
    slides = 0
    while rx_end > w[1]:  # download does not fit: slide to next pass
        if slides >= MAX_PASS_SLIDES:
            return None
        slides += 1
        w2 = aw.next_window(k, w[1] + 1.0)
        if w2 is None:
            return None
        w = w2
        rx_start, rx_end = w2[0], w2[0] + hw.tx_time_s
    pass_end = w[1]
    train_start = rx_end
    # Training happens *between* passes; parameters return at a subsequent
    # pass — never the download pass itself.
    after_pass = pass_end + 1.0

    if strategy.work_mode is ClientWorkMode.FIXED_EPOCHS:
        train_end = train_start + local_epochs * hw.epoch_time_s
        epochs = local_epochs
        earliest_return = max(train_end, after_pass)
    else:
        # UNTIL_CONTACT: train until the chosen return pass opens, with a
        # min-epoch floor (FedProxSchV2) and the hardware duty-cycle cap.
        earliest_return = max(
            train_start + max(min_epochs, 1) * hw.epoch_time_s, after_pass)
        train_end = None  # resolved once the return window is known
        epochs = 0
    return rx_start, rx_end, train_start, train_end, epochs, earliest_return


def _plan_for(
    k: int,
    t: float,
    aw: AccessWindows,
    strategy: Strategy,
    hw: HardwareModel,
    local_epochs: int,
    min_epochs: int,
    use_relay: bool,
    plan=None,
    max_hops: int = 3,
) -> ClientPlan | None:
    """Build the itinerary for one candidate satellite starting at time t."""
    _no_plan(plan)
    prefix = _plan_prefix(k, t, aw, strategy, hw, local_epochs, min_epochs)
    if prefix is None:
        return None
    rx_start, rx_end, train_start, train_end, epochs, earliest_return = prefix

    # --- choose the return path -----------------------------------------
    relay = -1
    relay_path: tuple[int, ...] = ()
    isl_hops = 0
    comm_bytes = hw.round_trip_bytes
    ret = aw.next_window(k, earliest_return)
    if use_relay:
        # Seed free-relay: any same-cluster peer with line-of-sight along
        # the orbital plane may relay the update instantaneously; the
        # original satellite has priority on ties.
        cl = int(aw.cluster[k])
        best = aw.cluster_next_window(cl, earliest_return)
        if best is not None and (ret is None or best[1] < ret[0]):
            peer, s, e = best
            if peer != k:
                relay = peer
                relay_path = (k, peer)
            ret = (s, e)
    if ret is None:
        return None
    tx_start = ret[0]
    tx_end = tx_start + hw.ul_time_s
    departure = tx_start
    if strategy.work_mode is ClientWorkMode.UNTIL_CONTACT:
        # The number of gradient epochs is capped by the onboard duty
        # cycle; the satellite keeps training right up to its return
        # transmission, so its compute span is the whole inter-pass gap.
        epochs = hw.epochs_between(train_start, departure)
        epochs = max(epochs, min(min_epochs, hw.max_local_epochs)) or 1
        train_end = departure
    return ClientPlan(
        k=k, rx_start=rx_start, rx_end=rx_end,
        train_start=train_start, train_end=float(train_end),
        epochs=int(epochs), tx_start=tx_start, tx_end=tx_end, relay=relay,
        relay_path=relay_path, isl_hops=isl_hops, comm_bytes=comm_bytes,
    )


@dataclasses.dataclass(frozen=True)
class BaseSelector:
    """First `c` idle satellites to contact any ground station."""

    use_relay: bool = False
    schedule: bool = False
    max_hops: int = 3        # ISL hop bound (used by ContactPlan routing)

    def select(
        self,
        aw: AccessWindows,
        t: float,
        idle: Sequence[int],
        c: int,
        strategy: Strategy,
        hw: HardwareModel,
        local_epochs: int = 5,
        min_epochs: int = 0,
        plan=None,
    ) -> list[ClientPlan]:
        _no_plan(plan)
        # Sparse-participation strategies shrink the nominal budget here.
        c = strategy.round_size(c)
        plans = []
        for k in idle:
            p = _plan_for(int(k), t, aw, strategy, hw, local_epochs,
                          min_epochs, self.use_relay,
                          max_hops=self.max_hops)
            if p is not None:
                plans.append(p)
        # Base rule: order by *initial contact* (first to reach a station).
        # Schedule rule: order by projected parameter-return time.
        key = (lambda p: (p.tx_end, p.rx_start)) if self.schedule \
            else (lambda p: (p.rx_start, p.tx_end))
        plans.sort(key=key)
        return plans[: min(c, len(plans))]


@dataclasses.dataclass(frozen=True)
class ScheduleSelector(BaseSelector):
    """FLSchedule (Algorithm 4): pick fastest-returning satellites."""

    use_relay: bool = False
    schedule: bool = True


@dataclasses.dataclass(frozen=True)
class IntraCCSelector(BaseSelector):
    """FLIntraCC (Algorithm 5): cluster peers may relay parameter returns."""

    use_relay: bool = True
    schedule: bool = False
