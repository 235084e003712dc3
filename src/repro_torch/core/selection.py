"""Orbital client selection (paper section 3 stage 1 + section 4 augmentations).

Port of `repro.core.selection` (host-side planning in plain Python,
bitwise the reference's). Three selectors, all producing `ClientPlan`s —
a fully-timed itinerary for one satellite's participation in one FL
round:

  * `BaseSelector`      — Algorithm 1/2 selection: the first `c = min(C,K)`
                          idle satellites to contact any ground station.
  * `ScheduleSelector`  — Algorithm 4 (FLSchedule): the satellites with the
                          earliest projected parameter return.
  * `IntraCCSelector`   — Algorithm 5 (FLIntraCC): a trained satellite may
                          return its update through any same-cluster peer
                          that can reach a ground station (the original
                          satellite keeps priority on ties).

When a `repro_torch.comms.ContactPlan` is supplied, itineraries are
planned against it instead: transfer times follow each window's
achievable rate, and — for relay-enabled selectors — the parameter return
is routed store-and-forward over the ISL contact graph
(`repro_torch.comms.routing`), so a relayed upload pays real ISL transfer
time + wait and multi-hop relays become possible. Without a plan the
seed's free-relay behaviour is reproduced exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.comms.contact_plan import ContactPlan
from repro_torch.comms.routing import Route, batch_earliest_arrival
from repro_torch.core.strategies.base import ClientWorkMode, Strategy
from repro_torch.core.timing import HardwareModel
from repro_torch.orbits.access import AccessWindows

# Bounded retry for the download-fit check: a candidate slides to at most
# this many later passes looking for one long enough to hold the download
# before being dropped from the round. Under LinkBudget fading consecutive
# short passes are common; unbounded sliding could walk the whole horizon.
MAX_PASS_SLIDES = 8


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
    plan: ContactPlan | None = None,
) -> tuple | None:
    """Download pass + training timing for one candidate — everything an
    itinerary needs *before* the return path is routed. Returns
    (rx_start, rx_end, train_start, train_end, epochs, earliest_return),
    with train_end None for UNTIL_CONTACT (resolved once the departure is
    known), or None when no download pass exists. Split out of
    `_plan_for` so selectors can compute every candidate's
    `earliest_return` first and route the whole round in ONE
    `batch_earliest_arrival` call.
    """
    # --- download pass ---------------------------------------------------
    # The fit check loops: a pass too short for the download (rate-priced
    # under a ContactPlan, flat-rate otherwise) slides the candidate to the
    # next pass, and the NEXT pass must pass the same check — under
    # LinkBudget fading consecutive passes can all be too short, so the
    # retry is bounded (MAX_PASS_SLIDES) and exhaustion drops the candidate.
    if plan is not None:
        w0 = plan.next_window(("gs", k), t)
        if w0 is None:
            return None
        rx_start = w0.start
        rx_end = rx_start + hw.tx_time_for(rate_bps=w0.rate_bps)
        slides = 0
        while rx_end > w0.end:  # download does not fit: slide to next pass
            if slides >= MAX_PASS_SLIDES:
                return None
            slides += 1
            w0 = plan.next_window(("gs", k), w0.end + 1.0)
            if w0 is None:
                return None
            rx_start = w0.start
            rx_end = rx_start + hw.tx_time_for(rate_bps=w0.rate_bps)
        pass_end = w0.end
    else:
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
    # pass ("Wait until reach nearest station in G, then return w" /
    # "while no access to ground station do train") — never the download
    # pass itself.
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
    plan: ContactPlan | None = None,
    route: Route | None = None,
) -> ClientPlan | None:
    """Build the itinerary for one candidate satellite starting at time t.

    With a `plan`, `route` is the candidate's return route from
    `batch_earliest_arrival` (None: no route, so no itinerary).
    """
    prefix = _plan_prefix(k, t, aw, strategy, hw, local_epochs,
                          min_epochs, plan=plan)
    if prefix is None:
        return None
    rx_start, rx_end, train_start, train_end, epochs, earliest_return = prefix

    # --- choose the return path -----------------------------------------
    # The default up+down cost is the ONE shared round-trip expression
    # (full-precision download + codec-priced uplink); routed returns
    # replace the uplink term with the route's per-leg wire bytes.
    relay = -1
    relay_path: tuple[int, ...] = ()
    isl_hops = 0
    comm_bytes = hw.round_trip_bytes
    if plan is not None:
        # Contact-graph routing: relayed uploads pay ISL transfer + wait,
        # each leg carrying the codec-encoded return.
        if route is None:
            return None
        tx_start, tx_end = route.tx_start, route.arrival_s
        departure = route.departure_s
        relay, relay_path, isl_hops = route.relay, route.path, route.isl_hops
        comm_bytes = hw.model_bytes + route.bytes_on_wire
    else:
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
        tx_end = tx_start + hw.ul_time_s    # return leg: codec-priced
        departure = tx_start
    if strategy.work_mode is ClientWorkMode.UNTIL_CONTACT:
        # SGD realism: the *number of gradient epochs* is capped by the
        # onboard duty cycle; but per Algorithms 2-3 the satellite keeps
        # training right up to its first return transmission (the return
        # pass in the direct case, the first ISL leg when routed), so its
        # compute span is the whole inter-pass gap (this is what makes
        # FedProx/FedBuff idle times collapse in Figures 9b-c).
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
    max_hops: int = 3        # ISL hop bound when routing over a ContactPlan

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
        plan: ContactPlan | None = None,
    ) -> list[ClientPlan]:
        # Sparse-participation strategies shrink the nominal selection
        # budget here, so every consumer (round loop, eval-stage
        # selection, batched lockstep planner) agrees on the round size.
        c = strategy.round_size(c)
        plans = []
        if plan is not None:
            # One batched routing call for the whole round instead of one
            # Dijkstra per candidate: compute every candidate's
            # earliest-return instant first, then relax all sources over
            # the contact graph in a handful of array sweeps.
            prefixes = {}
            for k in (int(k) for k in idle):
                px = _plan_prefix(k, t, aw, strategy, hw, local_epochs,
                                  min_epochs, plan=plan)
                if px is not None:
                    prefixes[k] = px
            cands = list(prefixes)
            if cands:
                routes = batch_earliest_arrival(
                    plan, cands, [prefixes[k][5] for k in cands],
                    hw.uplink_bytes,
                    max_hops=self.max_hops if self.use_relay else 0)
                for k, route in zip(cands, routes):
                    p = _plan_for(k, t, aw, strategy, hw, local_epochs,
                                  min_epochs, self.use_relay, plan=plan,
                                  route=route)
                    if p is not None:
                        plans.append(p)
        else:
            for k in idle:
                p = _plan_for(int(k), t, aw, strategy, hw, local_epochs,
                              min_epochs, self.use_relay)
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
