"""Unified contact plan: ground passes + ISL windows, priced by link rate.

Port of `repro.comms.contact_plan`: numpy float64 end to end and a
verbatim copy of the reference, so on the same `AccessWindows` and
`ISLWindows` every table, query, route input and re-rating is bitwise the
reference's (`tests/test_torch_comms.py`).

A `ContactPlan` compiles the orbital geometry into the one structure the
selector/routing layers query:

  * ground edges  `("gs", k)`      — satellite k to *any* ground station,
    from `AccessWindows`;
  * ISL edges     `("isl", i, j)`  — undirected inter-satellite links from
    `ISLWindows` (stored with i < j).

Each window carries an achievable `rate_bps` so transfer time varies with
geometry. With the default `ConstantRate` link models the plan reproduces
the seed's constant-`LINK_MBPS` arithmetic exactly (back-compat).

Geometry cache
--------------
Window extraction is the expensive, link-independent part of a plan (a
90-day horizon re-propagates every orbit); the *rates* are cheap. To make
re-pricing cheap too, `build_contact_plan` can cache per-window slant
ranges alongside the windows (`cache_geometry=True`, or automatically
whenever a geometry-dependent link forces propagation anyway):

  * every window stores its midpoint slant range (`mid_range_m`);
  * ground windows additionally store a `range_samples`-point piecewise
    range profile across the pass (`range_profile`), so a `LinkBudget`
    prices a long pass as a time-varying rate rather than one midpoint
    number — `next_ground_upload`/`next_isl_transfer` integrate the
    resulting `rate_profile` (trapezoid rule) when it is present.

Ground windows are the merged per-satellite passes of `AccessWindows`
(the same window set the constant-rate path uses); at each geometry
sample the effective range is the range to the *nearest station whose
own pass covers that instant* (the satellite downlinks to the best
visible station).

`ContactPlan.rerate` re-prices a cached plan with **any** `LinkModel` —
`ConstantRate` output is bitwise-identical to a fresh constant-rate
build, and `LinkBudget` output matches a from-scratch geometry build
without a single new propagation call.
"""
from __future__ import annotations

import bisect
import dataclasses
import math

import numpy as np

from repro_torch.comms.isl import ISLWindows
from repro_torch.obs import count, span
from repro_torch.comms.links import (
    MIN_RATE_BPS,
    ConstantRate,
    LinkModel,
    slant_range_m,
)
from repro_torch.orbits.access import AccessWindows
from repro_torch.orbits.propagation import (
    eci_positions_at_np,
    eci_positions_np,
    gs_eci_positions_np,
)
from repro_torch.orbits.stations import station_latlon

Edge = tuple  # ("gs", k) | ("isl", i, j) with i < j

# Ground-pass range profiles: slant ranges sampled at this many evenly
# spaced instants per window (endpoints included).
DEFAULT_RANGE_SAMPLES = 5



@dataclasses.dataclass(frozen=True)
class ContactWindow:
    start: float
    end: float
    rate_bps: float

    @property
    def duration_s(self) -> float:
        return self.end - self.start

    @property
    def volume_bytes(self) -> float:
        """Bytes transferable if the whole window is used at `rate_bps`."""
        return self.duration_s * self.rate_bps / 8.0


def _profile_tx_end_batch(times: np.ndarray, rates: np.ndarray,
                          t0: np.ndarray, n_bits: float) -> np.ndarray:
    """Vectorized `_profile_tx_end` over a batch of windows.

    `times`/`rates` are (B, S) per-lane profile samples, `t0` the (B,)
    transfer starts. Same segment walk, same float64 arithmetic — each
    lane's result is bitwise-identical to the scalar loop — but the
    segment loop runs S-1 vectorized passes instead of B Python loops.
    """
    r = np.maximum(np.asarray(rates, float), MIN_RATE_BPS)
    remaining = np.full(t0.shape, float(n_bits))
    t = np.asarray(t0, float).copy()
    out = np.zeros(t0.shape)
    done = np.zeros(t0.shape, bool)
    for i in range(times.shape[1] - 1):
        ta, tb = times[:, i], times[:, i + 1]
        skip = (tb <= t) | (tb <= ta)
        a = np.maximum(t, ta)
        with np.errstate(divide="ignore", invalid="ignore"):
            m = (r[:, i + 1] - r[:, i]) / (tb - ta)
            ra = r[:, i] + m * (a - ta)
            seg_bits = 0.5 * (ra + r[:, i + 1]) * (tb - a)
            fin = ~done & ~skip & (seg_bits >= remaining)
            flat = np.abs(m) < 1e-12
            end_flat = a + remaining / np.maximum(ra, MIN_RATE_BPS)
            disc = ra * ra + 2.0 * m * remaining
            end_slope = a + (np.sqrt(np.maximum(disc, 0.0)) - ra) / m
        out = np.where(fin & flat, end_flat,
                       np.where(fin & ~flat, end_slope, out))
        done |= fin
        cont = ~done & ~skip
        remaining = np.where(cont, remaining - seg_bits, remaining)
        t = np.where(cont, tb, t)
    tail = t + remaining / np.maximum(r[:, -1], MIN_RATE_BPS)
    return np.where(done, out, tail)


def _profile_tx_end(times: np.ndarray, rates: np.ndarray, t0: float,
                    n_bits: float) -> float:
    """Completion time of an `n_bits` transfer starting at `t0` over a
    piecewise-linear rate profile (trapezoid integration). Past the last
    sample the final rate holds, so ground uploads may overrun the pass
    exactly like the constant-rate path."""
    r = np.maximum(np.asarray(rates, float), MIN_RATE_BPS)
    remaining = float(n_bits)
    t = float(t0)
    for i in range(len(times) - 1):
        ta, tb = float(times[i]), float(times[i + 1])
        if tb <= t or tb <= ta:
            continue
        a = max(t, ta)
        m = (float(r[i + 1]) - float(r[i])) / (tb - ta)
        ra = float(r[i]) + m * (a - ta)
        seg_bits = 0.5 * (ra + float(r[i + 1])) * (tb - a)
        if seg_bits >= remaining:
            if abs(m) < 1e-12:
                return a + remaining / max(ra, MIN_RATE_BPS)
            # Solve ra*x + m*x^2/2 = remaining for the in-segment offset.
            disc = ra * ra + 2.0 * m * remaining
            return a + (math.sqrt(max(disc, 0.0)) - ra) / m
        remaining -= seg_bits
        t = tb
    return t + remaining / max(float(r[-1]), MIN_RATE_BPS)


@dataclasses.dataclass
class _EdgeWindows:
    """Start-sorted parallel arrays for one edge.

    Windows from different stations may overlap, so `ends` is not
    necessarily sorted; queries bisect `cummax_ends` (running max of
    `ends`, always non-decreasing) to find the first index whose window
    outlives t.

    The optional geometry fields are the build-time cache that lets
    `ContactPlan.rerate` price these windows with a range-dependent
    `LinkModel` without re-propagating:

      mid_range_m:   (M,) slant range at each window's midpoint;
      range_profile: (M, S) slant ranges at S evenly spaced instants
                     spanning each window (ground passes only);
      rate_profile:  (M, S) achievable rate at the profile instants under
                     the *current* pricing (None for geometry-free links,
                     whose rate is flat across the pass).
    """

    starts: np.ndarray
    ends: np.ndarray
    rates: np.ndarray
    mid_range_m: np.ndarray | None = None
    range_profile: np.ndarray | None = None
    rate_profile: np.ndarray | None = None
    cummax_ends: np.ndarray = dataclasses.field(init=False)

    def __post_init__(self):
        self.cummax_ends = (np.maximum.accumulate(self.ends)
                            if len(self.ends) else self.ends)

    def __len__(self) -> int:
        return len(self.starts)

    def first_live(self, t: float) -> int:
        """Index of the first (start-sorted) window with end > t: where
        the running max of `ends` first exceeds t, the max was raised by
        that very window, and every earlier window has already closed."""
        return bisect.bisect_right(self.cummax_ends, t)

    def tx_end(self, i: int, tx_start: float, n_bytes: float) -> float:
        """When an `n_bytes` transfer starting at `tx_start` inside
        window `i` completes: piecewise-integrated when a rate profile is
        present, else the window's flat rate (floored at `MIN_RATE_BPS`).
        """
        n_bits = n_bytes * 8
        if self.rate_profile is not None:
            times = np.linspace(float(self.starts[i]), float(self.ends[i]),
                                self.rate_profile.shape[1])
            return _profile_tx_end(times, self.rate_profile[i], tx_start,
                                   n_bits)
        return tx_start + n_bits / max(float(self.rates[i]), MIN_RATE_BPS)


@dataclasses.dataclass
class WindowTable:
    """Padded rectangular window arrays for a whole edge set.

    Per-edge window lists are ragged; queries over them are per-edge
    Python. This table pads every edge's start-sorted windows to the
    edge-set maximum (`starts`/`ends`/`rates` all (E, W), padding +inf)
    so window lookup and transfer pricing become batched array ops over
    arbitrary (edge, time) lane sets — the shape the batch router and
    the mega-constellation benches need. `counts` (E,) bounds the live
    region of each row; `cummax_ends` carries the same running-max-of-
    ends trick as `_EdgeWindows.first_live`, padded with +inf so padding
    never counts as closed. `rate_profile` (E, W, S), when present,
    carries the piecewise pass pricing of budget-priced ground windows.

    Every query reproduces its `_EdgeWindows` scalar twin bitwise: same
    window-advance rules, same float64 transfer arithmetic.
    """

    starts: np.ndarray
    ends: np.ndarray
    rates: np.ndarray
    counts: np.ndarray
    cummax_ends: np.ndarray
    rate_profile: np.ndarray | None = None
    _profile_times: np.ndarray | None = None

    @classmethod
    def from_edges(cls, edges: list[_EdgeWindows]) -> "WindowTable":
        E = len(edges)
        W = max((len(e) for e in edges), default=0)
        starts = np.full((E, W), np.inf)
        ends = np.full((E, W), np.inf)
        rates = np.full((E, W), MIN_RATE_BPS)
        cummax = np.full((E, W), np.inf)
        counts = np.zeros(E, np.int64)
        prof_w = max((e.rate_profile.shape[1] for e in edges
                      if e.rate_profile is not None), default=0)
        prof = np.zeros((E, W, prof_w)) if prof_w else None
        prof_t = np.zeros((E, W, prof_w)) if prof_w else None
        for i, e in enumerate(edges):
            n = len(e)
            counts[i] = n
            if not n:
                continue
            starts[i, :n] = e.starts
            ends[i, :n] = e.ends
            rates[i, :n] = e.rates
            cummax[i, :n] = e.cummax_ends
            if prof is not None and e.rate_profile is not None:
                prof[i, :n] = e.rate_profile
                # Per-window profile instants: the same linspace the
                # scalar `tx_end` rebuilds on every call.
                prof_t[i, :n] = np.linspace(e.starts, e.ends, prof_w,
                                            axis=-1)
        return cls(starts=starts, ends=ends, rates=rates, counts=counts,
                   cummax_ends=cummax, rate_profile=prof,
                   _profile_times=prof_t)

    @property
    def n_edges(self) -> int:
        return len(self.counts)

    def first_live(self, rows: np.ndarray, t: np.ndarray) -> np.ndarray:
        """Batched `_EdgeWindows.first_live`: for each (edge-row, time)
        lane, the index of the first start-sorted window with end > t.

        Vectorized binary search over the lane axis: each `cummax_ends`
        row is non-decreasing (running max, +inf padding), so the count
        of entries <= t is a bisect — log2(W) gathers of B elements
        instead of materializing the full (B, W) gather, which dominates
        the router's wall at mega-constellation lane counts.
        """
        W = self.cummax_ends.shape[1]
        B = len(rows)
        lo = np.zeros(B, np.int64)
        if W == 0 or B == 0:
            return lo
        hi = np.full(B, W, np.int64)
        live = np.ones(B, bool)
        while live.any():
            mid = (lo + hi) >> 1
            # Dead lanes can carry mid == W; clamp the gather (their
            # `below` is masked off, so the fetched value is unused).
            below = live & (self.cummax_ends[rows,
                                             np.minimum(mid, W - 1)] <= t)
            lo = np.where(below, mid + 1, lo)
            hi = np.where(live & ~below, mid, hi)
            live = lo < hi
        return lo

    def _tx_end(self, rows, wi, tx_start, n_bits):
        if self.rate_profile is not None:
            has = self._profile_times[rows, wi, -1] > 0
            flat = tx_start + n_bits / np.maximum(self.rates[rows, wi],
                                                  MIN_RATE_BPS)
            if not has.any():
                return flat
            prof = _profile_tx_end_batch(self._profile_times[rows, wi],
                                         self.rate_profile[rows, wi],
                                         tx_start, n_bits)
            return np.where(has, prof, flat)
        return tx_start + n_bits / np.maximum(self.rates[rows, wi],
                                              MIN_RATE_BPS)

    def ground_upload(self, rows: np.ndarray, t: np.ndarray, n_bytes: float
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Batched `ContactPlan.next_ground_upload` over (row, time) lanes.

        Returns (tx_start, tx_end, ok); lanes without any usable window
        report ok=False (tx arrays undefined there). Mirrors the scalar
        walk exactly: skip closed overlaps, stop once a window cannot
        complete earlier than the current best, keep the earliest-
        completion candidate.
        """
        rows = np.asarray(rows)
        t = np.asarray(t, float)
        B = rows.shape[0]
        n_bits = n_bytes * 8
        i = self.first_live(rows, t)
        best_s = np.zeros(B)
        best_e = np.full(B, np.inf)
        ok = np.zeros(B, bool)
        done = np.zeros(B, bool)
        counts = self.counts[rows]
        while True:
            act = ~done & (i < counts)
            if not act.any():
                break
            wi = np.where(act, i, 0)
            en = self.ends[rows, wi]
            st = self.starts[rows, wi]
            closed = en <= t
            stop = act & ~closed & ok & (st >= best_e)
            done |= stop
            live = act & ~closed & ~stop
            tx_s = np.maximum(st, t)
            tx_e = self._tx_end(rows, wi, tx_s, n_bits)
            better = live & (~ok | (tx_e < best_e))
            best_s = np.where(better, tx_s, best_s)
            best_e = np.where(better, tx_e, best_e)
            ok |= live
            i = np.where(act & ~stop, i + 1, i)
        return best_s, best_e, ok

    def transfer(self, rows: np.ndarray, t: np.ndarray, n_bytes: float
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Batched `ContactPlan.next_isl_transfer` over (row, time) lanes.

        Returns (start, end, ok): the earliest window at-or-after t in
        which the whole `n_bytes` transfer fits, ok=False when none does.
        """
        rows = np.asarray(rows)
        t = np.asarray(t, float)
        B = rows.shape[0]
        n_bits = n_bytes * 8
        w = self.first_live(rows, t)
        s_out = np.zeros(B)
        e_out = np.full(B, np.inf)
        ok = np.zeros(B, bool)
        counts = self.counts[rows]
        while True:
            act = ~ok & (w < counts)
            if not act.any():
                break
            wi = np.where(act, w, 0)
            en = self.ends[rows, wi]
            closed = en <= t
            s = np.maximum(self.starts[rows, wi], t)
            e = self._tx_end(rows, wi, s, n_bits)
            fit = act & ~closed & (e <= en)
            s_out = np.where(fit, s, s_out)
            e_out = np.where(fit, e, e_out)
            ok |= fit
            w = np.where(act & ~fit, w + 1, w)
        return s_out, e_out, ok

    @classmethod
    def stack(cls, tables: list["WindowTable"]
              ) -> tuple["WindowTable", np.ndarray]:
        """Stack window tables along a *scenario* axis.

        Concatenates the edge (row) axes of several tables — typically
        one per sweep scenario — padding every window axis to the stack
        maximum with the exact padding `from_edges` uses (+inf starts/
        ends/cummax, `MIN_RATE_BPS` rates, zero profiles), so one
        batched `first_live`/`ground_upload`/`transfer` call can span
        lanes from every scenario at once (`repro_torch.sim.batched`).

        Returns `(stacked, offsets)` with `offsets` of length
        `len(tables) + 1`: table `i`'s row `r` lives at stacked row
        `offsets[i] + r`. Queries over the stacked table are bitwise the
        per-table queries (tests/test_torch_batched.py pins this).
        """
        W = max((t.starts.shape[1] for t in tables), default=0)
        prof_ws = {t.rate_profile.shape[2] for t in tables
                   if t.rate_profile is not None}
        if len(prof_ws) > 1:
            # Tail-padding a narrower profile with zeros would flip its
            # windows onto the flat-rate path (the `_tx_end` presence
            # check reads the last profile instant) — refuse rather than
            # silently change pricing.
            raise ValueError("cannot stack WindowTables with differing "
                             f"rate-profile widths {sorted(prof_ws)}")
        prof_w = prof_ws.pop() if prof_ws else 0
        offsets = np.zeros(len(tables) + 1, np.int64)
        for i, t in enumerate(tables):
            offsets[i + 1] = offsets[i] + t.n_edges
        E = int(offsets[-1])
        starts = np.full((E, W), np.inf)
        ends = np.full((E, W), np.inf)
        rates = np.full((E, W), MIN_RATE_BPS)
        cummax = np.full((E, W), np.inf)
        counts = np.zeros(E, np.int64)
        prof = np.zeros((E, W, prof_w)) if prof_w else None
        prof_t = np.zeros((E, W, prof_w)) if prof_w else None
        for i, t in enumerate(tables):
            a, b = int(offsets[i]), int(offsets[i + 1])
            w = t.starts.shape[1]
            starts[a:b, :w] = t.starts
            ends[a:b, :w] = t.ends
            rates[a:b, :w] = t.rates
            cummax[a:b, :w] = t.cummax_ends
            counts[a:b] = t.counts
            if prof is not None and t.rate_profile is not None:
                prof[a:b, :w] = t.rate_profile
                prof_t[a:b, :w] = t._profile_times
        return cls(starts=starts, ends=ends, rates=rates, counts=counts,
                   cummax_ends=cummax, rate_profile=prof,
                   _profile_times=prof_t), offsets


@dataclasses.dataclass(frozen=True, eq=False)
class ContactOutlook:
    """Read-only schedule view handed to strategy scheduling hooks.

    Strategies deciding *when* to aggregate (`Strategy.should_flush`) or
    where the next round's clock starts (`Strategy.next_sync_point`)
    need the upcoming contact schedule — which satellites see a ground
    station next, and when — without mutable access to the plan or the
    engine. This wraps the padded `WindowTable`s in a handful of
    point-in-time queries over the *future* (binary-searched
    `first_live`, never a scan), so hook calls stay O(log W) per
    satellite regardless of horizon length.

    Built once per engine run: from the scenario's `ContactPlan` when
    one exists (`from_plan`, ground + ISL tables) or straight from
    `AccessWindows` on the plan-free path (`from_access`, ground only).
    """

    ground: WindowTable
    isl: WindowTable | None = None
    edge_index: dict | None = None     # (i, j) i<j -> row in `isl`
    horizon_s: float = float("inf")

    @classmethod
    def from_plan(cls, plan: "ContactPlan") -> "ContactOutlook":
        tables = plan.tables()
        return cls(ground=tables.ground, isl=tables.isl,
                   edge_index=tables.edge_index, horizon_s=plan.horizon_s)

    @classmethod
    def from_access(cls, aw: AccessWindows,
                    rate_bps: float = MIN_RATE_BPS) -> "ContactOutlook":
        """Outlook over merged per-satellite ground passes. `rate_bps`
        is informational (the AccessWindows path prices transfers with
        the flat hardware tx time, not per-window rates)."""
        edges = [_EdgeWindows(np.asarray(s, float), np.asarray(e, float),
                              np.full(len(s), float(rate_bps)))
                 for s, e in aw.per_sat]
        return cls(ground=WindowTable.from_edges(edges),
                   horizon_s=aw.horizon_s)

    @property
    def n_sats(self) -> int:
        return self.ground.n_edges

    def next_ground_pass(self, k: int, t: float
                         ) -> tuple[float, float] | None:
        """Earliest ground pass of satellite `k` live at-or-after `t`,
        truncated to `t` (`AccessWindows.next_window` semantics)."""
        wt = self.ground
        i = int(wt.first_live(np.array([k]), np.array([float(t)]))[0])
        if i >= int(wt.counts[k]):
            return None
        return (max(float(wt.starts[k, i]), t), float(wt.ends[k, i]))

    def ground_gap_s(self, k: int, t: float) -> float | None:
        """Seconds from `t` until satellite `k` next sees a station
        (0.0 inside a pass); None when no pass remains."""
        w = self.next_ground_pass(k, t)
        return None if w is None else w[0] - t

    def next_contact_s(self, t: float, ks=None) -> float | None:
        """Earliest instant any satellite (of `ks`, default all) is in
        ground contact at-or-after `t` — `t` itself when a pass is
        already live. None when the schedule is exhausted."""
        wt = self.ground
        rows = (np.arange(wt.n_edges) if ks is None
                else np.asarray(list(ks), np.int64))
        if len(rows) == 0:
            return None
        i = wt.first_live(rows, np.full(len(rows), float(t)))
        ok = i < wt.counts[rows]
        if not ok.any():
            return None
        starts = np.maximum(wt.starts[rows, np.where(ok, i, 0)], float(t))
        return float(starts[ok].min())

    def next_isl_window(self, i: int, j: int, t: float
                        ) -> tuple[float, float] | None:
        """Earliest ISL window on edge (i, j) live at-or-after `t`;
        None without ISL tables or when the edge's schedule is done."""
        if self.isl is None or self.edge_index is None:
            return None
        row = self.edge_index.get((min(i, j), max(i, j)))
        if row is None:
            return None
        w = int(self.isl.first_live(np.array([row]),
                                    np.array([float(t)]))[0])
        if w >= int(self.isl.counts[row]):
            return None
        return (max(float(self.isl.starts[row, w]), t),
                float(self.isl.ends[row, w]))


@dataclasses.dataclass
class PlanTables:
    """Array-shaped view of one `ContactPlan`: the ground/ISL window
    tables plus the directed ISL adjacency in two orders — (dst, src)
    sorted with segment boundaries per dst (`seg_*`, for scatter-min
    reductions) and a per-source CSR (`out_order`/`out_starts`, for
    expanding only the *reachable* labels of a relax level into their
    out-edges: the lane set the batch router prices stays proportional
    to the frontier, not S x D)."""

    ground: WindowTable
    isl: WindowTable
    edge_index: dict[tuple[int, int], int]
    adj_src: np.ndarray      # (D,) directed edge sources
    adj_dst: np.ndarray      # (D,) directed edge destinations
    adj_edge: np.ndarray     # (D,) undirected edge row in `isl`
    seg_starts: np.ndarray   # (V,) reduceat boundaries into the D axis
    seg_dst: np.ndarray      # (V,) destination sat per segment
    out_order: np.ndarray    # (D,) adj permutation sorted by (src, dst)
    out_starts: np.ndarray   # (n_sats + 1,) CSR bounds into out_order

    @property
    def n_directed(self) -> int:
        return len(self.adj_src)


def _priced_windows(starts: np.ndarray, ends: np.ndarray, link: LinkModel,
                    kind: str, mid_range_m: np.ndarray | None = None,
                    range_profile: np.ndarray | None = None) -> _EdgeWindows:
    """Price one edge's windows with `link`, carrying the geometry cache
    through. This is the single pricing path shared by
    `build_contact_plan` and `ContactPlan.rerate`, so a cached-then-
    re-rated plan reproduces a from-scratch build exactly."""
    if link.geometry_free:
        return _EdgeWindows(starts, ends,
                            np.full(len(starts), float(link.rate_bps())),
                            mid_range_m=mid_range_m,
                            range_profile=range_profile)
    if len(starts) and mid_range_m is None:
        raise ValueError(
            f"no cached geometry on {kind} windows: rebuild with "
            "build_contact_plan(constellation=..., stations=..., "
            "cache_geometry=True) before re-rating with a "
            "range-dependent LinkBudget")
    rates = (np.asarray(link.rate_bps(mid_range_m), float).reshape(-1)
             if len(starts) else np.empty(0))
    rate_profile = (np.asarray(link.rate_bps(range_profile), float)
                    if range_profile is not None else None)
    return _EdgeWindows(starts, ends, rates, mid_range_m=mid_range_m,
                        range_profile=range_profile,
                        rate_profile=rate_profile)


def _priced_windows_batch(
    wins: list[tuple], link: LinkModel, kind: str
) -> list[_EdgeWindows]:
    """Price a whole edge set with one vectorized `link.rate_bps` call.

    `wins` is a list of `(starts, ends, mid_range_m, range_profile)`
    tuples, one per edge. Link pricing is elementwise, so evaluating it
    on the concatenated midpoint / profile arrays and splitting the
    result back per edge is bitwise-identical to E separate
    `_priced_windows` calls — it just replaces E Python-level pricing
    calls (the per-edge cost that dominates `rerate` on 1,000-sat plans)
    with one array op over every window at once.
    """
    if link.geometry_free:
        return [_priced_windows(s, e, link, kind, mid_range_m=m,
                                range_profile=p)
                for s, e, m, p in wins]
    for s, _e, m, _p in wins:
        if len(s) and m is None:
            raise ValueError(
                f"no cached geometry on {kind} windows: rebuild with "
                "build_contact_plan(constellation=..., stations=..., "
                "cache_geometry=True) before re-rating with a "
                "range-dependent LinkBudget")
    mid_parts = [np.asarray(m, float).reshape(-1)
                 for s, _e, m, _p in wins if len(s)]
    if mid_parts:
        rates_flat = np.asarray(
            link.rate_bps(np.concatenate(mid_parts)), float).reshape(-1)
        cuts = np.cumsum([len(a) for a in mid_parts])[:-1]
        rate_chunks = iter(np.split(rates_flat, cuts))
    else:
        rate_chunks = iter(())
    prof_parts = [np.asarray(p, float) for _s, _e, _m, p in wins
                  if p is not None]
    if prof_parts:
        prof_flat = np.asarray(
            link.rate_bps(np.concatenate(prof_parts, axis=0)), float)
        pcuts = np.cumsum([len(p) for p in prof_parts])[:-1]
        prof_chunks = iter(np.split(prof_flat, pcuts, axis=0))
    else:
        prof_chunks = iter(())
    out = []
    for s, e, m, p in wins:
        rates = next(rate_chunks) if len(s) else np.empty(0)
        rp = next(prof_chunks) if p is not None else None
        out.append(_EdgeWindows(s, e, rates, mid_range_m=m,
                                range_profile=p, rate_profile=rp))
    return out


@dataclasses.dataclass
class ContactPlan:
    """Queryable comms timeline for one (constellation, network) scenario."""

    n_sats: int
    ground: list[_EdgeWindows]                       # per satellite
    isl: dict[tuple[int, int], _EdgeWindows]         # key (i, j), i < j
    neighbors: dict[int, list[int]]
    horizon_s: float
    _tables: "PlanTables | None" = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    # ------------------------------------------------------------ tables --
    def tables(self) -> PlanTables:
        """Array-shaped view of this plan (built lazily, cached).

        The batch router and scale benchmarks query the padded
        `WindowTable`s here instead of the per-edge Python lists; the
        directed adjacency arrives pre-sorted by destination so
        relaxation scatter-mins are one `np.minimum.reduceat` per sweep.
        """
        if self._tables is None:
            with span("comms.window_tables", sats=self.n_sats,
                      isl_edges=len(self.isl)):
                ekeys = sorted(self.isl)
                edge_index = {e: r for r, e in enumerate(ekeys)}
                erow = np.arange(len(ekeys), dtype=np.int64)
                src = np.fromiter((e[0] for e in ekeys), np.int64,
                                  len(ekeys))
                dst = np.fromiter((e[1] for e in ekeys), np.int64,
                                  len(ekeys))
                adj_src = np.concatenate([src, dst])
                adj_dst = np.concatenate([dst, src])
                adj_edge = np.concatenate([erow, erow])
                order = np.lexsort((adj_src, adj_dst))
                adj_src, adj_dst, adj_edge = (adj_src[order],
                                              adj_dst[order],
                                              adj_edge[order])
                seg_dst, seg_starts = np.unique(adj_dst, return_index=True)
                out_order = np.lexsort((adj_dst, adj_src))
                out_starts = np.searchsorted(adj_src[out_order],
                                             np.arange(self.n_sats + 1))
                self._tables = PlanTables(
                    ground=WindowTable.from_edges(self.ground),
                    isl=WindowTable.from_edges(
                        [self.isl[e] for e in ekeys]),
                    edge_index=edge_index,
                    adj_src=adj_src, adj_dst=adj_dst, adj_edge=adj_edge,
                    seg_starts=seg_starts, seg_dst=seg_dst,
                    out_order=out_order, out_starts=out_starts)
        return self._tables

    # ------------------------------------------------------------- query --
    def _edge_windows(self, edge: Edge) -> _EdgeWindows:
        if edge[0] == "gs":
            return self.ground[edge[1]]
        i, j = sorted(edge[1:3])
        return self.isl[(i, j)]

    def next_window(self, edge: Edge, t: float) -> ContactWindow | None:
        """Earliest window on `edge` active at or after t (truncated to t),
        mirroring `AccessWindows.next_window` semantics. With overlapping
        windows this is the one with the smallest usable instant
        (start-sorted ties broken by position)."""
        ew = self._edge_windows(edge)
        i = ew.first_live(t)
        if i >= len(ew):
            return None
        return ContactWindow(start=max(float(ew.starts[i]), t),
                             end=float(ew.ends[i]),
                             rate_bps=float(ew.rates[i]))

    def next_ground_upload(self, k: int, t: float, n_bytes: float
                           ) -> tuple[float, float] | None:
        """Earliest-*completion* ground upload of `n_bytes` from sat k.

        Returns (tx_start, tx_end). Like the seed, the upload is not
        required to fit inside the window (tx times are ms against
        minute-scale passes); with constant rates the result is therefore
        identical to `next_window(k, t)` + the constant transfer time.
        Windows carrying a rate profile are integrated piecewise, so the
        upload slows down toward the faded edges of a pass.
        """
        ew = self.ground[k]
        i = ew.first_live(t)
        best: tuple[float, float] | None = None
        while i < len(ew):
            if float(ew.ends[i]) <= t:  # closed overlap from another station
                i += 1
                continue
            s = float(ew.starts[i])
            if best is not None and s >= best[1]:
                break  # no later window can complete earlier
            tx_start = max(s, t)
            tx_end = ew.tx_end(i, tx_start, n_bytes)
            if best is None or tx_end < best[1]:
                best = (tx_start, tx_end)
            i += 1
        return best

    def next_isl_transfer(self, i: int, j: int, t: float, n_bytes: float
                          ) -> tuple[float, float] | None:
        """Earliest ISL transfer of `n_bytes` over edge (i, j) starting at
        or after t. The transfer must fit inside a contact window (ISL
        contacts can be short); returns (start, end)."""
        key = (min(i, j), max(i, j))
        ew = self.isl.get(key)
        if ew is None or len(ew) == 0:
            return None
        w = ew.first_live(t)
        while w < len(ew):
            if float(ew.ends[w]) <= t:
                w += 1
                continue
            s = max(float(ew.starts[w]), t)
            e = ew.tx_end(w, s, n_bytes)
            if e <= float(ew.ends[w]):
                return (s, e)
            w += 1
        return None

    def isl_edges_of(self, k: int) -> list[int]:
        return self.neighbors.get(k, [])

    # ----------------------------------------------------------- re-rate --
    def rerate(self, ground_link: LinkModel | None,
               isl_link: LinkModel | None = None) -> "ContactPlan":
        """This plan's geometry, re-priced by different link models.

        Contact windows are orbital facts and survive unchanged; only the
        per-window achievable rates are recomputed. This is what lets a
        cached plan be shared across workloads and link models: the
        expensive part (window extraction + slant-range sampling) is
        priced once, while the rates follow each caller's radio.

        * Geometry-free links (`ConstantRate`) re-price any plan; the
          result is bitwise-identical to a fresh constant-rate build.
        * Range-dependent links (`LinkBudget`) re-price plans that carry
          the geometry cache (`build_contact_plan(...,
          cache_geometry=True)`), reusing the stored midpoint ranges and
          pass profiles — zero propagation. Plans without cached
          geometry raise ValueError.

        Either side may be None to keep that side's current pricing:
        `ground_link=None` leaves ground windows verbatim; `isl_link`
        defaults to `ground_link` when that is given (the historical
        one-radio behaviour), else also keeps its current pricing.
        """
        if isl_link is None:
            isl_link = ground_link
        with span("comms.plan_rerate", sats=self.n_sats,
                  ground=type(ground_link).__name__ if ground_link else None,
                  isl=type(isl_link).__name__ if isl_link else None):
            count("comms.plan_rerates")
            # A range-dependent link priced here reuses the cached slant
            # ranges instead of re-propagating: a geometry-cache hit.
            for link in (ground_link, isl_link):
                if link is not None and not link.geometry_free:
                    count("comms.geometry_cache.hit")
            ground = (self.ground if ground_link is None else
                      _priced_windows_batch(
                          [(ew.starts, ew.ends, ew.mid_range_m,
                            ew.range_profile) for ew in self.ground],
                          ground_link, "ground"))
            if isl_link is None:
                isl = self.isl
            else:
                isl = dict(zip(self.isl, _priced_windows_batch(
                    [(ew.starts, ew.ends, ew.mid_range_m, ew.range_profile)
                     for ew in self.isl.values()], isl_link, "ISL")))
            return ContactPlan(n_sats=self.n_sats, ground=ground, isl=isl,
                               neighbors=self.neighbors,
                               horizon_s=self.horizon_s)


# ---------------------------------------------------------------- build --
def _elements_of(elements: dict, ks) -> dict:
    """Slice per-satellite orbital elements so position sampling
    propagates only the satellites named in `ks` (not the whole
    constellation)."""
    return {"raan": np.asarray(elements["raan"])[ks],
            "anomaly0": np.asarray(elements["anomaly0"])[ks],
            "a": elements["a"], "inc": elements["inc"]}


def _ground_geometry(k: int, starts: np.ndarray, ends: np.ndarray,
                     aw: AccessWindows, elements: dict, lat, lon,
                     range_samples: int
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Slant-range cache for one satellite's merged ground windows.

    One propagation call prices every midpoint AND every profile sample
    (the float64 NumPy twins of the propagation kernels: host-side
    geometry makes thousands of tiny calls where JAX dispatch overhead
    would dominate). At each instant the effective range is the range to
    the nearest station whose own (per-station) pass covers that instant
    — the satellite downlinks to the best visible station. An instant no
    station covers (float dust at merged-window edges) falls back to the
    nearest station outright.
    """
    S = max(int(range_samples), 2)
    mids = (starts + ends) / 2.0
    frac = np.linspace(0.0, 1.0, S)
    prof_t = starts[:, None] + (ends - starts)[:, None] * frac[None, :]
    times = np.concatenate([mids, prof_t.reshape(-1)])
    sat = eci_positions_np(_elements_of(elements, [k]), times)[0]  # (T, 3)
    gs = gs_eci_positions_np(lat, lon, times)                  # (G, T, 3)
    rng = slant_range_m(sat[None, :, :], gs)                   # (G, T)
    covered = np.zeros(rng.shape, bool)
    for g, (sg, eg) in enumerate(aw.per_sat_station[k]):
        if len(sg) == 0:
            continue
        sg = np.asarray(sg, float)
        eg = np.asarray(eg, float)
        idx = np.searchsorted(sg, times, side="right") - 1
        ok = idx >= 0
        covered[g, ok] = times[ok] <= eg[idx[ok]]
    eff = np.where(covered, rng, np.inf).min(axis=0)
    eff = np.where(np.isfinite(eff), eff, rng.min(axis=0))
    M = len(starts)
    return eff[:M], eff[M:].reshape(M, S)


def build_contact_plan(
    aw: AccessWindows,
    isl_windows: ISLWindows | None = None,
    ground_link: LinkModel | None = None,
    isl_link: LinkModel | None = None,
    constellation=None,
    stations=None,
    cache_geometry: bool | None = None,
    range_samples: int = DEFAULT_RANGE_SAMPLES,
) -> ContactPlan:
    """Compile access + ISL windows into a rate-annotated `ContactPlan`.

    Geometry-free (`ConstantRate`) links skip propagation entirely; a
    `LinkBudget` prices ground passes from a `range_samples`-point slant-
    range profile (midpoint rate as the window's headline `rate_bps`) and
    ISL windows from their midpoint range, which requires `constellation`
    (and `stations` for ground edges).

    `cache_geometry=True` stores those per-window slant ranges on the
    plan even under constant-rate pricing, so `ContactPlan.rerate` can
    later re-price it with any `LinkModel` without re-propagating; the
    default (None) caches exactly when a geometry-dependent link forces
    the propagation anyway.
    """
    ground_link = ground_link or ConstantRate()
    isl_link = isl_link or ground_link
    K = aw.n_sats

    need_ground_geom = not ground_link.geometry_free or bool(cache_geometry)
    need_isl_geom = (isl_windows is not None and
                     (not isl_link.geometry_free or bool(cache_geometry)))
    if need_ground_geom and (constellation is None or stations is None):
        raise ValueError("geometry-dependent ground link needs "
                         "constellation + stations for slant ranges")
    if need_isl_geom and constellation is None:
        raise ValueError("geometry-dependent ISL link needs constellation "
                         "for slant ranges")
    with span("comms.plan_build", sats=K,
              isl_edges=isl_windows.n_edges if isl_windows else 0,
              ground_geometry=need_ground_geom, isl_geometry=need_isl_geom):
        count("comms.plan_builds")
        if need_ground_geom or need_isl_geom:
            # Fresh slant-range propagation: the cost `rerate` avoids.
            count("comms.geometry_cache.miss")
        elements = (constellation.elements()
                    if need_ground_geom or need_isl_geom else None)

        if need_ground_geom:
            lat, lon = station_latlon(stations)
        with span("comms.ground_windows", sats=K):
            graw: list[tuple] = []
            for k in range(K):
                s_arr, e_arr = aw.per_sat[k]
                starts = np.asarray(s_arr, float)
                ends = np.asarray(e_arr, float)
                mid = prof = None
                if need_ground_geom and len(starts):
                    mid, prof = _ground_geometry(k, starts, ends, aw,
                                                 elements, lat, lon,
                                                 range_samples)
                graw.append((starts, ends, mid, prof))
            ground = _priced_windows_batch(graw, ground_link, "ground")

        isl: dict[tuple[int, int], _EdgeWindows] = {}
        neighbors: dict[int, list[int]] = {}
        if isl_windows is not None and isl_windows.n_edges:
            with span("comms.isl_windows", edges=isl_windows.n_edges):
                keys: list[tuple[int, int]] = []
                iraw: list[list] = []
                for (i, j), (s_arr, e_arr) in zip(isl_windows.edges,
                                                  isl_windows.per_edge):
                    if len(s_arr) == 0:
                        continue
                    keys.append((i, j))
                    iraw.append([np.asarray(s_arr, float),
                                 np.asarray(e_arr, float), None, None])
                if need_isl_geom and keys:
                    # All edges' midpoint ranges from ONE propagation
                    # call: gather-shaped (endpoint, instant) pairs
                    # instead of a (2, M, 3) grid per edge.
                    counts = np.fromiter((len(w[0]) for w in iraw),
                                         np.int64, len(iraw))
                    mids = np.concatenate([(w[0] + w[1]) / 2.0
                                           for w in iraw])
                    ii = np.repeat([i for i, _ in keys], counts)
                    jj = np.repeat([j for _, j in keys], counts)
                    rng = slant_range_m(
                        eci_positions_at_np(elements, ii, mids),
                        eci_positions_at_np(elements, jj, mids))
                    for w, chunk in zip(iraw, np.split(
                            rng, np.cumsum(counts)[:-1])):
                        w[2] = chunk
                priced = _priced_windows_batch(
                    [tuple(w) for w in iraw], isl_link, "ISL")
                for (i, j), ew in zip(keys, priced):
                    isl[(i, j)] = ew
                    neighbors.setdefault(i, []).append(j)
                    neighbors.setdefault(j, []).append(i)

        return ContactPlan(n_sats=K, ground=ground, isl=isl,
                           neighbors=neighbors, horizon_s=aw.horizon_s)
