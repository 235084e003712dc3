"""Store-and-forward earliest-arrival routing over a `ContactPlan`.

Contact-graph-routing (CGR) style: a parameter update sitting on satellite
`src` at `t_ready` may either wait for its own next ground pass or hop over
ISL edges (paying each hop's transfer time plus any wait for the edge's
next contact window) to a peer with an earlier pass — recursively, up to
`max_hops` ISL legs. Dijkstra over (satellite, arrival-time) labels finds
the route whose *server arrival* is earliest; the original satellite keeps
priority on ties (a relay must strictly beat the direct upload).

Per-leg transfer times come from the plan's own window pricing
(`next_isl_transfer` / `next_ground_upload`), so routes automatically
follow whatever rate model priced the plan: constant telemetry, midpoint
link budgets, or piecewise range profiles — a deep-fade window prices a
leg so slowly that the transfer no longer fits and the router detours or
falls back to the direct upload.

Port of `repro.comms.routing`: a verbatim copy (numpy and the standard
library), so routes are bitwise the reference's on the same plan.
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from repro_torch.comms.contact_plan import ContactPlan
from repro_torch.obs import count, span


@dataclasses.dataclass(frozen=True)
class Route:
    """One routed parameter return.

    path: satellite ids, source first; path[-1] performs the ground upload.
    departure_s: when the first transmission leaves the source (the source
      trains until this instant in UNTIL_CONTACT regimes).
    tx_start / arrival_s: final ground upload start / server receive time.
    isl_hops: number of ISL legs (0 == direct upload).
    bytes_on_wire: total bytes transmitted across all legs.
    """

    path: tuple[int, ...]
    departure_s: float
    tx_start: float
    arrival_s: float
    isl_hops: int
    bytes_on_wire: float

    @property
    def relay(self) -> int:
        """The uplinking peer in seed vocabulary (-1: no relay)."""
        return self.path[-1] if len(self.path) > 1 else -1


def earliest_arrival(plan: ContactPlan, src: int, t_ready: float,
                     n_bytes: float, max_hops: int = 3) -> Route | None:
    """Earliest-arrival route for `n_bytes` from `src` at `t_ready`.

    Returns None when no ground pass exists within the plan's horizon.
    With no ISL edges this degenerates to the direct upload.
    """
    with span("comms.route", src=src, max_hops=max_hops):
        return _earliest_arrival(plan, src, t_ready, n_bytes, max_hops)


def _earliest_arrival(plan: ContactPlan, src: int, t_ready: float,
                      n_bytes: float, max_hops: int) -> Route | None:
    count("comms.routes")
    # Dijkstra labels: (data-available time, hops, seq, sat, path,
    # first-leg start); `seq` breaks ordering ties before the
    # non-comparable payload fields. Labels are pruned per (sat, hops) —
    # not per sat — because a later-arriving low-hop label can still
    # extend further within the hop budget than an earlier high-hop one.
    heap: list = [(t_ready, 0, 0, src, (src,), None)]
    seq = 1
    # Per-satellite monotone arrival frontier: frontier[j][h] is the
    # earliest data-available time among labels at j with <= h hops.
    # Rows are non-increasing in h, so the dominance test ("some label
    # reaches j no later with no more hops") is a single lookup at
    # h = hops + 1, and an insert updates the suffix until it stops
    # improving — O(1) amortized, vs the old O(max_hops) dict scan per
    # edge relaxation.
    H = max_hops + 2
    inf = float("inf")
    frontier: dict[int, list[float]] = {src: [t_ready] * H}
    best: Route | None = None

    while heap:
        t, hops, _, k, path, first_leg = heapq.heappop(heap)
        if best is not None and t >= best.arrival_s:
            break  # data cannot arrive before an already-complete route
        # Option A: upload to ground from here.
        up = plan.next_ground_upload(k, t, n_bytes)
        if up is not None:
            tx_start, tx_end = up
            departure = first_leg if first_leg is not None else tx_start
            cand = Route(path=path, departure_s=departure, tx_start=tx_start,
                         arrival_s=tx_end, isl_hops=hops,
                         bytes_on_wire=n_bytes * (hops + 1))
            # Strict improvement only: the source keeps priority on ties.
            if best is None or cand.arrival_s < best.arrival_s:
                best = cand
        # Option B: hop to a neighbour over the next ISL window.
        if hops >= max_hops:
            continue
        for j in plan.isl_edges_of(k):
            if j in path:
                continue
            leg = plan.next_isl_transfer(k, j, t, n_bytes)
            if leg is None:
                continue
            s, e = leg
            fj = frontier.get(j)
            if fj is None:
                fj = frontier[j] = [inf] * H
            elif fj[hops + 1] <= e:
                continue  # dominated
            for hh in range(hops + 1, H):
                if e < fj[hh]:
                    fj[hh] = e
                else:
                    break
            heapq.heappush(heap, (e, hops + 1, seq, j, path + (j,),
                                  first_leg if first_leg is not None
                                  else s))
            seq += 1
    # Observability: relay-enabled searches that end in the direct upload
    # are "fallbacks" — the ISL graph bought nothing at this instant.
    if best is None:
        count("comms.routes_unreachable")
    elif max_hops > 0 and best.isl_hops == 0:
        count("comms.route_fallback_direct")
    return best


def batch_earliest_arrival(plan: ContactPlan, srcs, t_ready, n_bytes: float,
                           max_hops: int = 3) -> list[Route | None]:
    """Earliest-arrival routes for MANY sources in a handful of array sweeps.

    Vectorized label-correcting relaxation over the time-expanded contact
    graph: Bellman-Ford over the hop axis on the plan's padded
    `WindowTable`s. Level h holds, per (source, satellite), the earliest
    data-available time reachable with at most h ISL legs; each level
    expands every *reachable* (source, satellite) label into its
    out-edge lanes at once (one batched `WindowTable.transfer` + one
    lexsort winner pick per destination), so a whole round routes in
    `max_hops` sweeps whose lane counts track the frontier — not S x D,
    and not one Python Dijkstra per satellite.

    Returns a list aligned with `srcs` (None where no ground pass exists
    within the horizon). Matches per-source `earliest_arrival` exactly —
    same path, departure, tx window, arrival, hop count:

      * upload completion is monotone in availability time, so the
        per-satellite minimum label determines the best candidate;
      * updates keep the *first* (fewest-hop) achiever of a time, and
        relax-time ties prefer (earlier parent label, fewer parent hops,
        smaller parent id) — the same order Dijkstra's (t, hops, seq)
        heap pops and its `<=` dominance check enforce;
      * final candidates are ranked by (arrival, label time, hops, sat),
        so a relay must strictly beat the direct upload: the source's own
        label time `t_ready` is strictly the smallest, and the source
        keeps priority on ties.

    `t_ready` may be a scalar or a per-source array.
    """
    srcs = np.asarray(srcs, np.int64).reshape(-1)
    S = len(srcs)
    t_ready = np.broadcast_to(np.asarray(t_ready, float), (S,))
    with span("comms.route", batch=S, max_hops=max_hops):
        count("comms.batch_routes")
        count("comms.routes", S)
        return _batch_earliest_arrival(plan, srcs, t_ready, n_bytes,
                                       max_hops)


def _batch_earliest_arrival(plan: ContactPlan, srcs: np.ndarray,
                            t_ready: np.ndarray, n_bytes: float,
                            max_hops: int) -> list[Route | None]:
    tb = plan.tables()
    n = plan.n_sats
    S = len(srcs)
    INF = np.inf

    avail = np.full((S, n), INF)
    avail[np.arange(S), srcs] = t_ready
    # Cumulative per-level label descriptors: the minimum label at each
    # (source, sat) within <= h hops — its actual hop count, its parent,
    # and the level the label was created at (`plvl`; the parent's own
    # descriptor lives at level plvl - 1, which is how reconstruction
    # follows a child created from a *fewer-hop* parent label).
    levels = [{"avail": avail,
               "hops": np.zeros((S, n), np.int32),
               "parent": np.full((S, n), -1, np.int32),
               "plvl": np.zeros((S, n), np.int32)}]

    D = tb.n_directed
    if max_hops > 0 and D:
        # Out-edge CSR view of the adjacency: relaxation only ever
        # expands *reachable* labels, so each sweep prices a lane set
        # proportional to the frontier (sources x out-degree x hop
        # growth) instead of the dense S x D product.
        src_of = tb.adj_src[tb.out_order]
        dst_of = tb.adj_dst[tb.out_order]
        edge_of = tb.adj_edge[tb.out_order]
        for h in range(1, max_hops + 1):
            prev = levels[-1]
            fs, fu = np.nonzero(np.isfinite(prev["avail"]))
            deg = tb.out_starts[fu + 1] - tb.out_starts[fu]
            L = int(deg.sum())
            if L == 0:
                break
            # Expand every finite (source, sat) label into its out-edge
            # lanes: lane_o indexes the (src, dst)-sorted adjacency.
            lane_s = np.repeat(fs, deg)
            cum = np.cumsum(deg)
            offs = np.arange(L) - np.repeat(cum - deg, deg)
            lane_o = np.repeat(tb.out_starts[fu], deg) + offs
            tu = np.repeat(prev["avail"][fs, fu], deg)
            hu = np.repeat(prev["hops"][fs, fu], deg)
            _s, e_, ok = tb.isl.transfer(edge_of[lane_o], tu, n_bytes)
            e = np.where(ok, e_, INF)
            keep = np.isfinite(e)
            lane_s, lane_o = lane_s[keep], lane_o[keep]
            tu, hu, e = tu[keep], hu[keep], e[keep]
            dst, parent = dst_of[lane_o], src_of[lane_o]
            # Winner per (source, destination): lexicographic
            # (e, parent time, parent hops, parent id) — one stable
            # lexsort + group-first instead of masked scatter-mins.
            order = np.lexsort((parent, hu, tu, e, dst, lane_s))
            ls, ld = lane_s[order], dst[order]
            first = np.ones(len(order), bool)
            first[1:] = (ls[1:] != ls[:-1]) | (ld[1:] != ld[:-1])
            w = order[first]
            ws, wd = lane_s[w], dst[w]

            cand = np.full((S, n), INF)
            cand[ws, wd] = e[w]
            improved = cand < prev["avail"]
            if not improved.any():
                break  # label set converged before the hop budget
            cand_h = np.zeros((S, n))
            cand_h[ws, wd] = hu[w] + 1.0
            cand_p = np.full((S, n), -1.0)
            cand_p[ws, wd] = parent[w]
            levels.append({
                "avail": np.where(improved, cand, prev["avail"]),
                "hops": np.where(improved, cand_h,
                                 prev["hops"]).astype(np.int32),
                "parent": np.where(improved, cand_p,
                                   prev["parent"]).astype(np.int32),
                "plvl": np.where(improved, np.int32(h),
                                 prev["plvl"]).astype(np.int32),
            })

    final = levels[-1]
    T = final["avail"]
    # Ground uploads from every *reachable* (source, satellite) label —
    # unreachable lanes (label INF) can never upload, so only the finite
    # ones are priced (typically a sparse subset at mega-constellation
    # scale: hop-bounded reachability covers far fewer than n sats).
    T_flat = T.reshape(-1)
    lanes = np.flatnonzero(np.isfinite(T_flat))
    arrival = np.full(S * n, INF)
    tx0 = np.zeros(S * n)
    if len(lanes):
        g_rows = np.broadcast_to(np.arange(n), (S, n)).reshape(-1)
        bs, be, g_ok = tb.ground.ground_upload(g_rows[lanes], T_flat[lanes],
                                               n_bytes)
        arrival[lanes] = np.where(g_ok, be, INF)
        tx0[lanes] = bs
    arrival = arrival.reshape(S, n)
    tx0 = tx0.reshape(S, n)

    # Best candidate per source: lexicographic
    # (arrival, label time, hops, sat) — matches Dijkstra's strict-
    # improvement rule under its (t, hops, seq) pop order.
    m1 = arrival.min(axis=1)
    mask = arrival == m1[:, None]
    key = np.where(mask, T, INF)
    m2 = key.min(axis=1)
    mask &= key == m2[:, None]
    key = np.where(mask, final["hops"].astype(float), INF)
    mask &= key == key.min(axis=1)[:, None]
    kstar = mask.argmax(axis=1)

    routes: list[Route | None] = []
    for s in range(S):
        if not np.isfinite(m1[s]):
            count("comms.routes_unreachable")
            routes.append(None)
            continue
        k = int(kstar[s])
        hops = int(final["hops"][s, k])
        # Walk the per-level parent chain back to the source.
        path = [k]
        lvl = len(levels) - 1
        while levels[lvl]["hops"][s, k]:
            p = int(levels[lvl]["parent"][s, k])
            lvl = int(levels[lvl]["plvl"][s, k]) - 1
            path.append(p)
            k = p
        path.reverse()
        tx_start = float(tx0[s, int(kstar[s])])
        if hops:
            leg = plan.next_isl_transfer(path[0], path[1],
                                         float(t_ready[s]), n_bytes)
            departure = leg[0]
        else:
            departure = tx_start
            if max_hops > 0:
                count("comms.route_fallback_direct")
        routes.append(Route(path=tuple(path), departure_s=departure,
                            tx_start=tx_start, arrival_s=float(m1[s]),
                            isl_hops=hops,
                            bytes_on_wire=n_bytes * (hops + 1)))
    return routes
