"""Access-window computation: satellite <-> ground-station contact intervals.

The visibility grid is computed on the device in float32 (chunked over
time so the (K, G, T) tensor never materializes whole), then reduced to
per-satellite interval lists in numpy for fast event-driven queries by the
simulator. Port of `repro.orbits.access`; the numpy half is a verbatim
copy.
"""
from __future__ import annotations

import bisect
import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.obs import span
from repro_torch.orbits.constants import (
    DEFAULT_DT_S,
    DEFAULT_ELEVATION_MASK_DEG,
    DEFAULT_HORIZON_S,
)
from repro_torch.orbits.propagation import (
    eci_positions,
    elevation_deg,
    gs_eci_positions,
)
from repro_torch.orbits.stations import station_latlon
from repro_torch.orbits.walker import WalkerStar


@torch.no_grad()
def visibility_grid(elements: dict, lat, lon, t: torch.Tensor,
                    mask_deg: float = DEFAULT_ELEVATION_MASK_DEG
                    ) -> torch.Tensor:
    """(K, G, T) boolean visibility at elevation >= mask, on `t.device`."""
    sat = eci_positions(elements, t)
    gs = gs_eci_positions(lat, lon, t)
    return elevation_deg(sat, gs) >= mask_deg


def extract_intervals(vis: np.ndarray, t0: float, dt_s: float
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Rise/fall intervals of every track of a (..., T) boolean grid.

    Pads each track with False on both sides, finds the flip positions,
    and pairs them up (flips alternate rise/fall per track, and
    ``np.nonzero`` returns row-major order). Returns ``(track, rises,
    falls)``: flat int track ids (row-major over the leading axes) and
    the float64 interval bounds ``t0 + index*dt_s``.
    """
    T = vis.shape[-1]
    grid = vis.reshape(-1, T)
    padded = np.zeros((grid.shape[0], T + 2), bool)
    padded[:, 1:-1] = grid
    flips = padded[:, 1:] != padded[:, :-1]
    tracks, ts = np.nonzero(flips)
    return tracks[0::2], t0 + ts[0::2] * dt_s, t0 + ts[1::2] * dt_s


def merge_chunked_intervals(
    track_chunks: list[np.ndarray], rise_chunks: list[np.ndarray],
    fall_chunks: list[np.ndarray], n_tracks: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stitch per-chunk intervals back together, vectorized over tracks.

    Chunked scans split a contact at every chunk boundary; within one
    track the chunks arrive in time order, so a stable sort by track id
    groups each track's intervals in time order, and an interval
    continues its predecessor exactly when its rise does not exceed the
    previous fall. Returns ``(counts, starts, ends)``: per-track interval
    counts (length `n_tracks`) and the flat merged bounds.
    """
    trk = np.concatenate(track_chunks) if track_chunks else np.empty(0, int)
    rise = np.concatenate(rise_chunks) if rise_chunks else np.empty(0)
    fall = np.concatenate(fall_chunks) if fall_chunks else np.empty(0)
    order = np.argsort(trk, kind="stable")
    trk, rise, fall = trk[order], rise[order], fall[order]
    if len(trk) == 0:
        return np.zeros(n_tracks, int), rise, fall
    new = np.empty(len(trk), bool)
    new[0] = True
    new[1:] = (trk[1:] != trk[:-1]) | (rise[1:] > fall[:-1])
    first = np.flatnonzero(new)
    last = np.append(first[1:], len(trk)) - 1
    counts = np.bincount(trk[first], minlength=n_tracks)
    return counts, rise[first], fall[last]


def _merge_intervals(intervals: list[tuple[float, float]]
                     ) -> list[tuple[float, float]]:
    if not intervals:
        return []
    intervals = sorted(intervals)
    out = [list(intervals[0])]
    for s, e in intervals[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


@dataclasses.dataclass
class AccessWindows:
    """Per-satellite ground-contact intervals over the simulation horizon.

    Attributes:
      per_sat: list (len K) of (starts, ends) float64 arrays — merged over
        all stations in the network.
      per_sat_station: list (len K) of list (len G) of (starts, ends) —
        unmerged, used by augmentations that care which station is hit.
      cluster: (K,) int cluster id per satellite.
      horizon_s: simulation horizon.
    """

    per_sat: list[tuple[np.ndarray, np.ndarray]]
    per_sat_station: list[list[tuple[np.ndarray, np.ndarray]]]
    cluster: np.ndarray
    horizon_s: float
    dt_s: float

    @property
    def n_sats(self) -> int:
        return len(self.per_sat)

    def next_window(self, k: int, t: float) -> tuple[float, float] | None:
        """Earliest contact window for satellite k that is active at or
        starts after time t. Returns (start, end) with start >= t semantics:
        if t falls inside a window, returns (t, window_end)."""
        starts, ends = self.per_sat[k]
        if len(starts) == 0:
            return None
        i = bisect.bisect_right(ends, t)  # first window with end > t
        if i >= len(starts):
            return None
        s, e = starts[i], ends[i]
        return (max(s, t), e)

    def contact_fraction(self, k: int) -> float:
        starts, ends = self.per_sat[k]
        return float((ends - starts).sum() / self.horizon_s)

    def cluster_members(self, k: int) -> np.ndarray:
        return np.flatnonzero(self.cluster == self.cluster[k])

    def subset(self, n_stations: int) -> "AccessWindows":
        """Windows restricted to the first n stations (the subset ladder
        is nested, so one 13-station computation serves all sizes)."""
        per_sat_station = [row[:n_stations] for row in self.per_sat_station]
        per_sat = []
        for row in per_sat_station:
            merged = _merge_intervals(
                [(float(s), float(e)) for st, en in row
                 for s, e in zip(st, en)])
            per_sat.append((np.array([s for s, _ in merged]),
                            np.array([e for _, e in merged])))
        return AccessWindows(per_sat=per_sat,
                             per_sat_station=per_sat_station,
                             cluster=self.cluster, horizon_s=self.horizon_s,
                             dt_s=self.dt_s)

    def cluster_next_window(self, cluster_id: int, t: float
                            ) -> tuple[int, float, float] | None:
        """Earliest contact among all satellites of a cluster: (sat, s, e)."""
        best = None
        for k in np.flatnonzero(self.cluster == cluster_id):
            w = self.next_window(int(k), t)
            if w is not None and (best is None or w[0] < best[1]):
                best = (int(k), w[0], w[1])
        return best


def compute_access_windows(
    constellation: WalkerStar,
    stations,
    horizon_s: float = DEFAULT_HORIZON_S,
    dt_s: float = DEFAULT_DT_S,
    mask_deg: float = DEFAULT_ELEVATION_MASK_DEG,
    chunk_steps: int = 8192,
    device: str | torch.device | None = None,
) -> AccessWindows:
    """Compute contact intervals for every (satellite, station) pair.

    Time is chunked so device memory stays bounded at
    K * G * chunk_steps samples (a few float32 temporaries each).
    """
    dev = resolve_device(device)
    elements = constellation.elements()
    lat, lon = station_latlon(stations)
    K, G = constellation.n_sats, len(stations)
    n_steps = int(np.ceil(horizon_s / dt_s)) + 1

    trk_chunks: list[np.ndarray] = []
    rise_chunks: list[np.ndarray] = []
    fall_chunks: list[np.ndarray] = []
    for c0 in range(0, n_steps, chunk_steps):
        c1 = min(c0 + chunk_steps, n_steps)
        with span("orbits.access_chunk", t0_step=c0, steps=c1 - c0,
                  sats=K, stations=G):
            t = (np.arange(c0, c1) * dt_s).astype(np.float64)
            t_dev = torch.as_tensor(t, dtype=torch.float32, device=dev)
            vis = visibility_grid(elements, lat, lon, t_dev,
                                  mask_deg=mask_deg).cpu().numpy()
        # Vectorized rise/fall pairing across all (sat, station) tracks;
        # track id is k * G + g (row-major).
        trk, rises, falls = extract_intervals(vis, float(t[0]), dt_s)
        trk_chunks.append(trk)
        rise_chunks.append(rises)
        fall_chunks.append(falls)

    counts, starts, ends = merge_chunked_intervals(
        trk_chunks, rise_chunks, fall_chunks, K * G)
    cuts = np.cumsum(counts)[:-1]
    s_split = np.split(starts, cuts)
    e_split = np.split(ends, cuts)

    per_sat_station: list[list[tuple[np.ndarray, np.ndarray]]] = []
    per_sat: list[tuple[np.ndarray, np.ndarray]] = []
    for k in range(K):
        row = list(zip(s_split[k * G:(k + 1) * G],
                       e_split[k * G:(k + 1) * G]))
        per_sat_station.append(row)
        # Stations overlap, so the satellite-level merge keeps the
        # running-max-end rule of `_merge_intervals`.
        merged = _merge_intervals(
            [(float(s), float(e)) for st, en in row
             for s, e in zip(st, en)])
        per_sat.append((np.array([s for s, _ in merged]),
                        np.array([e for _, e in merged])))

    return AccessWindows(
        per_sat=per_sat,
        per_sat_station=per_sat_station,
        cluster=elements["cluster"],
        horizon_s=horizon_s,
        dt_s=dt_s,
    )
