"""Inter-satellite link topology + contact windows for Walker-Star.

Port of `repro.comms.isl`. `ISLTopology` enumerates the physical ISL
terminals of a `WalkerStar` constellation: an intra-plane ring (each
satellite links its fore/aft neighbours in the same plane) plus optional
cross-plane links between same-slot satellites of RAAN-adjacent planes
(the seam between the first and last plane is counter-rotating in a Star
pattern, so it carries no permanent link). The topology is numpy and a
verbatim copy of the reference's.

`compute_isl_windows` evaluates edge visibility on the device in float32
(`isl_visibility_grid`, the same formulas in the same operation order as
the reference's jitted grid), chunked over time so the (E, T) tensor never
materializes for the whole horizon, and reduces it to per-edge contact
intervals in numpy. An edge is visible when the earth (plus a 100 km
atmosphere pad) does not block the segment AND the range is within the
terminal's reach. Both are threshold tests on f32 positions, so a sample
whose blocking radius or range lies within float rounding of its threshold
may flip against the reference (as the ground mask's elevation does);
a run that needs bitwise timing passes one `ISLWindows` to both packages.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.obs import span
from repro_torch.orbits.access import extract_intervals, \
    merge_chunked_intervals
from repro_torch.orbits.constants import DEFAULT_DT_S, DEFAULT_HORIZON_S, \
    R_EARTH
from repro_torch.orbits.propagation import eci_positions
from repro_torch.orbits.walker import WalkerStar

# Terminal reach: generous enough for adjacent sats of a 10-per-plane ring
# at 500 km (~4250 km apart); the line-of-sight test prunes anything that
# dips through the atmosphere regardless of reach.
DEFAULT_ISL_MAX_RANGE_KM = 6000.0
ATMOSPHERE_PAD_M = 100e3


@dataclasses.dataclass(frozen=True)
class ISLTopology:
    """Undirected ISL edge set, stored with i < j."""

    edges: tuple[tuple[int, int], ...]

    @property
    def n_edges(self) -> int:
        return len(self.edges)

    def neighbors(self, n_sats: int) -> dict[int, list[int]]:
        out: dict[int, list[int]] = {k: [] for k in range(n_sats)}
        for i, j in self.edges:
            out[i].append(j)
            out[j].append(i)
        return out

    @classmethod
    def walker_star(cls, c: WalkerStar,
                    cross_plane: bool = False) -> "ISLTopology":
        """Intra-plane ring + optional same-slot cross-plane links."""
        return cls.walker_grid(c, cross_plane=cross_plane, seam_k=0)

    @classmethod
    def walker_grid(cls, c: WalkerStar, cross_plane: bool = False,
                    seam_k: int = 0) -> "ISLTopology":
        """Pruned ISL candidate set from plane/slot adjacency:

          * ring:        fore/aft neighbours within each plane;
          * cross_plane: same-slot satellites of RAAN-adjacent planes;
          * seam_k:      each satellite of the last plane may carry
                         candidates to its `seam_k` nearest slots (by
                         initial anomaly) of the first plane, across the
                         counter-rotating seam; the window search decides
                         which of those ever see each other.

        The candidate count is O(K * (2 + seam_k)), so the (E, T)
        visibility scan stays linear in fleet size.
        """
        P, S = c.clusters, c.sats_per_cluster
        pairs: list[np.ndarray] = []
        sats = np.arange(P * S, dtype=np.int64).reshape(P, S)
        if S >= 2:
            ring = np.stack([sats, np.roll(sats, -1, axis=1)], axis=-1)
            pairs.append(ring.reshape(-1, 2))
        if cross_plane and P >= 2:
            cross = np.stack([sats[:-1], sats[1:]], axis=-1)
            pairs.append(cross.reshape(-1, 2))
        if seam_k > 0 and P >= 2:
            # Slot phase difference between plane P-1 and plane 0, as a
            # fraction of a full revolution; nearest-k by angular offset.
            k = min(int(seam_k), S)
            phase = np.add.outer(np.arange(S), -np.arange(S)) / S
            if c.relative_phasing:
                phase = phase + c.relative_phasing * (P - 1) / S
            ang = np.abs((phase + 0.5) % 1.0 - 0.5)          # (S_last, S_0)
            nearest = np.argsort(ang, axis=1, kind="stable")[:, :k]
            seam = np.stack([np.broadcast_to(sats[-1][:, None], nearest.shape),
                             sats[0][nearest]], axis=-1)
            pairs.append(seam.reshape(-1, 2))
        if not pairs:
            return cls(edges=())
        cand = np.concatenate(pairs, axis=0)
        cand = np.stack([cand.min(axis=1), cand.max(axis=1)], axis=1)
        cand = np.unique(cand[cand[:, 0] != cand[:, 1]], axis=0)
        return cls(edges=tuple((int(i), int(j)) for i, j in cand))


@torch.no_grad()
def isl_margins(elements: dict, ei: torch.Tensor, ej: torch.Tensor,
                t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(E, T) float32 `(min_r, rng)` on `t.device`: the least distance from
    the earth's center to each edge's segment, and the edge's range — the
    two quantities `isl_visibility_grid` holds against its thresholds.
    `t` is (T,) float32 seconds; `ei`/`ej` (E,) int64 endpoint indices on
    the same device."""
    pos = eci_positions(elements, t)                  # (K, T, 3)
    a = pos[ei]                                       # (E, T, 3)
    diff = pos[ej] - a
    rng = torch.linalg.vector_norm(diff, dim=-1)      # (E, T)
    # Minimum distance from the earth's center to the segment a -> a+diff.
    tt = torch.clamp(-(a * diff).sum(-1)
                     / torch.clamp((diff * diff).sum(-1), min=1.0),
                     0.0, 1.0)
    closest = a + tt[..., None] * diff
    return torch.linalg.vector_norm(closest, dim=-1), rng


@torch.no_grad()
def isl_visibility_grid(elements: dict, ei: torch.Tensor, ej: torch.Tensor,
                        t: torch.Tensor, max_range_m: float) -> torch.Tensor:
    """(E, T) boolean on `t.device`: edge endpoints mutually visible (the
    segment clears the earth plus `ATMOSPHERE_PAD_M`) and within reach."""
    min_r, rng = isl_margins(elements, ei, ej, t)
    blocked = min_r < (R_EARTH + ATMOSPHERE_PAD_M)
    reach = torch.tensor(max_range_m, dtype=torch.float32, device=t.device)
    return (~blocked) & (rng <= reach)


@dataclasses.dataclass
class ISLWindows:
    """Per-edge ISL contact intervals over the simulation horizon.

    Attributes:
      edges: the topology's (i, j) pairs, i < j.
      per_edge: list (len E) of (starts, ends) float64 arrays.
      horizon_s, dt_s: grid the intervals were extracted from.
    """

    edges: tuple[tuple[int, int], ...]
    per_edge: list[tuple[np.ndarray, np.ndarray]]
    horizon_s: float
    dt_s: float

    @property
    def n_edges(self) -> int:
        return len(self.edges)

    def contact_fraction(self, e: int) -> float:
        starts, ends = self.per_edge[e]
        return float((ends - starts).sum() / self.horizon_s)


def compute_isl_windows(
    constellation: WalkerStar,
    topology: ISLTopology | None = None,
    horizon_s: float = DEFAULT_HORIZON_S,
    dt_s: float = DEFAULT_DT_S,
    max_range_km: float = DEFAULT_ISL_MAX_RANGE_KM,
    chunk_steps: int = 8192,
    device: str | torch.device | None = None,
) -> ISLWindows:
    """Contact intervals for every ISL edge (chunked over time), with the
    visibility grid computed on `device` (CUDA unless asked otherwise)."""
    dev = resolve_device(device)
    topo = topology or ISLTopology.walker_star(constellation)
    elements = constellation.elements()
    E = topo.n_edges
    if E == 0:
        return ISLWindows(edges=(), per_edge=[], horizon_s=horizon_s,
                          dt_s=dt_s)
    ei = torch.tensor([i for i, _ in topo.edges], dtype=torch.int64,
                      device=dev)
    ej = torch.tensor([j for _, j in topo.edges], dtype=torch.int64,
                      device=dev)
    max_range_m = max_range_km * 1e3
    n_steps = int(np.ceil(horizon_s / dt_s)) + 1

    trk_chunks: list[np.ndarray] = []
    rise_chunks: list[np.ndarray] = []
    fall_chunks: list[np.ndarray] = []
    for c0 in range(0, n_steps, chunk_steps):
        c1 = min(c0 + chunk_steps, n_steps)
        with span("comms.isl_chunk", t0_step=c0, steps=c1 - c0, edges=E):
            t = (np.arange(c0, c1) * dt_s).astype(np.float64)
            t_dev = torch.as_tensor(t, dtype=torch.float32, device=dev)
            vis = isl_visibility_grid(elements, ei, ej, t_dev,
                                      max_range_m).cpu().numpy()
        # Vectorized rise/fall pairing across all edge tracks.
        trk, rises, falls = extract_intervals(vis, float(t[0]), dt_s)
        trk_chunks.append(trk)
        rise_chunks.append(rises)
        fall_chunks.append(falls)

    # Stitch contacts split at chunk boundaries back together, then split
    # the flat result per edge.
    counts, starts, ends = merge_chunked_intervals(
        trk_chunks, rise_chunks, fall_chunks, E)
    cuts = np.cumsum(counts)[:-1]
    per_edge = list(zip(np.split(starts, cuts), np.split(ends, cuts)))
    return ISLWindows(edges=topo.edges, per_edge=per_edge,
                      horizon_s=horizon_s, dt_s=dt_s)
