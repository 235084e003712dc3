"""Walker-Star constellation construction (paper Table 2).

A Walker-Star constellation spreads P orbital planes ("clusters" in the
paper's vocabulary) uniformly over 180 deg of RAAN, with S satellites per
plane uniformly spaced in true anomaly. All orbits are circular and polar.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.orbits.constants import (
    DEFAULT_ALTITUDE_KM,
    DEFAULT_INCLINATION_DEG,
    R_EARTH,
)


@dataclasses.dataclass(frozen=True)
class WalkerStar:
    """A Walker-Star constellation: `clusters` planes x `sats_per_cluster`.

    Paper sweep: clusters in {1,2,5,10}, sats_per_cluster in {1,2,5,10}.
    """

    clusters: int
    sats_per_cluster: int
    altitude_km: float = DEFAULT_ALTITUDE_KM
    inclination_deg: float = DEFAULT_INCLINATION_DEG
    # Phase offset between adjacent planes (fraction of in-plane spacing).
    relative_phasing: float = 0.0

    @property
    def n_sats(self) -> int:
        return self.clusters * self.sats_per_cluster

    @property
    def semi_major_axis_m(self) -> float:
        return R_EARTH + self.altitude_km * 1e3

    def cluster_of(self, k: int) -> int:
        return k // self.sats_per_cluster

    def elements(self) -> dict:
        return walker_star_elements(self)


def walker_star_elements(c: WalkerStar) -> dict:
    """Return per-satellite orbital elements as numpy arrays.

    Keys: raan [rad] (n_sats,), anomaly0 [rad] (n_sats,), a [m] scalar,
    inc [rad] scalar, cluster (n_sats,) int.

    Walker-Star: RAAN spread over pi (star pattern — ascending/descending
    halves cover the globe); uniform true-anomaly spacing within a plane.
    """
    P, S = c.clusters, c.sats_per_cluster
    raan_planes = np.pi * np.arange(P) / P  # uniform over 180 deg
    anomaly_in_plane = 2.0 * np.pi * np.arange(S) / S
    raan = np.repeat(raan_planes, S)
    anomaly0 = np.tile(anomaly_in_plane, P)
    # Optional inter-plane phasing (Walker F parameter analogue).
    if c.relative_phasing:
        phase = 2.0 * np.pi * c.relative_phasing / max(S, 1)
        anomaly0 = anomaly0 + phase * np.repeat(np.arange(P), S)
    cluster = np.repeat(np.arange(P), S)
    return {
        "raan": raan.astype(np.float64),
        "anomaly0": anomaly0.astype(np.float64),
        "a": float(c.semi_major_axis_m),
        "inc": float(np.deg2rad(c.inclination_deg)),
        "cluster": cluster.astype(np.int32),
    }
