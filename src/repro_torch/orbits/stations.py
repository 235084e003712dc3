"""The IGS-inspired ground-station network (paper Table 3 / Figure 3)."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class GroundStation:
    name: str
    lat: float
    lon: float


# Exact sites + subset ladder from Table 3. The first N entries of this list
# form the N-station configuration for N in {1, 2, 3, 5, 10, 13}.
IGS_STATIONS = (
    GroundStation("Sioux Falls", 43.55, -96.72),
    GroundStation("Sanya", 18.25, 109.5),
    GroundStation("Johannesburg", -26.2, 28.03),
    GroundStation("Cordoba", -31.4, -64.18),
    GroundStation("Tromso", 69.65, 18.95),
    GroundStation("Kashi", 39.1, 77.2),
    GroundStation("Beijing", 39.9, 116.4),
    GroundStation("Neustrelitz", 53.1, 13.1),
    GroundStation("Parepare", -2.99, 119.8),
    GroundStation("Alice Springs", -25.1, 133.9),
    GroundStation("Fairbanks", 64.8, -147.7),
    GroundStation("Prince Albert", 53.2, -105.7),
    GroundStation("Shadnagar", 17.4, 78.5),
)

VALID_NETWORK_SIZES = (1, 2, 3, 5, 10, 13)


def station_subnetwork(n: int) -> tuple[GroundStation, ...]:
    """The first-n subset ladder used in the paper's sweeps."""
    if n < 1 or n > len(IGS_STATIONS):
        raise ValueError(f"network size {n} outside [1, {len(IGS_STATIONS)}]")
    return IGS_STATIONS[:n]


def station_latlon(stations) -> tuple[np.ndarray, np.ndarray]:
    lat = np.array([s.lat for s in stations], dtype=np.float64)
    lon = np.array([s.lon for s in stations], dtype=np.float64)
    return lat, lon
