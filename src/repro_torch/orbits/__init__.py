"""Orbital mechanics substrate (port of `repro.orbits`).

Two-body propagation for circular orbits on the device in float32,
Walker-Star construction, the ground-station network, and access-window
extraction.
"""
from repro_torch.orbits.constants import (
    MU_EARTH,
    R_EARTH,
    OMEGA_EARTH,
    DEFAULT_ALTITUDE_KM,
    DEFAULT_ELEVATION_MASK_DEG,
)
from repro_torch.orbits.walker import WalkerStar, walker_star_elements
from repro_torch.orbits.propagation import (
    eci_positions,
    gs_eci_positions,
    orbital_period,
)
from repro_torch.orbits.stations import (
    IGS_STATIONS,
    GroundStation,
    station_subnetwork,
)
from repro_torch.orbits.access import (
    AccessWindows,
    compute_access_windows,
    visibility_grid,
)

__all__ = [
    "MU_EARTH",
    "R_EARTH",
    "OMEGA_EARTH",
    "DEFAULT_ALTITUDE_KM",
    "DEFAULT_ELEVATION_MASK_DEG",
    "WalkerStar",
    "walker_star_elements",
    "eci_positions",
    "gs_eci_positions",
    "orbital_period",
    "IGS_STATIONS",
    "GroundStation",
    "station_subnetwork",
    "AccessWindows",
    "compute_access_windows",
    "visibility_grid",
]
