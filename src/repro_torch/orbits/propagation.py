"""Two-body propagation for circular orbits + rotating-earth station positions.

Torch float32 port of `repro.orbits.propagation`: the same formulas in the
same operation order, so the visibility grid built on top of it flips on
the same samples as the reference (up to elevation-threshold ties from
differing f32 `sin`/`cos`/`asin` implementations). Time grids are the
trailing axis; positions are ECI (earth-centered inertial) in meters.
The float64 NumPy twins are verbatim copies.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.orbits.constants import MU_EARTH, OMEGA_EARTH, R_EARTH


def orbital_period(a_m: float) -> float:
    """Keplerian period [s] for semi-major axis a [m]."""
    return float(2.0 * np.pi * np.sqrt(a_m**3 / MU_EARTH))


def mean_motion(a_m: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(MU_EARTH / a_m ** 3)


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)


def eci_positions(elements: dict, t: torch.Tensor) -> torch.Tensor:
    """Satellite ECI positions, (K, T, 3) [m], float32 on `t.device`.

    `elements` is the dict from `walker_star_elements` (raan (K,),
    anomaly0 (K,), a scalar, inc scalar); `t` is (T,) float32 seconds.
    Plane orientation: rotate by inclination about x, then RAAN about z.
    """
    dev = t.device
    raan = _f32(elements["raan"], dev)[:, None]                    # (K,1)
    a = _f32(elements["a"], dev)
    theta = (_f32(elements["anomaly0"], dev)[:, None]
             + mean_motion(a) * t[None, :])                        # (K,T)
    inc = _f32(elements["inc"], dev)

    # In-plane (perifocal) coordinates.
    xp = a * torch.cos(theta)
    yp = a * torch.sin(theta)

    cos_i, sin_i = torch.cos(inc), torch.sin(inc)
    cos_O, sin_O = torch.cos(raan), torch.sin(raan)

    # R_z(RAAN) @ R_x(inc) @ [xp, yp, 0]
    x = cos_O * xp - sin_O * cos_i * yp
    y = sin_O * xp + cos_O * cos_i * yp
    z = sin_i * yp
    return torch.stack([x, y, z], dim=-1)                          # (K,T,3)


def eci_positions_np(elements: dict, t: np.ndarray) -> np.ndarray:
    """NumPy float64 twin of `eci_positions` (same formulas, same axes)."""
    raan = np.asarray(elements["raan"], dtype=float)[:, None]      # (K,1)
    n = np.sqrt(MU_EARTH / float(np.asarray(elements["a"])) ** 3)
    theta = (np.asarray(elements["anomaly0"], dtype=float)[:, None]
             + n * np.asarray(t, dtype=float)[None, :])            # (K,T)
    a = float(np.asarray(elements["a"]))
    inc = float(np.asarray(elements["inc"]))

    xp = a * np.cos(theta)
    yp = a * np.sin(theta)

    cos_i, sin_i = np.cos(inc), np.sin(inc)
    cos_O, sin_O = np.cos(raan), np.sin(raan)

    x = cos_O * xp - sin_O * cos_i * yp
    y = sin_O * xp + cos_O * cos_i * yp
    z = sin_i * yp
    return np.stack([x, y, z], axis=-1)  # (K,T,3)


def eci_positions_at_np(elements: dict, sat_idx: np.ndarray,
                        t: np.ndarray) -> np.ndarray:
    """Position of satellite `sat_idx[n]` at time `t[n]`, (N, 3) — the
    gather-shaped float64 twin of `eci_positions_np`."""
    idx = np.asarray(sat_idx, dtype=np.int64)
    raan = np.asarray(elements["raan"], dtype=float)[idx]          # (N,)
    n = np.sqrt(MU_EARTH / float(np.asarray(elements["a"])) ** 3)
    theta = (np.asarray(elements["anomaly0"], dtype=float)[idx]
             + n * np.asarray(t, dtype=float))                     # (N,)
    a = float(np.asarray(elements["a"]))
    inc = float(np.asarray(elements["inc"]))

    xp = a * np.cos(theta)
    yp = a * np.sin(theta)

    cos_i, sin_i = np.cos(inc), np.sin(inc)
    cos_O, sin_O = np.cos(raan), np.sin(raan)

    x = cos_O * xp - sin_O * cos_i * yp
    y = sin_O * xp + cos_O * cos_i * yp
    z = sin_i * yp
    return np.stack([x, y, z], axis=-1)  # (N,3)


def gs_eci_positions(lat_deg, lon_deg, t: torch.Tensor,
                     gmst0: float = 0.0) -> torch.Tensor:
    """Ground-station ECI positions on the rotating earth, (G, T, 3) [m].

    `lat_deg`, `lon_deg` are (G,) geodetic coordinates (spherical earth),
    `t` is (T,) float32 seconds, `gmst0` the sidereal angle at epoch.
    """
    dev = t.device
    lat = torch.deg2rad(_f32(lat_deg, dev))[:, None]               # (G,1)
    lon = torch.deg2rad(_f32(lon_deg, dev))[:, None]
    theta_g = gmst0 + OMEGA_EARTH * t[None, :]                     # (1,T)
    ang = lon + theta_g                                            # (G,T)
    cos_lat = torch.cos(lat)
    x = R_EARTH * cos_lat * torch.cos(ang)
    y = R_EARTH * cos_lat * torch.sin(ang)
    z = R_EARTH * torch.sin(lat) * torch.ones_like(ang)
    return torch.stack([x, y, z], dim=-1)                          # (G,T,3)


def gs_eci_positions_np(lat_deg, lon_deg, t: np.ndarray,
                        gmst0: float = 0.0) -> np.ndarray:
    """NumPy float64 twin of `gs_eci_positions` (see `eci_positions_np`)."""
    lat = np.deg2rad(np.asarray(lat_deg, dtype=float))[:, None]    # (G,1)
    lon = np.deg2rad(np.asarray(lon_deg, dtype=float))[:, None]
    ang = lon + gmst0 + OMEGA_EARTH * np.asarray(t, dtype=float)[None, :]
    cos_lat = np.cos(lat)
    x = R_EARTH * cos_lat * np.cos(ang)
    y = R_EARTH * cos_lat * np.sin(ang)
    z = R_EARTH * np.sin(lat) * np.ones_like(ang)
    return np.stack([x, y, z], axis=-1)                 # (G,T,3)


def _norm3(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over a trailing axis of 3, summed left to right."""
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                      + v[..., 2] * v[..., 2])


def elevation_deg(sat_eci: torch.Tensor, gs_eci: torch.Tensor) -> torch.Tensor:
    """Elevation angle [deg] of each satellite above each station's
    horizon: sat_eci (K, T, 3), gs_eci (G, T, 3) -> (K, G, T)."""
    rel = sat_eci[:, None, :, :] - gs_eci[None, :, :, :]           # (K,G,T,3)
    rel_norm = _norm3(rel)
    up = gs_eci / _norm3(gs_eci)[..., None]                        # (G,T,3)
    dot = (rel[..., 0] * up[..., 0] + rel[..., 1] * up[..., 1]
           + rel[..., 2] * up[..., 2])
    sin_el = dot / torch.clamp(rel_norm, min=1.0)
    return torch.rad2deg(torch.asin(torch.clamp(sin_el, -1.0, 1.0)))


def sat_to_sat_range_m(sat_eci: torch.Tensor) -> torch.Tensor:
    """Pairwise inter-satellite ranges [m], sat_eci (K, T, 3) -> (K, K, T),
    with a line-of-sight check: +inf where the earth (with a 100 km
    atmosphere pad) blocks the segment from satellite i to satellite j,
    else the Euclidean range. float32 on the positions' device."""
    diff = sat_eci[None, :] - sat_eci[:, None]          # (K,K,T,3) j - i
    rng = _norm3(diff)
    # Line of sight: the least distance from earth's center to the
    # segment a -> a + diff.
    a = sat_eci[:, None].expand_as(diff)                       # (K,K,T,3)
    a_dot_d = (a[..., 0] * diff[..., 0] + a[..., 1] * diff[..., 1]
               + a[..., 2] * diff[..., 2])
    d_dot_d = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
               + diff[..., 2] * diff[..., 2])
    tt = torch.clamp(-a_dot_d / torch.clamp(d_dot_d, min=1.0), 0.0, 1.0)
    min_r = _norm3(a + tt[..., None] * diff)
    blocked = min_r < (R_EARTH + 100e3)
    return torch.where(blocked, torch.full_like(rng, float("inf")), rng)
