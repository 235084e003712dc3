"""Port orbits and data vs the reference: copies bitwise, windows equal."""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.femnist import synth_femnist as jax_synth_femnist
from repro.orbits import WalkerStar as JaxWalkerStar
from repro.orbits import compute_access_windows as jax_windows
from repro.orbits import station_subnetwork as jax_stations
from repro.orbits.propagation import eci_positions as jax_eci
from repro.orbits.propagation import elevation_deg as jax_elevation
from repro.orbits.propagation import gs_eci_positions as jax_gs
from repro.orbits.stations import station_latlon as jax_latlon
from repro_torch.data.femnist import synth_femnist
from repro_torch.orbits import (
    IGS_STATIONS,
    WalkerStar,
    compute_access_windows,
    station_subnetwork,
)
from repro_torch.orbits import propagation
from repro_torch.orbits.access import visibility_grid
from repro_torch.orbits.stations import station_latlon


@pytest.mark.parametrize("clusters,sats,phasing", [(1, 1, 0.0), (2, 3, 0.0),
                                                   (10, 10, 0.0),
                                                   (3, 4, 0.5)])
def test_walker_elements_bitwise(clusters, sats, phasing):
    mine = WalkerStar(clusters, sats, relative_phasing=phasing).elements()
    ref = JaxWalkerStar(clusters, sats, relative_phasing=phasing).elements()
    assert mine.keys() == ref.keys()
    for key in ref:
        np.testing.assert_array_equal(np.asarray(mine[key]),
                                      np.asarray(ref[key]))
        assert np.asarray(mine[key]).dtype == np.asarray(ref[key]).dtype


def test_stations_bitwise():
    for n in (1, 2, 3, 5, 10, 13):
        mine = [dataclasses.astuple(s) for s in station_subnetwork(n)]
        ref = [dataclasses.astuple(s) for s in jax_stations(n)]
        assert mine == ref
    lat, lon = station_latlon(IGS_STATIONS)
    rlat, rlon = jax_latlon(jax_stations(13))
    np.testing.assert_array_equal(lat, rlat)
    np.testing.assert_array_equal(lon, rlon)


def test_synth_femnist_bitwise():
    mine, ref = synth_femnist(3, seed=5), jax_synth_femnist(3, seed=5)
    for field in ("x", "y", "n", "x_eval", "y_eval", "n_eval"):
        a, b = getattr(mine, field), getattr(ref, field)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b), field


def test_numpy_twins_match_torch_f32():
    el = WalkerStar(2, 3).elements()
    t = np.arange(0, 7200, 30.0)
    tt = torch.as_tensor(t, dtype=torch.float32)
    np.testing.assert_allclose(propagation.eci_positions(el, tt).numpy(),
                               propagation.eci_positions_np(el, t),
                               rtol=0, atol=50.0)      # f32 metres at 7e6 m
    idx = np.array([0, 5, 3])
    at = propagation.eci_positions_at_np(el, idx, t[:3])
    dense = propagation.eci_positions_np(el, t[:3])
    np.testing.assert_array_equal(at, dense[idx, np.arange(3)])
    lat, lon = station_latlon(station_subnetwork(3))
    np.testing.assert_allclose(
        propagation.gs_eci_positions(lat, lon, tt).numpy(),
        propagation.gs_eci_positions_np(lat, lon, t), rtol=0, atol=50.0)


def _intervals(aw):
    return ([(s.tolist(), e.tolist()) for s, e in aw.per_sat],
            [[(s.tolist(), e.tolist()) for s, e in row]
             for row in aw.per_sat_station])


@pytest.mark.parametrize("clusters,sats,g,days", [(2, 3, 2, 6.0),
                                                  (3, 2, 1, 4.0)])
def test_access_windows_identical(clusters, sats, g, days):
    horizon = days * 86400.0
    mine = compute_access_windows(WalkerStar(clusters, sats),
                                  station_subnetwork(g), horizon_s=horizon,
                                  chunk_steps=4096, device="cpu")
    ref = jax_windows(JaxWalkerStar(clusters, sats), jax_stations(g),
                      horizon_s=horizon, chunk_steps=4096)
    assert _intervals(mine) == _intervals(ref)
    np.testing.assert_array_equal(mine.cluster, ref.cluster)
    assert (mine.horizon_s, mine.dt_s) == (ref.horizon_s, ref.dt_s)
    assert sum(len(s) for s, _ in mine.per_sat) > 0


def test_visibility_differences_are_threshold_ties():
    """On c3s3/g3 over 2 days, any sample where the port's f32 grid
    differs from the reference's has a reference elevation within 1e-3
    degrees of the 10-degree mask."""
    cst, st = WalkerStar(3, 3), station_subnetwork(3)
    el = cst.elements()
    lat, lon = station_latlon(st)
    t = np.arange(0, int(np.ceil(2 * 86400 / 30.0)) + 1) * 30.0
    mine = visibility_grid(el, lat, lon,
                           torch.as_tensor(t, dtype=torch.float32)).numpy()
    tj = jnp.asarray(t)
    elev = np.asarray(jax_elevation(jax_eci(el, tj), jax_gs(lat, lon, tj)))
    ref = elev >= 10.0
    assert mine.shape == ref.shape == (9, 3, len(t))
    assert ref.any()
    diff = mine != ref
    assert np.all(np.abs(elev[diff] - 10.0) < 1e-3)
    ours = compute_access_windows(cst, st, horizon_s=2 * 86400.0,
                                  device="cpu")
    theirs = jax_windows(JaxWalkerStar(3, 3), jax_stations(3),
                         horizon_s=2 * 86400.0)
    if not diff.any():
        assert _intervals(ours) == _intervals(theirs)
