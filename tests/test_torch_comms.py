"""Port comms layer (`repro_torch.comms`) vs the reference `repro.comms`.

Tolerances, stated per part:
  * links, ISL topologies, contact plans, outlook queries, re-rating and
    routing are numpy float64 copies of the reference: bitwise, on one
    shared `AccessWindows` + `ISLWindows` (computed by the reference and
    handed to both packages);
  * ISL windows from each package's own f32 visibility grid: bitwise on
    the golden engine scenarios (c2s3 over 6 d, c3s2 over 4 d) and on a
    dense ring (c1s10 over 1 d); on a larger grid every differing sample
    must be a threshold tie: the reference's blocking radius within
    `TIE_M` of R_EARTH + 100 km, or its range within `TIE_M` of the reach.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comms import contact_plan as jplan_mod
from repro.comms import isl as jisl
from repro.comms import links as jlinks
from repro.comms import routing as jrouting
from repro.orbits import WalkerStar as JaxWalkerStar
from repro.orbits import compute_access_windows as jax_windows
from repro.orbits import station_subnetwork as jax_stations
from repro.orbits.propagation import eci_positions as jax_eci
from repro_torch import comms
from repro_torch.comms import contact_plan, isl, links, routing
from repro_torch.orbits import WalkerStar, station_subnetwork
from repro_torch.orbits.access import AccessWindows
from torch_parity import assert_same_plan, same_table

# Threshold-tie band for the ISL distance tests [m]: positions at ~6.9e6 m
# carry f32 ulps of 0.5 m, and the f32 sin/cos of an argument up to ~200
# rad differ between libraries by an ulp of the result (~1 m of
# position); 50 m leaves an order of magnitude.
TIE_M = 50.0


def test_all_matches_reference():
    import repro.comms as jcomms
    assert comms.__all__ == jcomms.__all__


# ------------------------------------------------------------------ links --
def test_links_bitwise():
    ranges = np.geomspace(1.0, 5e7, 97)
    for mine, ref in ((links.ConstantRate(), jlinks.ConstantRate()),
                      (links.ConstantRate(123.4), jlinks.ConstantRate(123.4)),
                      (links.LinkBudget(), jlinks.LinkBudget()),
                      (links.LinkBudget(bandwidth_hz=50e6, losses_db=9.0),
                       jlinks.LinkBudget(bandwidth_hz=50e6, losses_db=9.0))):
        assert mine.geometry_free == ref.geometry_free
        np.testing.assert_array_equal(mine.rate_bps(ranges),
                                      ref.rate_bps(ranges))
        assert mine.rate_bps(2e6) == ref.rate_bps(2e6)
        for n in (186_000, 1.0, 3e9):
            for r in (0.0, 1e3, 4.2e6, 1e12):
                assert mine.tx_time_s(n, r) == ref.tx_time_s(n, r)
        if not mine.geometry_free:
            assert mine.ref_rate_bps == ref.ref_rate_bps
            np.testing.assert_array_equal(mine.fspl_db(ranges),
                                          ref.fspl_db(ranges))
            np.testing.assert_array_equal(mine.snr_db(ranges),
                                          ref.snr_db(ranges))
    assert links.MIN_RATE_BPS == jlinks.MIN_RATE_BPS
    a = np.random.default_rng(0).normal(size=(5, 3)) * 7e6
    b = np.random.default_rng(1).normal(size=(5, 3)) * 7e6
    np.testing.assert_array_equal(links.slant_range_m(a, b),
                                  jlinks.slant_range_m(a, b))


# ---------------------------------------------------------------- topology --
@pytest.mark.parametrize("P,S,phasing", [(1, 10, 0.0), (2, 3, 0.0),
                                         (6, 8, 0.0), (5, 7, 0.5),
                                         (32, 32, 0.0), (3, 1, 0.0)])
def test_topologies_identical(P, S, phasing):
    mine, ref = WalkerStar(P, S, relative_phasing=phasing), \
        JaxWalkerStar(P, S, relative_phasing=phasing)
    for cross in (False, True):
        assert isl.ISLTopology.walker_star(mine, cross).edges == \
            jisl.ISLTopology.walker_star(ref, cross).edges
        for seam_k in (0, 1, 2, 5):
            m = isl.ISLTopology.walker_grid(mine, cross, seam_k)
            r = jisl.ISLTopology.walker_grid(ref, cross, seam_k)
            assert m.edges == r.edges
            assert m.neighbors(P * S) == r.neighbors(P * S)


# ------------------------------------------------------------- ISL windows --
def _same_windows(mine, ref) -> bool:
    return (mine.edges == ref.edges
            and (mine.horizon_s, mine.dt_s) == (ref.horizon_s, ref.dt_s)
            and len(mine.per_edge) == len(ref.per_edge)
            and all(np.array_equal(ms, rs) and np.array_equal(me, re)
                    and ms.dtype == rs.dtype
                    for (ms, me), (rs, re) in zip(mine.per_edge,
                                                  ref.per_edge)))


@pytest.mark.parametrize("P,S,days,cross", [(2, 3, 6.0, False),
                                            (3, 2, 4.0, False),
                                            (1, 10, 1.0, False),
                                            (4, 10, 0.5, True)])
def test_isl_windows_bitwise(P, S, days, cross):
    horizon = days * 86400.0
    mine = isl.compute_isl_windows(
        WalkerStar(P, S), isl.ISLTopology.walker_star(WalkerStar(P, S),
                                                      cross),
        horizon_s=horizon, chunk_steps=1000, device="cpu")
    ref = jisl.compute_isl_windows(
        JaxWalkerStar(P, S), jisl.ISLTopology.walker_star(
            JaxWalkerStar(P, S), cross), horizon_s=horizon, chunk_steps=1000)
    assert _same_windows(mine, ref)
    if S >= 10:
        assert sum(len(s) for s, _ in mine.per_edge) > 0
    for e in range(mine.n_edges):
        assert mine.contact_fraction(e) == ref.contact_fraction(e)


def test_isl_visibility_differences_are_threshold_ties():
    """c10s10 with cross-plane links and 2 seam candidates over 2 days:
    every sample where the port's f32 grid differs from the reference's is
    a tie of the blocking radius or the range with its threshold."""
    cst = WalkerStar(10, 10)
    el = cst.elements()
    topo = isl.ISLTopology.walker_grid(cst, cross_plane=True, seam_k=2)
    ei = np.array([i for i, _ in topo.edges])
    ej = np.array([j for _, j in topo.edges])
    t = np.arange(0, int(np.ceil(2 * 86400 / 30.0)) + 1) * 30.0
    mine = isl.isl_visibility_grid(
        el, torch.as_tensor(ei), torch.as_tensor(ej),
        torch.as_tensor(t, dtype=torch.float32),
        isl.DEFAULT_ISL_MAX_RANGE_KM * 1e3).numpy()
    tj = jnp.asarray(t)
    ref = np.asarray(jisl.isl_visibility_grid(
        el, jnp.asarray(ei, jnp.int32), jnp.asarray(ej, jnp.int32), tj,
        jnp.asarray(isl.DEFAULT_ISL_MAX_RANGE_KM * 1e3)))
    assert mine.shape == ref.shape == (len(ei), len(t))
    assert 0.1 < ref.mean() < 1.0
    diff = mine != ref
    print(f"ISL grid: {int(diff.sum())} of {diff.size} samples differ")
    if diff.any():
        pos = jax_eci(el, tj)
        a, d = pos[ei], pos[ej] - pos[ei]
        rng = np.asarray(jnp.linalg.norm(d, axis=-1))
        tt = jnp.clip(-jnp.einsum("etc,etc->et", a, d)
                      / jnp.maximum(jnp.einsum("etc,etc->et", d, d), 1.0),
                      0.0, 1.0)
        min_r = np.asarray(jnp.linalg.norm(a + tt[..., None] * d, axis=-1))
        tie = ((np.abs(min_r - (isl.R_EARTH + isl.ATMOSPHERE_PAD_M))
                <= TIE_M)
               | (np.abs(rng - isl.DEFAULT_ISL_MAX_RANGE_KM * 1e3) <= TIE_M))
        assert bool(tie[diff].all())


def test_isl_margins_are_the_grid_quantities():
    cst = WalkerStar(2, 10)
    el = cst.elements()
    topo = isl.ISLTopology.walker_star(cst, cross_plane=True)
    ei = torch.tensor([i for i, _ in topo.edges])
    ej = torch.tensor([j for _, j in topo.edges])
    t = torch.arange(0, 3000, 30.0)
    min_r, rng = isl.isl_margins(el, ei, ej, t)
    grid = isl.isl_visibility_grid(el, ei, ej, t, 6e6)
    assert torch.equal(grid, (min_r >= isl.R_EARTH + isl.ATMOSPHERE_PAD_M)
                       & (rng <= 6e6))


# ------------------------------------------------- plans on shared windows --
HORIZON = 86400.0


@pytest.fixture(scope="module")
def shared():
    """c4s10/g3 over 1 day: the reference's access and ISL windows (ring +
    cross-plane), and the same windows as the port's types."""
    cst = JaxWalkerStar(4, 10)
    aw = jax_windows(cst, jax_stations(3), horizon_s=HORIZON)
    iw = jisl.compute_isl_windows(
        cst, jisl.ISLTopology.walker_star(cst, cross_plane=True),
        horizon_s=HORIZON)
    paw = AccessWindows(aw.per_sat, aw.per_sat_station, aw.cluster,
                        aw.horizon_s, aw.dt_s)
    piw = isl.ISLWindows(iw.edges, iw.per_edge, iw.horizon_s, iw.dt_s)
    return aw, iw, paw, piw


def _plans(shared, kind: str):
    """(port plan, reference plan) built the same way on shared windows."""
    aw, iw, paw, piw = shared
    pc, jc = WalkerStar(4, 10), JaxWalkerStar(4, 10)
    pst, jst = station_subnetwork(3), jax_stations(3)
    if kind == "constant":
        return (contact_plan.build_contact_plan(paw, piw),
                jplan_mod.build_contact_plan(aw, iw))
    if kind == "budget":
        return (contact_plan.build_contact_plan(
                    paw, piw, links.LinkBudget(), constellation=pc,
                    stations=pst),
                jplan_mod.build_contact_plan(
                    aw, iw, jlinks.LinkBudget(), constellation=jc,
                    stations=jst))
    mine = contact_plan.build_contact_plan(
        paw, piw, constellation=pc, stations=pst, cache_geometry=True)
    ref = jplan_mod.build_contact_plan(
        aw, iw, constellation=jc, stations=jst, cache_geometry=True)
    if kind == "cached":
        return mine, ref
    if kind == "rerate_constant":
        return (mine.rerate(links.ConstantRate(300.0)),
                ref.rerate(jlinks.ConstantRate(300.0)))
    if kind == "rerate_budget":
        return (mine.rerate(links.LinkBudget()),
                ref.rerate(jlinks.LinkBudget()))
    assert kind == "rerate_isl_only"
    return (mine.rerate(None, links.LinkBudget(tx_power_dbw=3.0)),
            ref.rerate(None, jlinks.LinkBudget(tx_power_dbw=3.0)))


PLAN_KINDS = ("constant", "budget", "cached", "rerate_constant",
              "rerate_budget", "rerate_isl_only")


@pytest.mark.parametrize("kind", PLAN_KINDS)
def test_contact_plan_tables_bitwise(shared, kind):
    mine, ref = _plans(shared, kind)
    assert_same_plan(mine, ref)
    assert len(ref.isl) > 0
    if kind != "constant":
        assert any(e.mid_range_m is not None for e in mine.ground)


def test_rerate_without_geometry_raises(shared):
    mine, _ = _plans(shared, "constant")
    with pytest.raises(ValueError, match="cache_geometry=True"):
        mine.rerate(links.LinkBudget())
    assert_same_plan(mine.rerate(links.ConstantRate()), mine)


def _astuple(x):
    """A ContactWindow / Route as a plain tuple (None stays None)."""
    return None if x is None else dataclasses.astuple(x)


TIMES = (0.0, 1234.5, 20_000.0, 43_210.0, 80_000.0, 90_000.0)


@pytest.mark.parametrize("kind", ("constant", "budget"))
def test_plan_queries_and_outlook_bitwise(shared, kind):
    mine, ref = _plans(shared, kind)
    mo = contact_plan.ContactOutlook.from_plan(mine)
    ro = jplan_mod.ContactOutlook.from_plan(ref)
    assert mo.n_sats == ro.n_sats and mo.horizon_s == ro.horizon_s
    for t in TIMES:
        assert mo.next_contact_s(t) == ro.next_contact_s(t)
        assert mo.next_contact_s(t, [3, 17]) == ro.next_contact_s(t, [3, 17])
        for k in range(0, mine.n_sats, 3):
            assert mo.next_ground_pass(k, t) == ro.next_ground_pass(k, t)
            assert mo.ground_gap_s(k, t) == ro.ground_gap_s(k, t)
            assert _astuple(mine.next_window(("gs", k), t)) == \
                _astuple(ref.next_window(("gs", k), t))
            assert mine.next_ground_upload(k, t, 186_000.0) == \
                ref.next_ground_upload(k, t, 186_000.0)
        for i, j in list(ref.isl)[::4]:
            assert mo.next_isl_window(j, i, t) == ro.next_isl_window(j, i, t)
            for n in (186_000.0, 5e9):
                assert mine.next_isl_transfer(i, j, t, n) == \
                    ref.next_isl_transfer(i, j, t, n)
    assert mo.next_isl_window(0, 39, 0.0) == ro.next_isl_window(0, 39, 0.0)
    paw = shared[2]
    ma = contact_plan.ContactOutlook.from_access(paw, rate_bps=580e6)
    ra = jplan_mod.ContactOutlook.from_access(shared[0], rate_bps=580e6)
    assert same_table(ma.ground, ra.ground) and ma.isl is None
    for t in TIMES:
        assert ma.next_contact_s(t) == ra.next_contact_s(t)
        assert ma.next_isl_window(0, 1, t) is None




@pytest.mark.parametrize("kind", ("constant", "budget", "rerate_budget"))
def test_routes_bitwise(shared, kind):
    mine, ref = _plans(shared, kind)
    n = mine.n_sats
    relayed = 0
    for t in (0.0, 5000.0, 40_000.0):
        for hops in (0, 1, 3):
            m = routing.batch_earliest_arrival(mine, range(n), t, 186_000.0,
                                               max_hops=hops)
            r = jrouting.batch_earliest_arrival(ref, range(n), t, 186_000.0,
                                                max_hops=hops)
            assert [_astuple(x) for x in m] == [_astuple(x) for x in r]
            relayed += sum(1 for x in m if x is not None and x.isl_hops)
        for k in range(0, n, 7):
            assert _astuple(routing.earliest_arrival(mine, k, t, 186_000.0)) \
                == _astuple(jrouting.earliest_arrival(ref, k, t, 186_000.0))
    ready = np.linspace(0.0, 60_000.0, n)
    assert [_astuple(x) for x in routing.batch_earliest_arrival(
        mine, range(n), ready, 46_500.0)] == \
        [_astuple(x) for x in jrouting.batch_earliest_arrival(
            ref, range(n), ready, 46_500.0)]
    assert relayed > 0
