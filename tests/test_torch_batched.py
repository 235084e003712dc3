"""Port `BatchedSweep` (`repro_torch.sim.batched`) vs the port's loop path
and the reference's `repro.sim.batched`, mirroring
`tests/test_batched_sweep.py`: timing records bitwise, training within
1e-5 on femnist_mlp, the scenario-stacked `WindowTable`, and every
refusal. Both packages share one `AccessWindows` and dataset; the port's
scenarios draw through `torch_parity.JaxReplaySampler`, so they train on
the reference's minibatches.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.comms.contact_plan import WindowTable as JaxWindowTable
from repro.comms.contact_plan import _EdgeWindows as JaxEdgeWindows
from repro.core import ALGORITHMS as JAX_ALGORITHMS
from repro.core import FedProxSat as JaxFedProxSat
from repro.core import spaceify as jax_spaceify
from repro.data import synth_femnist
from repro.orbits import WalkerStar as JaxWalkerStar
from repro.orbits import compute_access_windows as jax_windows
from repro.orbits import station_subnetwork as jax_stations
from repro.sim import ConstellationSim as JaxSim
from repro.sim import SimConfig as JaxConfig
from repro.sim.batched import BatchedSweep as JaxBatchedSweep
from repro_torch.comms.contact_plan import WindowTable, _EdgeWindows
from repro_torch.core import ALGORITHMS, FedProxSat, Strategy, spaceify
from repro_torch.orbits import WalkerStar, station_subnetwork
from repro_torch.orbits.access import AccessWindows
from repro_torch.sim import BatchedSweep, ConstellationSim, SimConfig, \
    run_batched
from torch_parity import JaxReplaySampler, jax_init_params

HORIZON = 4 * 86400.0
TIMING_FIELDS = ("t_start", "t_end", "participants", "epochs", "idle_s",
                 "compute_s", "comm_s", "relays", "staleness",
                 "relay_hops", "comms_bytes")
_AW: dict = {}
_DATA: dict = {}


def _aw(cl, sp, g):
    """The reference's windows, shared by both packages."""
    key = (cl, sp, g)
    if key not in _AW:
        _AW[key] = jax_windows(JaxWalkerStar(cl, sp), jax_stations(g),
                               horizon_s=HORIZON)
    return _AW[key]


def _data(k):
    if k not in _DATA:
        _DATA[k] = synth_femnist(k, seed=0)
    return _DATA[k]


def _alg(name, jax_side=False):
    if name == "fedprox_quant_int8":
        return (jax_spaceify(JaxFedProxSat(), codec="quant_int8") if jax_side
                else spaceify(FedProxSat(), codec="quant_int8"))
    return (JAX_ALGORITHMS if jax_side else ALGORITHMS)[name]


def _jax_sim(alg, cl, sp, g, workload="femnist_mlp", **cfg_kw):
    train = cfg_kw.get("train", True)
    return JaxSim(JaxWalkerStar(cl, sp), jax_stations(g),
                  _alg(alg, jax_side=True),
                  data=_data(cl * sp) if train else None,
                  cfg=JaxConfig(horizon_s=HORIZON, **cfg_kw),
                  access=_aw(cl, sp, g), workload=workload)


def _sim(alg, cl, sp, g, workload="femnist_mlp", init_params=None,
         **cfg_kw):
    aw = _aw(cl, sp, g)
    train = cfg_kw.get("train", True)
    return ConstellationSim(
        WalkerStar(cl, sp), station_subnetwork(g), _alg(alg),
        data=_data(cl * sp) if train else None,
        cfg=SimConfig(horizon_s=HORIZON, **cfg_kw),
        access=AccessWindows(aw.per_sat, aw.per_sat_station, aw.cluster,
                             aw.horizon_s, aw.dt_s),
        workload=workload, device="cpu", sampler=JaxReplaySampler(0),
        init_params=init_params)


def _assert_records_equal(alg, a, b):
    assert len(a.rounds) == len(b.rounds), alg
    assert len(a.rounds) > 0, f"{alg}: no rounds planned"
    for ra, rb in zip(a.rounds, b.rounds):
        for field in TIMING_FIELDS:
            assert getattr(ra, field) == getattr(rb, field), \
                (alg, ra.idx, field)


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(v).reshape(-1)
                           for v in jax.tree.leaves(tree)])


def _assert_trained_close(alg, a, b, tol=1e-5):
    ca = {i: acc for i, _, acc in a.accuracy_curve}
    cb = {i: acc for i, _, acc in b.accuracy_curve}
    assert set(ca) == set(cb), (alg, sorted(ca), sorted(cb))
    for i in ca:
        assert abs(ca[i] - cb[i]) <= tol, (alg, i, ca[i], cb[i])
    np.testing.assert_allclose(_flat(a.final_params), _flat(b.final_params),
                               rtol=0, atol=tol, err_msg=alg)


# ------------------------------------------------------- timing parity --
TIMING_CELLS = [("fedavg", 2, 2, 1), ("fedavg_sched", 2, 2, 2),
                ("fedprox_sched_v2", 1, 5, 1), ("fedavg_intracc", 1, 5, 2),
                ("fedbuff", 2, 2, 1), ("fedprox", 1, 1, 1)]


@pytest.mark.parametrize("lockstep", [True, False])
def test_timing_is_bitwise_the_loop_and_the_reference(lockstep):
    """Lockstep-planned (fedavg/sched/prox), relay-fallback (intracc),
    async-fallback (fedbuff) and non-federating (one satellite)
    scenarios in one batch; `batched_planning=False` sends every scenario
    through its scalar twin."""
    kw = dict(max_rounds=5, train=False, eval_every=2)
    loop = [_sim(*c, **kw).run() for c in TIMING_CELLS]
    mine = BatchedSweep([_sim(*c, **kw) for c in TIMING_CELLS],
                        names=[c[0] for c in TIMING_CELLS],
                        batched_planning=lockstep).run()
    ref = JaxBatchedSweep([_jax_sim(*c, **kw) for c in TIMING_CELLS],
                          batched_planning=lockstep).run()
    for (alg, cl, sp, _), lr, mr, rr in zip(TIMING_CELLS, loop, mine, ref):
        if cl * sp < 2:
            assert mr.rounds == lr.rounds == rr.rounds == []
            continue
        _assert_records_equal(alg, lr, mr)
        _assert_records_equal(alg, rr, mr)


# -------------------------------------------------------- train parity --
@pytest.mark.parametrize("cells", [
    # Sync and async together: FedBuff's staleness gives per-client
    # anchors; mu 0 (fedavg) and 0.1 beside each other.
    [("fedavg", 2, 2, 1), ("fedprox", 2, 2, 1), ("fedbuff", 2, 2, 1)],
    # Synchronous only, mixing mu 0 and mu 0.1 across constellations:
    # one anchor row per scenario (grouped anchors), per-row mu.
    [("fedavg", 2, 2, 1), ("fedprox_sched", 1, 5, 1),
     ("fedavg_sched", 2, 3, 2), ("fedprox", 1, 4, 1)],
], ids=["sync_and_async", "mixed_mu_sync"])
def test_training_batch_matches_loop_and_reference(cells):
    kw = dict(max_rounds=3, eval_every=2, max_steps=16)
    loop = [_sim(*c, **kw).run() for c in cells]
    mine = BatchedSweep([_sim(*c, **kw) for c in cells]).run()
    ref = JaxBatchedSweep([_jax_sim(*c, **kw) for c in cells]).run()
    for (alg, *_), lr, mr, rr in zip(cells, loop, mine, ref):
        assert mr.execution == "batched"
        _assert_records_equal(alg, lr, mr)
        _assert_records_equal(alg, rr, mr)
        _assert_trained_close(alg, lr, mr)
        _assert_trained_close(alg, rr, mr)


def test_cnn_training_batch_matches_loop_and_reference():
    """femnist_cnn: the batched path against the port's loop within 1e-5
    (each scenario's clients and weights as its own run gives them); the
    reference's batched path is held as in tests/test_torch_femnist_cnn.py
    (its max-pools make training diverge at the rounding level): records
    bitwise, final params no farther than 3x what a one-ulp change of the
    init does to the port's own batch."""
    cells = [("fedavg", 2, 2, 1), ("fedprox", 2, 2, 1), ("fedbuff", 2, 2, 1)]
    kw = dict(max_rounds=3, eval_every=2, max_steps=16)
    wl = "femnist_cnn"
    init = jax_init_params(0, wl)
    nudged = jax.tree.map(
        lambda v: np.nextafter(np.asarray(v), np.float32(np.inf)), init)
    loop = [_sim(*c, workload=wl, **kw).run() for c in cells]
    mine = BatchedSweep([_sim(*c, workload=wl, **kw) for c in cells]).run()
    ulp = BatchedSweep([_sim(*c, workload=wl, init_params=nudged, **kw)
                        for c in cells]).run()
    ref = JaxBatchedSweep([_jax_sim(*c, workload=wl, **kw)
                           for c in cells]).run()
    for (alg, *_), lr, mr, ur, rr in zip(cells, loop, mine, ulp, ref):
        _assert_records_equal(alg, lr, mr)
        _assert_records_equal(alg, rr, mr)
        _assert_trained_close(alg, lr, mr)
        gap = np.linalg.norm(_flat(rr.final_params) - _flat(mr.final_params))
        envelope = np.linalg.norm(_flat(ur.final_params)
                                  - _flat(mr.final_params))
        assert gap <= 3 * envelope + 1e-5, (alg, gap, envelope)


def test_quant_int8_batch_within_codec_bounds():
    """A lossy int8 batch: within 1e-5 of the port's loop path (the same
    clients, draws and uniforms), and against the reference's loop path
    within the bounds of
    tests/test_torch_engine.py::test_quant_int8_training_within_codec_bounds
    (training 1e-5 apart flips a stochastic rounding now and then): records
    bitwise, <= 100 params more than 1e-5 apart, relative L2 <= 1e-4,
    accuracy within 2 eval samples of 256. The reference's own batched
    int8 path is no oracle here: on c2s3/g1 it lands outside these bounds
    from the reference's own loop path."""
    cells = [("fedprox_quant_int8", 2, 2, 1), ("fedprox_quant_int8", 2, 3, 1)]
    kw = dict(max_rounds=3, eval_every=1, max_steps=16)
    loop = [_sim(*c, **kw).run() for c in cells]
    mine = BatchedSweep([_sim(*c, **kw) for c in cells]).run()
    ref = [_jax_sim(*c, **kw).run() for c in cells]
    for (alg, *_), lr, mr, rr in zip(cells, loop, mine, ref):
        _assert_records_equal(alg, lr, mr)
        _assert_records_equal(alg, rr, mr)
        _assert_trained_close(alg, lr, mr)
        assert mr.rounds[0].wire_bytes_saved > 0
        a, b = _flat(mr.final_params), _flat(rr.final_params)
        gap = np.abs(a - b)
        assert int((gap > 1e-5).sum()) <= 100
        assert np.linalg.norm(a - b) / np.linalg.norm(b) <= 1e-4
        for (_, _, x), (_, _, y) in zip(mr.accuracy_curve,
                                        rr.accuracy_curve):
            assert abs(x - y) <= 2 / 256


def test_curve_covers_final_round():
    """The batched executor replays the engine's exit-path eval: every
    scenario's curve ends at its final recorded round."""
    cells = [("fedavg", 2, 2, 1), ("fedbuff", 2, 2, 1)]
    kw = dict(max_rounds=3, eval_every=100)
    for res in run_batched([_sim(*c, **kw) for c in cells]):
        assert res.rounds
        assert res.accuracy_curve[-1][0] == res.rounds[-1].idx


# --------------------------------------------------- WindowTable.stack --
def _tables(rate=1e6):
    def make(module, per_edge):
        return module[0].from_edges([
            module[1](np.asarray(s, float), np.asarray(e, float),
                      np.full(len(s), rate)) for s, e in per_edge])
    t1 = [([0.0, 100.0], [10.0, 150.0]), ([5.0], [50.0])]
    t2 = [([20.0, 200.0, 300.0], [30.0, 250.0, 350.0])]
    return ([make((WindowTable, _EdgeWindows), t) for t in (t1, t2)],
            [make((JaxWindowTable, JaxEdgeWindows), t) for t in (t1, t2)])


def test_stack_first_live_matches_per_table_and_reference():
    mine, ref = _tables()
    stacked, offs = WindowTable.stack(mine)
    rstacked, roffs = JaxWindowTable.stack(ref)
    assert offs.tolist() == roffs.tolist() == [0, 2, 3]
    for f in ("starts", "ends", "rates", "counts", "cummax_ends"):
        assert np.array_equal(getattr(stacked, f), getattr(rstacked, f)), f
    ts = np.array([0.0, 12.0, 60.0, 240.0, 1000.0])
    for off, t in zip(offs, mine):
        for row in range(t.n_edges):
            got = stacked.first_live(
                np.full(len(ts), off + row, np.int64), ts)
            want = t.first_live(np.full(len(ts), row, np.int64), ts)
            np.testing.assert_array_equal(got, want, err_msg=f"row {row}")


def test_stack_rejects_mixed_profile_widths():
    def prof_table(width):
        e = _EdgeWindows(np.array([0.0]), np.array([100.0]),
                         np.array([1e6]),
                         rate_profile=np.full((1, width), 1e6))
        return WindowTable.from_edges([e])
    with pytest.raises(ValueError, match="profile widths"):
        WindowTable.stack([prof_table(3), prof_table(4)])


def test_stack_empty_and_single():
    (t, _), _ = _tables()
    stacked, offs = WindowTable.stack([t])
    assert offs.tolist() == [0, 2]
    np.testing.assert_array_equal(stacked.starts, t.starts)
    empty, offs = WindowTable.stack([])
    assert offs.tolist() == [0] and empty.starts.shape == (0, 0)


# ------------------------------------------------------------ refusals --
@dataclasses.dataclass(frozen=True)
class _CustomAggregate(Strategy):
    name: str = "custom_aggregate"

    def aggregate(self, global_params, client_params, weights, staleness):
        return global_params


def _timing(alg="fedavg", **kw):
    return _sim(alg, 2, 2, 1, max_rounds=2, train=False, **kw)


def test_refusals():
    with pytest.raises(ValueError, match="at least one scenario"):
        BatchedSweep([])
    with pytest.raises(ValueError, match="names/sims length mismatch"):
        BatchedSweep([_timing()], names=["a", "b"])
    with pytest.raises(ValueError, match="sweep one workload per batch"):
        BatchedSweep([_timing(), _sim("fedavg", 2, 2, 1, max_rounds=2,
                                      train=False, workload="femnist_cnn")])
    with pytest.raises(ValueError, match="train/lr/batch_size/max_steps"):
        BatchedSweep([_timing(), _sim("fedprox", 2, 2, 1, max_rounds=2,
                                      train=False, lr=0.5)])
    with pytest.raises(ValueError, match="record_params is unsupported"):
        BatchedSweep([_sim("fedavg", 2, 2, 1, max_rounds=2,
                           record_params=True)])
    mesh = _timing()
    mesh.execution = "mesh"
    with pytest.raises(ValueError, match="requests mesh execution"):
        BatchedSweep([mesh])
    custom = ConstellationSim(
        WalkerStar(2, 2), station_subnetwork(1),
        spaceify(_CustomAggregate()), data=_data(4),
        cfg=SimConfig(max_rounds=2, horizon_s=HORIZON), device="cpu",
        access=_sim("fedavg", 2, 2, 1, max_rounds=2, train=False).aw)
    with pytest.raises(ValueError, match="overrides aggregate"):
        BatchedSweep([custom])
    with pytest.raises(ValueError, match="sweep one codec per training"):
        BatchedSweep([_sim("fedprox", 2, 2, 1, max_rounds=2),
                      _sim("fedprox_quant_int8", 2, 2, 1, max_rounds=2)])
    moved = _sim("fedavg", 2, 2, 1, max_rounds=2)
    moved.device = torch.device("meta")
    with pytest.raises(ValueError, match="sweep one device per training"):
        BatchedSweep([_sim("fedavg", 2, 2, 1, max_rounds=2), moved])
    # Timing-only batches take any codec, device or aggregation.
    assert len(BatchedSweep([_timing(), _timing("fedprox_quant_int8"),
                             _timing()]).sims) == 3
