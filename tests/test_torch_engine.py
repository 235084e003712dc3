"""Port `ConstellationSim` vs the reference engine.

(a) the golden RoundRecords of `tests/data/engine_parity.json` (every
    fixture, the ISL ones included), replayed through the port with its
    own access and ISL windows;
(b) every Table-1 algorithm, the ISL and connectivity-aware algorithms
    and a lossy-codec variant trained side by side with the reference on
    one shared `AccessWindows` (and, for ISL, one shared contact plan's
    windows) and dataset, the reference's init params, and the
    reference's minibatch and codec draws (`torch_parity.JaxReplaySampler`);
(c) the comms kwargs, the codec knob and the strategy outlook give the
    reference's plans and views; the mesh execution constructs (its runs
    are `tests/test_torch_mesh.py`'s).
"""
from __future__ import annotations

import dataclasses
import json
import os

import jax
import numpy as np
import pytest

from repro.comms import ConstantRate as JaxConstantRate
from repro.comms import ISLTopology as JaxISLTopology
from repro.comms import LinkBudget as JaxLinkBudget
from repro.comms import build_contact_plan as jax_build_plan
from repro.comms import compute_isl_windows as jax_isl_windows
from repro.core import ALGORITHMS as JAX_ALGORITHMS
from repro.core import FedProxSat as JaxFedProxSat
from repro.core import Strategy as JaxStrategy
from repro.core import spaceify as jax_spaceify
from repro.data import synth_femnist
from repro.orbits import WalkerStar as JaxWalkerStar
from repro.orbits import compute_access_windows as jax_windows
from repro.orbits import station_subnetwork as jax_stations
from repro.sim import ConstellationSim as JaxSim
from repro.sim import SimConfig as JaxConfig
from repro_torch.comms import ConstantRate, ISLTopology, LinkBudget, \
    build_contact_plan
from repro_torch.comms.isl import ISLWindows
from repro_torch.core import (
    ALGORITHMS,
    TABLE1_NAMES,
    FedAvgSat,
    FedBuffSat,
    FedProxSat,
    Strategy,
    spaceify,
)
from repro_torch.orbits import WalkerStar, compute_access_windows, \
    station_subnetwork
from repro_torch.orbits.access import AccessWindows
from repro_torch.sim import ConstellationSim, SimConfig
from torch_parity import JaxReplaySampler, assert_same_plan, \
    jax_init_params

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "engine_parity.json")
# The golden scenarios of tests/test_engine_parity.py.
SCENARIOS = {
    "c2s3_g2": dict(clusters=2, sats=3, g=2, days=6.0, rounds=8, c=4),
    "c3s2_g1": dict(clusters=3, sats=2, g=1, days=4.0, rounds=6, c=10),
}
RECORD_FIELDS = ("idx", "t_start", "t_end", "participants", "epochs",
                 "idle_s", "compute_s", "comm_s", "relays", "staleness",
                 "relay_hops", "comms_bytes")


def _algorithm(name: str):
    if name == "fedbuff_d034":
        return spaceify(FedBuffSat(), buffer_frac=0.34, name="fedbuff_d034")
    return ALGORITHMS[name]


def _fixture_keys() -> list[str]:
    with open(GOLDEN) as f:
        return list(json.load(f))


def _records(res) -> list[dict]:
    return [{f: getattr(r, f) for f in RECORD_FIELDS} for r in res.rounds]


@pytest.fixture(scope="module")
def golden() -> dict:
    with open(GOLDEN) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def port_windows() -> dict:
    out = {}
    for sname, scn in SCENARIOS.items():
        out[sname] = compute_access_windows(
            WalkerStar(scn["clusters"], scn["sats"]),
            station_subnetwork(scn["g"]), horizon_s=scn["days"] * 86400.0,
            device="cpu")
    return out


def test_fixture_set_is_the_non_isl_suite():
    """Every fixture replays now: the Table-1 suite, the partial-buffer
    FedBuff and the two ISL algorithms, on both scenarios."""
    keys = _fixture_keys()
    assert len(keys) == 22
    assert {k.split("/", 1)[1] for k in keys} == set(TABLE1_NAMES) | {
        "fedbuff_d034", "fedavg_intracc_isl", "fedprox_intracc_isl"}


@pytest.mark.parametrize("key", _fixture_keys())
def test_golden_round_records_replay_bitwise(key, golden, port_windows):
    sname, name = key.split("/", 1)
    scn = SCENARIOS[sname]
    cfg = SimConfig(max_rounds=scn["rounds"],
                    horizon_s=scn["days"] * 86400.0,
                    clients_per_round=scn["c"], eval_every=3, train=False)
    res = ConstellationSim(WalkerStar(scn["clusters"], scn["sats"]),
                           station_subnetwork(scn["g"]), _algorithm(name),
                           cfg=cfg, access=port_windows[sname],
                           device="cpu").run()
    want = golden[key]
    assert want and _records(res) == want


# --------------------------------------------------------------------- #
# (b) trained runs against the reference engine
# --------------------------------------------------------------------- #
HORIZON = 4 * 86400.0


@pytest.fixture(scope="module")
def shared():
    cst = JaxWalkerStar(2, 2)
    st = jax_stations(1)
    aw = jax_windows(cst, st, horizon_s=HORIZON)
    return aw, synth_femnist(cst.n_sats, seed=0)


def _cfg_kwargs() -> dict:
    return dict(max_rounds=3, horizon_s=HORIZON, eval_every=1, max_steps=16,
                record_params=True)


def _assert_params_close(a: dict, b, tol: float = 1e-5):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(jax.device_get(b))
    assert len(la) == len(lb) == 4
    for x, y in zip(la, lb):
        assert x.shape == np.shape(y)
        np.testing.assert_allclose(x, np.asarray(y), rtol=tol, atol=tol)


def _assert_trained_run_matches(res, ref, rounds: int = 3):
    assert len(ref.rounds) == rounds
    assert _records(res) == _records(ref)
    assert [r.accuracy is None for r in res.rounds] == \
        [r.accuracy is None for r in ref.rounds]
    assert len(res.accuracy_curve) == len(ref.accuracy_curve) == rounds
    for (i, t, a), (ri, rt, ra) in zip(res.accuracy_curve,
                                       ref.accuracy_curve):
        assert (i, t) == (ri, rt)
        assert abs(a - ra) <= 1e-5
    _assert_params_close(res.final_params, ref.final_params)
    assert len(res.params_history) == len(ref.params_history) == rounds
    for a, b in zip(res.params_history, ref.params_history):
        _assert_params_close(a, b)


def _port_run(cst, st, alg, data, aw, **kw):
    return ConstellationSim(cst, st, alg, data=data,
                            cfg=SimConfig(**kw.pop("cfg", _cfg_kwargs())),
                            access=aw, device="cpu",
                            sampler=JaxReplaySampler(0),
                            init_params=jax_init_params(0), **kw).run()


def _shared_run_pair(name, shared):
    aw, data = shared
    ref = JaxSim(JaxWalkerStar(2, 2), jax_stations(1), JAX_ALGORITHMS[name],
                 data=data, cfg=JaxConfig(**_cfg_kwargs()), access=aw).run()
    res = _port_run(WalkerStar(2, 2), station_subnetwork(1),
                    ALGORITHMS[name], data, aw)
    return res, ref


@pytest.mark.parametrize("name", TABLE1_NAMES)
def test_table1_training_matches_reference(name, shared):
    _assert_trained_run_matches(*_shared_run_pair(name, shared))


@pytest.mark.parametrize("name", ["fedspace", "ground_assisted",
                                  "fedprox_sparse"])
def test_connectivity_aware_training_matches_reference(name, shared):
    """fedspace reads the outlook in `should_flush`, ground_assisted in
    `next_sync_point`; fedprox_sparse halves the round size."""
    _assert_trained_run_matches(*_shared_run_pair(name, shared))


def _as_port_windows(aw, iw):
    """The reference's windows as the port's types (same arrays)."""
    return (AccessWindows(aw.per_sat, aw.per_sat_station, aw.cluster,
                          aw.horizon_s, aw.dt_s),
            ISLWindows(iw.edges, iw.per_edge, iw.horizon_s, iw.dt_s))


@pytest.fixture(scope="module")
def ring10():
    """c1s10/g1 over 2 days: a dense plane whose intra-plane ISL ring
    relays returns. The reference's access and ISL windows, shared."""
    cst = JaxWalkerStar(1, 10)
    aw = jax_windows(cst, jax_stations(1), horizon_s=2 * 86400.0)
    iw = jax_isl_windows(cst, horizon_s=2 * 86400.0)
    return aw, iw, synth_femnist(cst.n_sats, seed=0)


def _ring_cfg() -> dict:
    return dict(_cfg_kwargs(), horizon_s=2 * 86400.0, clients_per_round=4)


@pytest.mark.parametrize("name", ["fedavg_intracc_isl",
                                  "fedprox_intracc_isl"])
def test_isl_training_matches_reference(name, ring10):
    """Relayed returns routed over one shared contact plan's windows."""
    aw, iw, data = ring10
    paw, piw = _as_port_windows(aw, iw)
    ref = JaxSim(JaxWalkerStar(1, 10), jax_stations(1), JAX_ALGORITHMS[name],
                 data=data, cfg=JaxConfig(**_ring_cfg()), access=aw,
                 contact_plan=jax_build_plan(aw, iw)).run()
    res = _port_run(WalkerStar(1, 10), station_subnetwork(1),
                    ALGORITHMS[name], data, paw, cfg=_ring_cfg(),
                    contact_plan=build_contact_plan(paw, piw))
    _assert_trained_run_matches(res, ref)
    assert sum(h for r in res.rounds for h in r.relay_hops) > 0


def test_quant_int8_training_within_codec_bounds(shared):
    """fedprox with the int8 uplink codec, the reference's uniforms.

    Training is 1e-5 from the reference, not bitwise (f32 matmuls round
    differently), so each delta entering the codec differs from the
    reference's by about an ulp of the params (~4e-9 at |w| ~ 0.05). An
    element rounds to the other quantization level exactly when its
    uniform falls between the two fractional parts: probability
    |gap| / step, with step = amax/127 of its leaf (~4e-5 here), so ~1e-4
    a rounding, ~56 of the 3 rounds x 4 clients x 46,639 roundings. A
    flip moves its element one step (4e-5) and the global model by its
    client's weight (~1/4) of that, and flips do not compound (each round
    re-anchors every client on the global model). Bounds:
      * RoundRecords bitwise (timing does not read params);
      * at most 100 of 46,639 final params more than 1e-5 apart (about
        twice the expected flips);
      * relative L2 gap of the final params <= 1e-4: 100 full steps of
        4e-5 are 4e-4 against a params norm of ~15;
      * accuracy within 2 eval samples of the 256 (4 clients x 64).
    """
    aw, data = shared
    ref = JaxSim(JaxWalkerStar(2, 2), jax_stations(1),
                 jax_spaceify(JaxFedProxSat(), codec="quant_int8"),
                 data=data, cfg=JaxConfig(**_cfg_kwargs()), access=aw).run()
    res = _port_run(WalkerStar(2, 2), station_subnetwork(1),
                    spaceify(FedProxSat(), codec="quant_int8"), data, aw)
    assert res.algorithm == ref.algorithm == "fedprox_quant_int8"
    assert _records(res) == _records(ref)
    assert [r.wire_bytes_saved for r in res.rounds] == \
        [r.wire_bytes_saved for r in ref.rounds]
    assert res.rounds[0].wire_bytes_saved > 0
    mine = np.concatenate([x.reshape(-1) for x in
                           jax.tree.leaves(res.final_params)])
    want = np.concatenate([np.asarray(x).reshape(-1) for x in
                           jax.tree.leaves(ref.final_params)])
    gap = np.abs(mine - want)
    far = int((gap > 1e-5).sum())
    rel = float(np.linalg.norm(mine - want) / np.linalg.norm(want))
    print(f"quant_int8: {far} of {gap.size} params > 1e-5 apart, "
          f"max {gap.max():.3g}, relative L2 {rel:.3g}")
    assert far <= 100
    assert rel <= 1e-4
    for (_, _, a), (_, _, ra) in zip(res.accuracy_curve, ref.accuracy_curve):
        assert abs(a - ra) <= 2 / 256


def test_identity_codec_run_is_bitwise_default(shared):
    """`codec="identity"` (and an explicit identity on the hardware
    model) leaves a Table-1 run exactly as the default: same records,
    same params bit for bit."""
    from repro_torch.comms.codec import get_codec
    from repro_torch.core.timing import HardwareModel
    aw, data = shared
    base = _port_run(WalkerStar(2, 2), station_subnetwork(1),
                     ALGORITHMS["fedprox"], data, aw)
    for alg, hw in ((spaceify(FedProxSat(), codec="identity"), None),
                    (ALGORITHMS["fedprox"],
                     HardwareModel(codec=get_codec("identity")))):
        res = _port_run(WalkerStar(2, 2), station_subnetwork(1), alg, data,
                        aw, hw=hw)
        assert _records(res) == _records(base)
        assert res.accuracy_curve == base.accuracy_curve
        for a, b in zip(jax.tree.leaves(res.final_params),
                        jax.tree.leaves(base.final_params)):
            assert np.array_equal(a, b)


# --------------------------------------------------------------------- #
# (c) the comms kwargs, the codec knob and the outlook; what still raises
# --------------------------------------------------------------------- #
def _small_sim(**kw):
    return ConstellationSim(WalkerStar(1, 2), station_subnetwork(1),
                            kw.pop("algorithm", ALGORITHMS["fedavg"]),
                            cfg=SimConfig(max_rounds=1, horizon_s=86400.0,
                                          train=False),
                            device="cpu", **kw)


PLANE2 = dict(horizon_s=2 * 86400.0, max_rounds=4, clients_per_round=6,
              eval_every=3, train=False)


@pytest.fixture(scope="module")
def plane2():
    """c2s10/g1 over 2 days: the reference's access windows, shared."""
    return jax_windows(JaxWalkerStar(2, 10), jax_stations(1),
                       horizon_s=PLANE2["horizon_s"])


def _comms_kwargs(kwarg: str, aw):
    """(algorithm name, port kwargs, reference kwargs) requesting `kwarg`;
    plans from shared windows, links and topologies built per package."""
    if kwarg == "contact_plan":
        iw = jax_isl_windows(JaxWalkerStar(2, 10),
                             horizon_s=PLANE2["horizon_s"])
        paw, piw = _as_port_windows(aw, iw)
        return ("fedprox_intracc_isl",
                dict(contact_plan=build_contact_plan(paw, piw)),
                dict(contact_plan=jax_build_plan(aw, iw)))
    if kwarg == "link_model":
        return ("fedavg", dict(link_model=LinkBudget()),
                dict(link_model=JaxLinkBudget()))
    if kwarg == "isl_link":
        return ("fedavg_intracc_isl",
                dict(isl_link=LinkBudget(), link_model=ConstantRate(400.0)),
                dict(isl_link=JaxLinkBudget(),
                     link_model=JaxConstantRate(400.0)))
    assert kwarg == "isl_topology"
    return ("fedprox_intracc_isl",
            dict(isl_topology=ISLTopology.walker_grid(
                WalkerStar(2, 10), cross_plane=True, seam_k=2)),
            dict(isl_topology=JaxISLTopology.walker_grid(
                JaxWalkerStar(2, 10), cross_plane=True, seam_k=2)))


@pytest.mark.parametrize("kwarg", ["contact_plan", "link_model", "isl_link",
                                   "isl_topology"])
def test_comms_requests_raise(kwarg, plane2):
    """Each comms kwarg (which raised NotImplementedError before the
    comms layer was ported) is accepted and gives the reference's plan
    bitwise, and the run the reference's RoundRecords."""
    name, mine_kw, ref_kw = _comms_kwargs(kwarg, plane2)
    paw = AccessWindows(plane2.per_sat, plane2.per_sat_station,
                        plane2.cluster, plane2.horizon_s, plane2.dt_s)
    mine = ConstellationSim(WalkerStar(2, 10), station_subnetwork(1),
                            ALGORITHMS[name], cfg=SimConfig(**PLANE2),
                            access=paw, device="cpu", **mine_kw)
    ref = JaxSim(JaxWalkerStar(2, 10), jax_stations(1), JAX_ALGORITHMS[name],
                 cfg=JaxConfig(**PLANE2), access=plane2, **ref_kw)
    assert mine.plan is not None and ref.plan is not None
    assert_same_plan(mine.plan, ref.plan)
    if kwarg == "contact_plan":
        # A cached plan without link kwargs is used as given.
        assert mine.plan is mine_kw["contact_plan"]
        rerated = ConstellationSim(
            WalkerStar(2, 10), station_subnetwork(1), ALGORITHMS[name],
            cfg=SimConfig(**PLANE2), access=paw, device="cpu",
            contact_plan=mine_kw["contact_plan"],
            isl_link=ConstantRate(50.0))
        assert_same_plan(rerated.plan, ref_kw["contact_plan"].rerate(
            None, JaxConstantRate(50.0)))
    if kwarg == "isl_topology":
        assert len(mine.plan.isl) > 20       # cross-plane edges see contact
    res, want = mine.run(), ref.run()
    assert len(want.rounds) >= 2
    assert _records(res) == _records(want)


def _fields(strategy) -> dict:
    """A strategy's fields, enums by value (each package has its own)."""
    return {k: getattr(v, "value", v)
            for k, v in dataclasses.asdict(strategy).items()}


def test_isl_codec_mesh_and_workload_requests_raise():
    """`isl=True`, every registry codec and every reference algorithm
    (which raised NotImplementedError before the comms layer was ported)
    now construct as the reference's, and so does the mesh execution."""
    from repro.comms import codec_names as jax_codec_names
    from repro.core import FedAvgSat as JaxFedAvgSat
    assert sorted(ALGORITHMS) == sorted(JAX_ALGORITHMS)
    for name in ALGORITHMS:
        mine, ref = ALGORITHMS[name], JAX_ALGORITHMS[name]
        assert (mine.name, mine.isl, mine.codec, mine.local_epochs,
                mine.min_epochs, mine.buffer_frac, mine.synchronous) == \
            (ref.name, ref.isl, ref.codec, ref.local_epochs,
             ref.min_epochs, ref.buffer_frac, ref.synchronous)
        assert dataclasses.asdict(mine.selector) == \
            dataclasses.asdict(ref.selector)
        assert type(mine.strategy).__name__ == type(ref.strategy).__name__
        assert _fields(mine.strategy) == _fields(ref.strategy)
    isl_alg = spaceify(FedAvgSat(), intracc=True, isl=True, max_hops=2)
    assert isl_alg.isl and isl_alg.name == jax_spaceify(
        JaxFedAvgSat(), intracc=True, isl=True).name == "fedavg_intracc_isl"
    assert isl_alg.selector.max_hops == 2
    for codec in jax_codec_names():
        alg = spaceify(FedAvgSat(), codec=codec)
        assert alg.name == jax_spaceify(JaxFedAvgSat(), codec=codec).name
        assert alg.codec == codec
        sim = _small_sim(algorithm=alg)
        assert sim.codec.name == codec
        assert (sim.hw.codec is None) == (codec == "identity")
    with pytest.raises(KeyError, match="registered codecs"):
        spaceify(FedAvgSat(), codec="no_such_codec")
    with pytest.raises(KeyError, match="registered algorithms"):
        ALGORITHMS["no_such_algorithm"]
    assert _small_sim(execution="mesh").execution == "mesh"
    # The paper's CNN resolves, priced by its derived cost model exactly
    # as the reference prices it.
    from repro.core.timing import HardwareModel as JaxHardwareModel
    cnn = _small_sim(workload="femnist_cnn")
    assert cnn.workload.name == "femnist_cnn"
    assert dataclasses.asdict(cnn.hw) == dataclasses.asdict(
        JaxHardwareModel.for_workload("femnist_cnn"))


def _read_outlook(log: list, outlook, now: float) -> bool:
    """What an outlook-reading hook sees, logged: the next ground contact
    of anyone and of satellites 0 and 3, and the next ISL window 0-1."""
    nxt = outlook.next_contact_s(now)
    log.append((nxt, outlook.next_contact_s(now, [0, 3]),
                outlook.ground_gap_s(0, now), outlook.next_ground_pass(3, now),
                outlook.next_isl_window(1, 0, now), outlook.n_sats,
                outlook.horizon_s))
    return nxt is not None and nxt - now > 3600.0


@dataclasses.dataclass(frozen=True)
class _OutlookReader(Strategy):
    name: str = "outlook_reader"
    log: list = dataclasses.field(default_factory=list, compare=False)

    def should_flush(self, state, outlook) -> bool:
        return (len(state.updates) >= state.target_size
                or _read_outlook(self.log, outlook, state.now))


@dataclasses.dataclass(frozen=True)
class _JaxOutlookReader(JaxStrategy):
    name: str = "outlook_reader"
    log: list = dataclasses.field(default_factory=list, compare=False)

    def should_flush(self, state, outlook) -> bool:
        return (len(state.updates) >= state.target_size
                or _read_outlook(self.log, outlook, state.now))


def test_strategy_outlook_raises_only_when_read(plane2, monkeypatch):
    """The outlook (which raised NotImplementedError when read before the
    comms layer was ported) is built only when a hook reads it, once a
    run, and answers every query as the reference's: from the access
    windows, and from the contact plan for an ISL algorithm."""
    built = []
    build = ConstellationSim._build_outlook

    def counting(sim):
        built.append(sim)
        return build(sim)

    monkeypatch.setattr(ConstellationSim, "_build_outlook", counting)
    _small_sim().run()                   # stock hooks never build it
    assert built == []
    paw = AccessWindows(plane2.per_sat, plane2.per_sat_station,
                        plane2.cluster, plane2.horizon_s, plane2.dt_s)
    for isl in (False, True):
        mine_s, ref_s = _OutlookReader(), _JaxOutlookReader()
        mine = ConstellationSim(WalkerStar(2, 10), station_subnetwork(1),
                                spaceify(mine_s, intracc=isl, isl=isl),
                                cfg=SimConfig(**PLANE2), access=paw,
                                device="cpu").run()
        ref = JaxSim(JaxWalkerStar(2, 10), jax_stations(1),
                     jax_spaceify(ref_s, intracc=isl, isl=isl),
                     cfg=JaxConfig(**PLANE2), access=plane2).run()
        assert len(built) == 1 + isl
        assert mine_s.log and mine_s.log == ref_s.log
        assert any(entry[4] is not None for entry in mine_s.log) == isl
        assert _records(mine) == _records(ref)
