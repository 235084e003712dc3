"""Port `ConstellationSim` vs the reference engine.

(a) the golden RoundRecords of `tests/data/engine_parity.json` (every
    fixture that does not need ISL), replayed through the port with its
    own access windows;
(b) every Table-1 algorithm trained side by side with the reference on
    one shared `AccessWindows` and dataset, the reference's init params,
    and the reference's minibatch draws (`torch_parity.JaxReplaySampler`);
(c) requests outside this slice raise NotImplementedError.
"""
from __future__ import annotations

import dataclasses
import json
import os

import jax
import numpy as np
import pytest

from repro.core import ALGORITHMS as JAX_ALGORITHMS
from repro.data import synth_femnist
from repro.orbits import WalkerStar as JaxWalkerStar
from repro.orbits import compute_access_windows as jax_windows
from repro.orbits import station_subnetwork as jax_stations
from repro.sim import ConstellationSim as JaxSim
from repro.sim import SimConfig as JaxConfig
from repro_torch.core import (
    ALGORITHMS,
    TABLE1_NAMES,
    FedAvgSat,
    FedBuffSat,
    Strategy,
    spaceify,
)
from repro_torch.orbits import WalkerStar, compute_access_windows, \
    station_subnetwork
from repro_torch.sim import ConstellationSim, SimConfig
from torch_parity import JaxReplaySampler, jax_init_params

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
        keys = list(json.load(f))
    return [k for k in keys if not k.endswith("_isl")]


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
    keys = _fixture_keys()
    assert len(keys) == 18
    assert {k.split("/", 1)[1] for k in keys} == set(TABLE1_NAMES) | {
        "fedbuff_d034"}


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


@pytest.mark.parametrize("name", TABLE1_NAMES)
def test_table1_training_matches_reference(name, shared):
    aw, data = shared
    ref = JaxSim(JaxWalkerStar(2, 2), jax_stations(1), JAX_ALGORITHMS[name],
                 data=data, cfg=JaxConfig(**_cfg_kwargs()), access=aw).run()
    res = ConstellationSim(WalkerStar(2, 2), station_subnetwork(1),
                           ALGORITHMS[name], data=data,
                           cfg=SimConfig(**_cfg_kwargs()), access=aw,
                           device="cpu", sampler=JaxReplaySampler(0),
                           init_params=jax_init_params(0)).run()
    assert len(ref.rounds) == 3
    assert _records(res) == _records(ref)
    assert [r.accuracy is None for r in res.rounds] == \
        [r.accuracy is None for r in ref.rounds]
    assert len(res.accuracy_curve) == len(ref.accuracy_curve) == 3
    for (i, t, a), (ri, rt, ra) in zip(res.accuracy_curve,
                                       ref.accuracy_curve):
        assert (i, t) == (ri, rt)
        assert abs(a - ra) <= 1e-5
    _assert_params_close(res.final_params, ref.final_params)
    assert len(res.params_history) == len(ref.params_history) == 3
    for a, b in zip(res.params_history, ref.params_history):
        _assert_params_close(a, b)


# --------------------------------------------------------------------- #
# (c) outside this slice
# --------------------------------------------------------------------- #
def _small_sim(**kw):
    return ConstellationSim(WalkerStar(1, 2), station_subnetwork(1),
                            kw.pop("algorithm", ALGORITHMS["fedavg"]),
                            cfg=SimConfig(max_rounds=1, horizon_s=86400.0,
                                          train=False),
                            device="cpu", **kw)


@pytest.mark.parametrize("kwarg", ["contact_plan", "link_model", "isl_link",
                                   "isl_topology"])
def test_comms_requests_raise(kwarg):
    with pytest.raises(NotImplementedError, match="ROADMAP comms"):
        _small_sim(**{kwarg: object()})


def test_isl_codec_mesh_and_workload_requests_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP comms"):
        spaceify(FedAvgSat(), intracc=True, isl=True)
    with pytest.raises(NotImplementedError, match="ROADMAP comms"):
        spaceify(FedAvgSat(), codec="quant_int8")
    for name in ("fedavg_intracc_isl", "fedspace", "fedprox_sparse"):
        with pytest.raises(NotImplementedError, match="ROADMAP comms"):
            ALGORITHMS[name]
    with pytest.raises(KeyError, match="registered algorithms"):
        ALGORITHMS["no_such_algorithm"]
    with pytest.raises(NotImplementedError, match="multi-device"):
        _small_sim(execution="mesh")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _small_sim(workload="femnist_cnn")


@dataclasses.dataclass(frozen=True)
class _OutlookReader(Strategy):
    name: str = "outlook_reader"

    def should_flush(self, state, outlook) -> bool:
        return outlook.next_contact(state.now) is not None


def test_strategy_outlook_raises_only_when_read():
    _small_sim().run()                   # stock hooks never build it
    with pytest.raises(NotImplementedError, match="ContactOutlook"):
        _small_sim(algorithm=spaceify(_OutlookReader())).run()
