"""The port's mesh execution (`ConstellationSim(execution="mesh")`) and its
aggregation collectives vs the reference and vs the port's host path.

(a) One rank (the port's one-rank default group, gloo): fedavg, fedprox
    and fedbuff trained side by side with the reference's own mesh run on
    one shared `AccessWindows`, dataset, init and PRNG stream
    (`JaxReplaySampler`): RoundRecords bitwise, per-round params and the
    accuracy curve within 1e-5; and bitwise the port's host path.
(b) The int8 uplink codec, a workload that declares mesh execution, the
    refusals (a custom `aggregate`, a multi-stream batch schema), and the
    LM workloads lm_tiny and lm_moe_tiny, mesh against host.
(c) Four gloo ranks (after `tests/test_mesh_multidevice.py`): c2s3/g2 with
    5 clients a round, so 5 pod slots pad to 8 and a rank's block can be
    all padding: records equal the one-rank host run's, params within
    1e-5.
(d) `masked_delta_allreduce` / `participation_masked_psum` against the
    reference's `weighted_average` / `weighted_delta_update`, a round
    whose weights total 0, and the `fedagg` partial form's plain version
    against its formula.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ALGORITHMS as JAX_ALGORITHMS
from repro.core.aggregation import weighted_average as jax_average
from repro.core.aggregation import weighted_delta_update as jax_delta
from repro.data import synth_femnist
from repro.models.femnist_mlp import femnist_mlp_init as jax_init
from repro.orbits import WalkerStar as JaxWalkerStar
from repro.orbits import compute_access_windows as jax_windows
from repro.orbits import station_subnetwork as jax_stations
from repro.sim import ConstellationSim as JaxSim
from repro.sim import SimConfig as JaxConfig
from repro_torch.core import ALGORITHMS, FedAvgSat, FedProxSat, spaceify
from repro_torch.core.aggregation import (
    masked_delta_allreduce,
    participation_masked_psum,
)
from repro_torch.core.workload import get_workload
from repro_torch.kernels import ref
from repro_torch.orbits import WalkerStar, compute_access_windows, \
    station_subnetwork
from repro_torch.params import params_from_jax, params_to_numpy
from repro_torch.sharding import COLLECTIVES, client_mesh, \
    pad_client_count, reset_collectives
from repro_torch.sim import ConstellationSim, SimConfig
from torch_mesh_ranks import engine_rank, spawn
from torch_parity import JaxReplaySampler, jax_init_params

HORIZON = 6 * 86400.0           # the scenario of tests/test_workloads.py
RECORD_FIELDS = ("idx", "t_start", "t_end", "participants", "epochs",
                 "idle_s", "compute_s", "comm_s", "relays", "staleness",
                 "relay_hops", "comms_bytes", "wire_bytes_saved",
                 "execution")


def _records(res, execution: str | None = None) -> list[dict]:
    out = [{f: getattr(r, f) for f in RECORD_FIELDS} for r in res.rounds]
    if execution is not None:        # compare across execution modes
        for r in out:
            r["execution"] = execution
    return out


def _max_gap(a: dict, b: dict) -> float:
    la, lb = jax.tree.leaves(a), jax.tree.leaves(jax.device_get(b))
    assert len(la) == len(lb) > 0
    return max(float(np.max(np.abs(np.asarray(x) - np.asarray(y))))
               for x, y in zip(la, lb))


def _assert_runs_close(res, other, tol: float = 1e-5):
    assert len(res.params_history) == len(other.params_history) > 0
    for a, b in zip(res.params_history, other.params_history):
        assert _max_gap(a, b) <= tol
    assert _max_gap(res.final_params, other.final_params) <= tol
    assert len(res.accuracy_curve) == len(other.accuracy_curve) > 0
    for (i, t, a), (j, u, b) in zip(res.accuracy_curve,
                                    other.accuracy_curve):
        assert (i, t) == (j, u)
        assert abs(a - b) <= tol


@pytest.fixture(scope="module")
def scenario():
    cst = JaxWalkerStar(2, 2)
    st = jax_stations(2)
    aw = jax_windows(cst, st, horizon_s=HORIZON)
    return aw, synth_femnist(cst.n_sats, seed=0)


def _cfg(**kw) -> dict:
    return dict(dict(max_rounds=3, horizon_s=HORIZON, train=True,
                     eval_every=1, max_steps=16, record_params=True), **kw)


def _port(alg, data, aw, execution: str, **kw):
    return ConstellationSim(
        WalkerStar(2, 2), station_subnetwork(2), alg, data=data,
        cfg=SimConfig(**kw.pop("cfg", _cfg())), access=aw, device="cpu",
        sampler=JaxReplaySampler(0), init_params=jax_init_params(0),
        execution=execution, **kw).run()


# --------------------------------------------------------------------- #
# (a) one rank against the reference's mesh run and the port's host run
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["fedavg", "fedprox", "fedbuff"])
def test_one_rank_mesh_matches_reference_mesh_and_host(name, scenario):
    aw, data = scenario
    ref = JaxSim(JaxWalkerStar(2, 2), jax_stations(2), JAX_ALGORITHMS[name],
                 data=data, cfg=JaxConfig(**_cfg()), access=aw,
                 execution="mesh").run()
    reset_collectives()
    mesh = _port(ALGORITHMS[name], data, aw, "mesh")
    assert mesh.execution == ref.execution == "mesh"
    assert all(r.execution == "mesh" for r in mesh.rounds)
    assert _records(mesh) == _records(ref)
    _assert_runs_close(mesh, ref)
    # Two all-reduces a round or flush: the weights' total and the deltas.
    assert COLLECTIVES["all_reduce"] == 2 * len(mesh.rounds)
    # One rank rounds as the host path's strategy does: bit for bit.
    host = _port(ALGORITHMS[name], data, aw, "host")
    assert _records(host, "mesh") == _records(mesh)
    _assert_runs_close(mesh, host, tol=0.0)


# --------------------------------------------------------------------- #
# (b) codec, declared workload, refusals, LM workloads
# --------------------------------------------------------------------- #
def test_quant_int8_mesh_matches_host(scenario):
    """The mesh path round-trips each slot's delta through the codec on
    the host path's uniforms (drawn after the minibatches, for the real
    clients only), so at one rank the int8 run is the host run's, bit
    for bit."""
    aw, data = scenario
    alg = spaceify(FedProxSat(), codec="quant_int8")
    runs = {m: _port(alg, data, aw, m) for m in ("host", "mesh")}
    assert _records(runs["host"], "mesh") == _records(runs["mesh"])
    assert runs["mesh"].rounds[0].wire_bytes_saved > 0
    _assert_runs_close(runs["mesh"], runs["host"], tol=0.0)


def test_workload_declared_mesh_execution(scenario):
    """A workload may declare execution="mesh"; the engine honours it
    without a per-run override, and with_execution validates its input."""
    aw, data = scenario
    wl = get_workload("femnist_mlp").with_execution("mesh")
    assert (wl.execution, wl.mesh_batch_dims) == ("mesh", None)
    assert get_workload("femnist_mlp").execution == "host"
    res = ConstellationSim(WalkerStar(2, 2), station_subnetwork(2),
                           ALGORITHMS["fedavg"], data=data,
                           cfg=SimConfig(**_cfg(max_rounds=2)), access=aw,
                           workload=wl, device="cpu").run()
    assert res.execution == "mesh" and res.n_rounds >= 1
    with pytest.raises(ValueError):
        wl.with_execution("tpu-pod")
    with pytest.raises(ValueError):
        ConstellationSim(WalkerStar(2, 2), station_subnetwork(2),
                         ALGORITHMS["fedavg"], access=aw, device="cpu",
                         execution="warp")


def test_mesh_refuses_custom_aggregate_and_multi_stream(scenario):
    """A strategy overriding aggregate() outside the weighted-average /
    discounted-delta family is refused on the mesh path (and still runs on
    host); so is a batch schema of several sample streams, while a
    "labels" key is no stream of its own."""
    aw, data = scenario

    @dataclasses.dataclass(frozen=True)
    class MedianStrategy(FedAvgSat):
        name: str = "fedmedian"

        def aggregate(self, global_params, client_params, weights,
                      staleness):
            return client_params.median(0).values

    alg = spaceify(MedianStrategy())
    kw = dict(data=data, cfg=SimConfig(**_cfg(max_rounds=2)), access=aw,
              device="cpu")
    with pytest.raises(ValueError, match="aggregate"):
        ConstellationSim(WalkerStar(2, 2), station_subnetwork(2), alg,
                         execution="mesh", **kw)
    res = ConstellationSim(WalkerStar(2, 2), station_subnetwork(2), alg,
                           execution="host", **kw).run()
    assert res.n_rounds >= 1
    base = get_workload("femnist_mlp")
    two = dataclasses.replace(base, mesh_batch_dims={"x": 4, "aux": 2})
    with pytest.raises(ValueError, match="multi-stream"):
        ConstellationSim(WalkerStar(2, 2), station_subnetwork(2),
                         ALGORITHMS["fedavg"], workload=two,
                         execution="mesh", **kw)
    labelled = dataclasses.replace(base, mesh_batch_dims={"x": 4,
                                                          "labels": 1})
    res = ConstellationSim(WalkerStar(2, 2), station_subnetwork(2),
                           ALGORITHMS["fedavg"], workload=labelled,
                           execution="mesh", **kw).run()
    assert res.execution == "mesh" and res.n_rounds >= 1
    assert get_workload("lm_tiny").mesh_batch_dims == {"tokens": 2}


@pytest.mark.parametrize("name", ["lm_tiny", "lm_moe_tiny"])
def test_lm_workload_mesh_matches_host(name, scenario):
    aw, _ = scenario
    cfg = _cfg(max_rounds=2, batch_size=8, max_steps=4)
    runs = {}
    for mode in ("host", "mesh"):
        runs[mode] = ConstellationSim(
            WalkerStar(2, 2), station_subnetwork(2), ALGORITHMS["fedprox"],
            workload=name, cfg=SimConfig(**cfg), access=aw, device="cpu",
            execution=mode).run()
    host, mesh = runs["host"], runs["mesh"]
    assert mesh.n_rounds == host.n_rounds >= 2
    assert _records(host, "mesh") == _records(mesh)
    for a, b in zip(host.params_history, mesh.params_history):
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            assert float(np.max(np.abs(x - y))) <= 1e-5
    for (_, _, a), (_, _, b) in zip(host.accuracy_curve,
                                    mesh.accuracy_curve):
        assert abs(a - b) <= 1e-5


# --------------------------------------------------------------------- #
# (c) four gloo ranks, 5 clients padded to 8 slots
# --------------------------------------------------------------------- #
def test_four_ranks_with_padding_match_host(tmp_path):
    cst, st = WalkerStar(2, 3), station_subnetwork(2)
    aw = compute_access_windows(cst, st, horizon_s=HORIZON, device="cpu")
    from repro_torch.data import synth_femnist as port_data
    data = port_data(cst.n_sats, seed=0)
    cfg = SimConfig(max_rounds=2, horizon_s=HORIZON, eval_every=1,
                    clients_per_round=5, max_steps=16, record_params=True)
    names = ("fedavg", "fedbuff")
    ranks = spawn(engine_rank, 4, str(tmp_path), cst, st, aw, data, cfg,
                  names)
    for name in names:
        host = ConstellationSim(cst, st, ALGORITHMS[name], data=data,
                                cfg=cfg, access=aw, device="cpu").run()
        assert host.n_rounds >= 2
        assert any(len(r.participants) == 5 for r in host.rounds)
        for out in ranks:
            mesh = out[name]
            assert _records(host, "mesh") == _records(mesh)
            for a, b in zip(host.params_history, mesh.params_history):
                assert _max_gap(a, b) <= 1e-5
            for (_, _, a), (_, _, b) in zip(host.accuracy_curve,
                                            mesh.accuracy_curve):
                assert abs(a - b) <= 1e-5
        # Every rank ends with the same model, bit for bit.
        for out in ranks[1:]:
            assert _max_gap(out[name].final_params,
                            ranks[0][name].final_params) == 0.0
    # Two all-reduces a round or flush on every rank.
    rounds = sum(ranks[0][n].n_rounds for n in names)
    assert all(out["collectives"]["all_reduce"] == 2 * rounds
               for out in ranks)


# --------------------------------------------------------------------- #
# (d) the aggregation collectives and the fedagg partial form
# --------------------------------------------------------------------- #
K = 5


def _trees(n: int, seed: int = 0) -> list[dict]:
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    return [jax.device_get(jax_init(k)) for k in keys]


def _stack(trees):
    return jax.tree.map(lambda *xs: np.stack(xs), *trees)


@pytest.mark.parametrize("weights", [[100.0, 0.0, 250.0, 31.0, 7.0],
                                     [0.0] * K])
def test_masked_delta_allreduce_matches_reference(weights):
    """One rank holds the whole block: with server_lr 1 and undiscounted
    weights the collective is `weighted_average`, with discounted weights
    and server_lr it is `weighted_delta_update`; a round whose weights
    total 0 keeps the old model."""
    trees = _trees(K + 1, seed=3)
    g_tree, stacked_tree = trees[0], _stack(trees[1:])
    g = params_from_jax(g_tree, device="cpu")
    stacked = params_from_jax(stacked_tree, device="cpu")
    mesh = client_mesh(device="cpu")
    w = torch.tensor(weights)
    out = masked_delta_allreduce(g, stacked, w, mesh)
    if sum(weights):
        want = jax_average(stacked_tree, jnp.asarray(weights))
    else:
        want = g_tree
        assert torch.equal(out, g)
    assert _max_gap(params_to_numpy(out), want) <= 1e-6
    stale = np.array([0, 2, 1, 5, 0])
    disc = torch.as_tensor(1.0 / np.sqrt(1.0 + stale), dtype=torch.float32)
    out = masked_delta_allreduce(g, stacked, w * disc, mesh, server_lr=0.7)
    want = jax_delta(g_tree, stacked_tree, jnp.asarray(weights),
                     jnp.asarray(stale), server_lr=0.7)
    assert _max_gap(params_to_numpy(out), want) <= 1e-6


def test_participation_masked_psum_one_pod():
    """One pod (one rank): the masked psum of an update tree is the update
    itself when the pod participates and 0 when it does not; leaves of
    two dtypes go through one bucket each."""
    mesh = client_mesh(device="cpu")
    upd = {"a": torch.arange(6.0).view(2, 3),
           "b": [torch.ones(4, dtype=torch.bfloat16)],
           "c": torch.tensor([-1.5])}
    reset_collectives()
    out = participation_masked_psum(upd, torch.tensor(12.0), mesh)
    assert torch.equal(out["a"], upd["a"]) and torch.equal(out["c"],
                                                           upd["c"])
    assert out["b"][0].dtype == torch.bfloat16
    assert torch.equal(out["b"][0], upd["b"][0])
    assert COLLECTIVES["all_reduce"] == 3     # the total, two buckets
    zero = participation_masked_psum(upd, torch.tensor(0.0), mesh)
    assert all(float(t.abs().sum()) == 0 for t in
               (zero["a"], zero["b"][0], zero["c"]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fedagg_partial_plain_version_is_its_formula(dtype):
    """sum_k w_k (x_k - base) in f32, stored in x's dtype; the delta form
    is base + scale * (the partial form)."""
    g = torch.Generator().manual_seed(7)
    x = torch.randn((6, 1001), generator=g).to(dtype)
    w = torch.rand((6,), generator=g)
    base = torch.randn((1001,), generator=g).to(dtype)
    got = ref.fedagg_ref(x, w, base, partial=True)
    want = (w[:, None] * (x.double() - base.double())).sum(0)
    assert got.dtype == dtype
    tol = 1e-6 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.double(), want, rtol=tol, atol=tol)
    delta = ref.fedagg_ref(x, w, base, 0.5)
    torch.testing.assert_close(
        delta.float(), (base.float() + 0.5 * ref.fedagg_ref(
            x.float(), w, base.float(), partial=True)).to(dtype).float())
    with pytest.raises(ValueError, match="partial"):
        ref.fedagg_ref(x, w, None, partial=True)


def test_cuda_tensors_are_refused_without_nccl():
    """The one-rank CPU group runs gloo only: a tensor on a CUDA device is
    refused by name before any collective runs, and a group with no
    backend for a device type is refused too."""
    import types

    from repro_torch.sharding.compat import backend_for
    group = client_mesh(device="cpu").group
    assert backend_for(torch.zeros(1), group) == "gloo"
    cuda = types.SimpleNamespace(is_cuda=True, device=torch.device("cuda"))
    with pytest.raises(RuntimeError, match="NCCL"):
        backend_for(cuda, group)
    meta = types.SimpleNamespace(is_cuda=False, device=torch.device("meta"))
    with pytest.raises(RuntimeError, match="no backend"):
        backend_for(meta, group)


def test_pad_client_count_and_blocks():
    mesh = client_mesh(device="cpu")
    assert (mesh.rank, mesh.size) == (0, 1)
    assert pad_client_count(5, mesh) == 5 and pad_client_count(0, mesh) == 1
    four = dataclasses.replace(mesh, rank=3, size=4)
    assert pad_client_count(5, four) == 8
    assert four.block(8) == slice(6, 8)
    with pytest.raises(ValueError, match="pad"):
        four.block(5)
