"""Port `femnist_cnn` (the paper's 47,887-parameter CNN) vs the reference.

The same numpy inputs go through `repro.models.femnist_cnn` and
`repro_torch.models.femnist_cnn` on the CPU: logits, gradients and a local
step within 1e-5; the flat layout, the init distribution, the workload's
derived cost model and the config as the reference's; and trained
`ConstellationSim` runs on one shared `AccessWindows` with the reference's
init and minibatch draws (`torch_parity.JaxReplaySampler`).

A trained CNN run is not held within 1e-5: its max-pools send a window's
gradient to its largest input, and where two inputs lie within a few ulps
(conv outputs that XLA's and PyTorch's matmuls sum in another order) the
two packages route it to different positions, a step ~lr * 1e-3 apart;
later steps amplify that (the reference's own loop and batched executors
part the same way). The trained-run test holds the port to
the reference as closely as rounding alone carries the port from itself:
the same run from init params one ulp away.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ALGORITHMS as JAX_ALGORITHMS
from repro.core.client import classification_loss as jax_classification_loss
from repro.core.client import vmapped_client_update as jax_vmapped_update
from repro.core.timing import HardwareModel as JaxHardwareModel
from repro.core.workload import get_workload as jax_get_workload
from repro.data import synth_femnist
from repro.models.femnist_cnn import femnist_cnn_apply as jax_apply
from repro.models.femnist_cnn import femnist_cnn_init as jax_init
from repro.orbits import WalkerStar as JaxWalkerStar
from repro.orbits import compute_access_windows as jax_windows
from repro.orbits import station_subnetwork as jax_stations
from repro.sim import ConstellationSim as JaxSim
from repro.sim import SimConfig as JaxConfig
from repro_torch.core import ALGORITHMS
from repro_torch.core.client import classification_loss, \
    vmapped_client_update
from repro_torch.core.timing import HardwareModel
from repro_torch.core.workload import get_workload
from repro_torch.models.femnist_cnn import femnist_cnn_apply, \
    femnist_cnn_init
from repro_torch.orbits import WalkerStar, station_subnetwork
from repro_torch.orbits.access import AccessWindows
from repro_torch.params import FEMNIST_CNN, params_from_jax, \
    params_to_numpy
from repro_torch.sim import ConstellationSim, SimConfig
from torch_parity import JaxReplaySampler, jax_init_params, replay_indices

TOL = 1e-5


def _jax_params(seed: int) -> dict:
    return jax.device_get(jax_init(jax.random.PRNGKey(seed)))


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(v).reshape(-1)
                           for v in jax.tree.leaves(tree)])


# --------------------------------------------------------------- forward
@pytest.mark.parametrize("n", [1, 5, 32])
def test_logits_match_reference_one_client(n):
    tree = _jax_params(0)
    x = np.random.default_rng(n).random((n, 28, 28, 1), dtype=np.float32)
    want = np.asarray(jax_apply(tree, jnp.asarray(x)))
    flat = params_from_jax(tree, FEMNIST_CNN, device="cpu")
    got = femnist_cnn_apply(FEMNIST_CNN.views(flat), torch.as_tensor(x))
    assert got.shape == (n, 47)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_logits_match_reference_stacked_clients():
    """A (C, P) client stack, each client its own params and images."""
    trees = [_jax_params(s) for s in range(3)]
    x = np.random.default_rng(7).random((3, 6, 28, 28, 1), dtype=np.float32)
    want = np.stack([np.asarray(jax_apply(t, jnp.asarray(x[c])))
                     for c, t in enumerate(trees)])
    stack = torch.stack([params_from_jax(t, FEMNIST_CNN, device="cpu")
                         for t in trees])
    got = femnist_cnn_apply(FEMNIST_CNN.views(stack), torch.as_tensor(x))
    assert got.shape == (3, 6, 47)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


# ------------------------------------------------------ params and init
def test_layout_is_the_reference_leaf_order_and_round_trips():
    tree = _jax_params(0)
    paths = [("/".join(k.key for k in path), np.shape(leaf)) for path, leaf
             in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert list(FEMNIST_CNN.leaves) == paths
    assert FEMNIST_CNN.size == 47_887 == sum(np.size(v) for v in
                                             jax.tree.leaves(tree))
    flat = params_from_jax(tree, FEMNIST_CNN, device="cpu")
    back = params_to_numpy(flat, FEMNIST_CNN)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == np.float32 and np.array_equal(a, np.asarray(b))


@pytest.mark.parametrize("layer", ["conv1", "conv2", "fc1", "fc2"])
def test_init_std_matches_reference(layer):
    """He-normal with jax's fan-in (every axis but the last: 3*3*Cin for a
    conv kernel), over 10 draws of each package: the pooled standard
    deviations within 5 %, the same truncation at 2 sigma (max |w| / std
    below 2.3 for both: 2 / 0.8796), zero biases."""
    ref = np.concatenate([np.asarray(_jax_params(s)[layer]["w"]).ravel()
                          for s in range(10)])
    draws = [FEMNIST_CNN.views(femnist_cnn_init(
        torch.Generator().manual_seed(s), "cpu")) for s in range(10)]
    mine = np.concatenate([d[layer]["w"].numpy().ravel() for d in draws])
    assert abs(mine.std() / ref.std() - 1) <= 0.05, (mine.std(), ref.std())
    assert np.abs(mine).max() / mine.std() < 2.3
    assert np.abs(ref).max() / ref.std() < 2.3
    assert all(not d[layer]["b"].any() for d in draws)


# ------------------------------------------------- workload and config
def test_cost_model_matches_reference():
    mine, ref = get_workload("femnist_cnn"), jax_get_workload("femnist_cnn")
    assert mine.n_params == ref.n_params == 47_887
    assert mine.model_bytes == ref.model_bytes == 191_548
    assert mine.flops_per_sample == ref.flops_per_sample == 1_972_656.0
    assert mine.epoch_mflops == ref.epoch_mflops
    assert mine.sample_shape == ref.sample_shape
    assert dataclasses.asdict(HardwareModel.for_workload("femnist_cnn")) \
        == dataclasses.asdict(JaxHardwareModel.for_workload("femnist_cnn"))


# ------------------------------------------------- gradient and a step
def test_gradient_matches_reference():
    data = synth_femnist(2, seed=0)
    tree = _jax_params(0)
    xb, yb = data.x[0][:32], data.y[0][:32]
    want = jax.grad(jax_classification_loss(jax_apply))(
        tree, jnp.asarray(xb), jnp.asarray(yb))
    flat = params_from_jax(tree, FEMNIST_CNN, device="cpu")[None]
    flat = flat.clone().requires_grad_(True)
    loss = classification_loss(femnist_cnn_apply)(
        FEMNIST_CNN.views(flat), torch.as_tensor(xb)[None],
        torch.as_tensor(yb).long()[None]).sum()
    (got,) = torch.autograd.grad(loss, flat)
    np.testing.assert_allclose(got[0].numpy(),
                               params_from_jax(jax.device_get(want),
                                               FEMNIST_CNN,
                                               device="cpu").numpy(),
                               rtol=TOL, atol=TOL)


def test_first_local_step_of_a_client_stack_matches_reference():
    """One FedProx step (mu 0.1) of four clients whose params sit away
    from their anchor, the reference's minibatch draw."""
    data = synth_femnist(4, seed=0)
    anchor = _jax_params(0)
    noise = np.random.default_rng(1)
    params0 = jax.tree.map(
        lambda a: np.stack([np.asarray(a) + noise.normal(
            scale=1e-2, size=np.shape(a)).astype(np.float32)
            for _ in range(4)]), anchor)
    rngs = jax.random.split(jax.random.PRNGKey(5), 4)
    steps = np.ones(4, np.int32)
    want = jax.device_get(jax.jit(jax_vmapped_update(
        jax_classification_loss(jax_apply), lr=0.05, batch_size=32,
        max_steps=1))(params0, anchor, jnp.asarray(data.x),
                      jnp.asarray(data.y), jnp.asarray(data.n),
                      jnp.asarray(steps), 0.1, rngs))
    idx = replay_indices(rngs, data.n, 1, 32)
    update = vmapped_client_update(
        classification_loss(femnist_cnn_apply), lr=0.05, batch_size=32,
        max_steps=1, layout=FEMNIST_CNN)
    got = update(params_from_jax(params0, FEMNIST_CNN, device="cpu"),
                 params_from_jax(anchor, FEMNIST_CNN, device="cpu"),
                 torch.as_tensor(data.x), torch.as_tensor(data.y).long(),
                 [1] * 4, 0.1, torch.as_tensor(idx))
    np.testing.assert_allclose(
        got.numpy(), params_from_jax(want, FEMNIST_CNN, device="cpu").numpy(),
        rtol=TOL, atol=TOL)


# ------------------------------------------------------- trained runs
HORIZON = 4 * 86400.0
RECORD_FIELDS = ("idx", "t_start", "t_end", "participants", "epochs",
                 "idle_s", "compute_s", "comm_s", "relays", "staleness",
                 "relay_hops", "comms_bytes")


@pytest.fixture(scope="module")
def shared():
    aw = jax_windows(JaxWalkerStar(2, 2), jax_stations(1), horizon_s=HORIZON)
    return aw, synth_femnist(4, seed=0)


def _records(res) -> list:
    return [[getattr(r, f) for f in RECORD_FIELDS] for r in res.rounds]


@pytest.mark.parametrize("name", ["fedavg", "fedprox", "fedbuff"])
def test_trained_run_matches_reference(name, shared):
    """c2s2/g1, 3 rounds: RoundRecords bitwise, the same evaluations, and
    the final params no farther from the reference's than the port's own
    run lands from the port's run started one ulp away (times 3; measured
    0.5-1.0 of it), so what separates the two packages is rounding."""
    aw, data = shared
    kw = dict(max_rounds=3, horizon_s=HORIZON, eval_every=1, max_steps=16)
    ref = JaxSim(JaxWalkerStar(2, 2), jax_stations(1), JAX_ALGORITHMS[name],
                 data=data, cfg=JaxConfig(**kw), access=aw,
                 workload="femnist_cnn").run()
    paw = AccessWindows(aw.per_sat, aw.per_sat_station, aw.cluster,
                        aw.horizon_s, aw.dt_s)
    init = jax_init_params(0, "femnist_cnn")
    nudged = jax.tree.map(
        lambda v: np.nextafter(np.asarray(v), np.float32(np.inf)), init)

    def port(start):
        return ConstellationSim(
            WalkerStar(2, 2), station_subnetwork(1), ALGORITHMS[name],
            data=data, cfg=SimConfig(**kw), access=paw,
            workload="femnist_cnn", device="cpu",
            sampler=JaxReplaySampler(0), init_params=start).run()

    res, res_ulp = port(init), port(nudged)
    assert len(ref.rounds) == 3
    assert _records(res) == _records(ref) == _records(res_ulp)
    assert [(i, t) for i, t, _ in res.accuracy_curve] == \
        [(i, t) for i, t, _ in ref.accuracy_curve]
    mine, want = _flat(res.final_params), _flat(ref.final_params)
    gap = float(np.linalg.norm(mine - want))
    envelope = float(np.linalg.norm(mine - _flat(res_ulp.final_params)))
    print(f"{name}: |port - ref| {gap:.4g}, |port - port(+1 ulp)| "
          f"{envelope:.4g}, |ref - init| "
          f"{np.linalg.norm(want - _flat(init)):.4g}")
    assert np.isfinite(mine).all()
    assert gap <= 3 * envelope + TOL
