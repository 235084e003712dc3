"""The port's launch-style FL round (`make_fl_round_step`) vs the reference.

The reference's own `make_fl_round_step` fails under jax 0.9's
`shard_map` (ROADMAP section 3, reference caveats), so its oracle is
composed here from reference functions that work: `jax.grad` of the
reference's `lm_loss`, the proximal SGD update of
`src/repro/launch/fl_round.py` (`p - lr * (g + mu * (p - p0))`) for each
pod's live steps, then the reference's `weighted_delta_update` over the
pods (FedBuff's discount and server lr; with one pod the weights
normalise away). Held within 1e-5 at one rank (the port's one-rank
default group) and at two gloo ranks.

Also the reference test file's semantics (`tests/test_fl_round.py`): a
participating round moves params, weight 0 and steps 0 give back the
params bit for bit, a quadratic `loss_fn` reaches 0 in one step,
FedBuff's weight semantics, and a `Workload`'s batch schema driving the
round; and a pod count other than the group's size raises.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.aggregation import weighted_delta_update as jax_delta
from repro.models.lm import init_params as jax_init_params
from repro.train.step import lm_loss as jax_lm_loss
from repro_torch.configs import get_config
from repro_torch.core.workload import get_workload
from repro_torch.launch.fl_round import make_fl_round_step
from repro_torch.models.lm.params import lm_params_from_jax, \
    lm_params_to_numpy, tree_leaves
from repro_torch.sharding import COLLECTIVES, client_mesh, \
    reset_collectives
from torch_mesh_ranks import fl_round_rank, spawn

# One torch thread a worker, as `torch_parity` sets it for the other
# parity files: the suite runs several workers (and these files' spawned
# ranks) at once.
torch.set_num_threads(1)

LR, MU = 1e-2, 0.1


def _setup(arch: str, n_pods: int = 1, seq: int = 32):
    jcfg = jax_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    assert cfg.dtype == jcfg.dtype == "float32"
    params_np = jax.device_get(jax_init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (2 * n_pods, seq)).astype(
        np.int32)
    return jcfg, cfg, params_np, tokens


def _oracle(jcfg, params_np, tokens, weights, steps, staleness,
            local_steps: int, server_lr: float = 1.0) -> dict:
    """The composed reference round: each pod's proximal SGD on its rows,
    then `weighted_delta_update` over the pods."""
    params = jax.tree.map(jnp.asarray, params_np)
    grad = jax.jit(jax.grad(
        lambda p, t: jax_lm_loss(jcfg, p, {"tokens": t})[0]))
    rows = tokens.shape[0] // len(weights)
    pods = []
    for k in range(len(weights)):
        tok = jnp.asarray(tokens[k * rows:(k + 1) * rows])
        local = params
        for _ in range(min(local_steps, steps[k])):
            g = grad(local, tok)
            local = jax.tree.map(
                lambda p, gi, p0: p - LR * (gi + MU * (p - p0)),
                local, g, params)
        pods.append(local)
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *pods)
    return jax.device_get(jax_delta(params, stacked,
                                    jnp.asarray(weights, jnp.float32),
                                    jnp.asarray(staleness), server_lr))


def _max_gap(mine: dict, want: dict) -> float:
    la, lb = jax.tree.leaves(mine), jax.tree.leaves(want)
    assert len(la) == len(lb) > 0
    return max(float(np.max(np.abs(np.asarray(a, np.float32)
                                   - np.asarray(b, np.float32))))
               for a, b in zip(la, lb))


@pytest.fixture(scope="module")
def gemma():
    jcfg, cfg, params_np, tokens = _setup("gemma-2b")
    return jcfg, cfg, params_np, tokens, lm_params_from_jax(params_np,
                                                            device="cpu")


def _moved(a, b) -> float:
    return sum(float((x - y).abs().sum())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


# --------------------------------------------------------------------- #
# the reference test file's semantics
# --------------------------------------------------------------------- #
def test_participating_round_moves_params(gemma):
    _, cfg, _, tokens, params = gemma
    step = make_fl_round_step(cfg, lr=LR)
    out = step(params, {"tokens": torch.as_tensor(tokens)}, [300.0])
    assert _moved(params, out) > 0.0


def test_masked_round_is_identity(gemma):
    """Zero participation weight (no ground contact) keeps the old model,
    bit for bit, though the pod trained."""
    _, cfg, _, tokens, params = gemma
    out = make_fl_round_step(cfg, lr=LR)(
        params, {"tokens": torch.as_tensor(tokens)}, [0.0])
    assert _same(params, out)


def test_variable_local_steps_mask(gemma):
    """steps = 0 freezes a pod even when its weight participates."""
    _, cfg, _, tokens, params = gemma
    out = make_fl_round_step(cfg, lr=LR, local_steps=4)(
        params, {"tokens": torch.as_tensor(tokens)}, [300.0], steps=[0])
    assert _same(params, out)


def test_generic_loss_fn_replaces_model_config():
    """Any loss_fn(params, batch): one SGD step on sum(w^2) at lr 0.5
    lands on 0."""
    step = make_fl_round_step(lr=0.5, local_steps=1,
                              loss_fn=lambda p, b: (p["w"] ** 2).sum(),
                              batch_dims={"obs": 2})
    out = step({"w": torch.tensor([2.0, -4.0])}, {"obs": torch.zeros(1, 1)},
               [1.0])
    assert torch.equal(out["w"], torch.zeros(2))


def test_fedbuff_weight_semantics_on_mesh():
    """A stale pod's delta is scaled by server_lr; with one pod the
    staleness discount normalizes away."""
    kw = dict(lr=1.0, local_steps=1, loss_fn=lambda p, b: p["w"].sum(),
              batch_dims={"obs": 2})
    params, batch = {"w": torch.zeros(2)}, {"obs": torch.zeros(1, 1)}
    fresh = make_fl_round_step(**kw)(params, batch, [10.0])
    halved = make_fl_round_step(server_lr=0.5, **kw)(params, batch, [10.0],
                                                     staleness=[3])
    torch.testing.assert_close(fresh["w"], torch.tensor([-1.0, -1.0]))
    torch.testing.assert_close(halved["w"], torch.tensor([-0.5, -0.5]))


def test_workload_batch_specs_drive_round_step():
    """A Workload's `mesh_batch_dims` declare the batch schema: the LM
    contract ({"tokens": ...}) and the classification default ({"x": ...,
    "labels": ...}), each on the workload's flat params."""
    rng = np.random.default_rng(0)
    lm = get_workload("lm_tiny")
    assert lm.mesh_batch_dims == {"tokens": 2}
    params = lm.init_fn(torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": torch.as_tensor(rng.integers(0, 128, (2, 33)),
                                       dtype=torch.int32)}
    out = make_fl_round_step(lr=1e-2, workload=lm)(params, batch, [10.0])
    assert out.shape == params.shape and float((out - params).abs().sum()) > 0
    mlp = get_workload("femnist_mlp")
    params = mlp.init_fn(torch.Generator().manual_seed(1), "cpu")
    batch = {"x": torch.as_tensor(rng.normal(size=(4, 28, 28, 1)),
                                  dtype=torch.float32),
             "labels": torch.as_tensor(rng.integers(0, 47, (4,)),
                                       dtype=torch.int32)}
    out = make_fl_round_step(lr=1e-2, workload=mlp)(params, batch, [10.0])
    assert float((out - params).abs().sum()) > 0
    with pytest.raises(KeyError, match="batch_dims"):
        make_fl_round_step(lr=1e-2, workload=mlp)(
            params, dict(batch, extra=torch.zeros(4)), [10.0])


def test_pod_count_must_equal_group_size(gemma):
    _, cfg, _, tokens, params = gemma
    with pytest.raises(ValueError, match="one pod per rank"):
        make_fl_round_step(cfg, lr=LR)(
            params, {"tokens": torch.as_tensor(tokens)}, [300.0, 100.0])
    # A batch whose rows do not split over the pods is refused, not cut
    # (checked before any collective, so a mesh of two on one rank will
    # do).
    two = dataclasses.replace(client_mesh(device="cpu"), size=2)
    odd = torch.as_tensor(np.concatenate([tokens, tokens[:1]]))
    with pytest.raises(ValueError, match="not a multiple of 2 pods"):
        make_fl_round_step(cfg, mesh=two, lr=LR)(
            params, {"tokens": odd}, [300.0, 100.0])


# --------------------------------------------------------------------- #
# against the composed reference oracle
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["gemma-2b", "hymba-1.5b"])
def test_one_rank_round_matches_composed_reference(arch):
    jcfg, cfg, params_np, tokens = _setup(arch)
    params = lm_params_from_jax(params_np, device="cpu")
    reset_collectives()
    step = make_fl_round_step(cfg, lr=LR, local_steps=2, prox_mu=MU,
                              server_lr=0.8)
    out = step(params, {"tokens": torch.as_tensor(tokens)}, [300.0],
               staleness=[2])
    assert COLLECTIVES["all_reduce"] == 2    # the total, one f32 bucket
    want = _oracle(jcfg, params_np, tokens, [300.0], [2], [2], 2, 0.8)
    assert _max_gap(lm_params_to_numpy(out), want) <= 1e-5
    assert _max_gap(lm_params_to_numpy(out), params_np) > 1e-4


def test_two_ranks_match_composed_reference(tmp_path):
    """Two pods on two gloo ranks, with their own weights, step budgets
    and staleness: every rank returns the composed reference's model."""
    jcfg, cfg, params_np, tokens = _setup("gemma-2b", n_pods=2)
    weights, steps, stale = [300.0, 120.0], [2, 1], [0, 3]
    kw = dict(lr=LR, local_steps=2, prox_mu=MU, server_lr=0.7)
    ranks = spawn(fl_round_rank, 2, str(tmp_path), cfg, params_np, tokens,
                  weights, steps, stale, kw)
    want = _oracle(jcfg, params_np, tokens, weights, steps, stale, 2, 0.7)
    for out in ranks:
        assert _max_gap(out, want) <= 1e-5
    assert _max_gap(ranks[0], ranks[1]) == 0.0
