"""Port aggregation (through the `fedagg` plain version) vs the reference."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.aggregation import admission_weights as jax_admission
from repro.core.aggregation import normalized_weights as jax_normalized
from repro.core.aggregation import weighted_average as jax_average
from repro.core.aggregation import weighted_delta_update as jax_delta
from repro.models.femnist_mlp import femnist_mlp_init as jax_init
from repro_torch.core.aggregation import (
    admission_weights,
    normalized_weights,
    weighted_average,
    weighted_delta_update,
)
from repro_torch.core.strategies import FedAvgSat, FedBuffSat
from repro_torch.params import params_from_jax, params_to_numpy

K = 5


def _trees(n: int, seed: int = 0) -> list[dict]:
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    return [jax.device_get(jax_init(k)) for k in keys]


def _stack(trees):
    return jax.tree.map(lambda *xs: np.stack(xs), *trees)


def _close(mine: torch.Tensor, ref_tree, tol: float = 1e-6):
    for a, b in zip(jax.tree.leaves(params_to_numpy(mine)),
                    jax.tree.leaves(jax.device_get(ref_tree))):
        np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol)


@pytest.mark.parametrize("weights", [
    [200.0, 350.0, 271.0, 0.0, 300.0],
    [1.0, 1.0, 1.0, 1.0, 1.0],
    [0.0, 0.0, 0.0, 0.0, 0.0],          # empty round: reference semantics
])
def test_weighted_average_matches_reference(weights):
    stacked = _stack(_trees(K))
    w = np.asarray(weights, np.float32)
    want = jax_average(stacked, jnp.asarray(w), use_kernel=False)
    got = weighted_average(params_from_jax(stacked, device="cpu"),
                           torch.as_tensor(w))
    _close(got, want)
    np.testing.assert_array_equal(normalized_weights(torch.as_tensor(w)),
                                  np.asarray(jax_normalized(jnp.asarray(w))))


@pytest.mark.parametrize("server_lr", [1.0, 0.5])
@pytest.mark.parametrize("staleness", [[0, 0, 0, 0, 0], [0, 1, 2, 3, 4],
                                       [5, 5, 1, 0, 3]])
def test_weighted_delta_update_matches_reference(staleness, server_lr):
    trees = _trees(K + 1, seed=2)
    glob, stacked = trees[0], _stack(trees[1:])
    ns = np.array([210.0, 330.0, 250.0, 301.0, 222.0], np.float32)
    st = np.asarray(staleness, np.int32)
    w = admission_weights(ns, st, 4)
    assert np.array_equal(w, jax_admission(ns, st, 4))
    want = jax_delta(glob, stacked, jnp.asarray(w), jnp.asarray(st),
                     server_lr=server_lr)
    got = weighted_delta_update(params_from_jax(glob, device="cpu"),
                                params_from_jax(stacked, device="cpu"),
                                torch.as_tensor(w), torch.as_tensor(st),
                                server_lr=server_lr)
    _close(got, want)


def test_all_zero_weight_round_keeps_the_model():
    trees = _trees(K + 1, seed=3)
    glob = params_from_jax(trees[0], device="cpu")
    stacked = params_from_jax(_stack(trees[1:]), device="cpu")
    zero = torch.zeros(K)
    st = torch.tensor([5, 6, 7, 8, 9], dtype=torch.int32)
    got = weighted_delta_update(glob, stacked, zero, st)
    assert torch.equal(got, glob)
    want = jax_delta(trees[0], _stack(trees[1:]), jnp.zeros(K),
                     jnp.asarray(st.numpy()))
    _close(got, want)
    # The FedBuff strategy hook routes here; FedAvg's to the average.
    assert torch.equal(FedBuffSat().aggregate(glob, stacked, zero, st), glob)
    ones = torch.ones(K)
    _close(FedAvgSat().aggregate(glob, stacked, ones, st),
           jax_average(_stack(trees[1:]), jnp.ones(K), use_kernel=False))


def test_admission_weights_on_tensors_and_arrays():
    ns = np.array([1.0, 2.0, 3.0], np.float32)
    st = np.array([0, 4, 5], np.int32)
    want = np.asarray(jax_admission(jnp.asarray(ns), jnp.asarray(st), 4))
    np.testing.assert_array_equal(admission_weights(ns, st, 4), want)
    np.testing.assert_array_equal(
        admission_weights(torch.as_tensor(ns), torch.as_tensor(st), 4)
        .numpy(), want)
