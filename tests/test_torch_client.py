"""Port client update, model and flat layout vs the reference."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.client import classification_loss as jax_ce_loss
from repro.core.client import evaluate as jax_evaluate
from repro.core.client import vmapped_client_update as jax_vmapped
from repro.models.femnist_mlp import femnist_mlp_apply as jax_apply
from repro.models.femnist_mlp import femnist_mlp_init as jax_init
from repro_torch.core.client import (
    classification_loss,
    evaluate,
    make_client_update,
    vmapped_client_update,
)
from repro_torch.models.femnist_mlp import femnist_mlp_apply, femnist_mlp_init
from repro_torch.params import FEMNIST_MLP, params_from_jax, params_to_numpy
from torch_parity import replay_indices


def _jax_params(seed: int = 0) -> dict:
    return jax.device_get(jax_init(jax.random.PRNGKey(seed)))


def _leaves(tree: dict) -> list[np.ndarray]:
    return [np.asarray(l) for l in jax.tree.leaves(tree)]


def test_flat_layout_round_trips_jax_init_bitwise():
    tree = _jax_params()
    flat = params_from_jax(tree, device="cpu")
    assert flat.shape == (46_639,) and flat.dtype == torch.float32
    assert FEMNIST_MLP.size == sum(l.size for l in _leaves(tree))
    back = params_to_numpy(flat)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(_leaves(back), _leaves(tree)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.array_equal(a, b)
    # Flattening order is jax.tree.leaves order: the port's buffer is the
    # concatenation the reference's kernel wrappers build.
    np.testing.assert_array_equal(
        flat.numpy(), np.concatenate([l.reshape(-1) for l in _leaves(tree)]))
    stacked = jax.tree.map(lambda *xs: np.stack(xs), tree, _jax_params(1))
    flat2 = params_from_jax(stacked, device="cpu")
    assert flat2.shape == (2, 46_639)
    for a, b in zip(_leaves(params_to_numpy(flat2)), _leaves(stacked)):
        assert np.array_equal(a, b)


def test_views_write_through_to_the_flat_buffer():
    flat = torch.zeros(FEMNIST_MLP.size)
    FEMNIST_MLP.views(flat)["fc2"]["b"][3] = 7.0
    assert params_to_numpy(flat)["fc2"]["b"][3] == 7.0
    with pytest.raises(ValueError):
        FEMNIST_MLP.views(torch.zeros(10))


def test_init_distribution_is_truncated_he_normal():
    flat = femnist_mlp_init(torch.Generator().manual_seed(0), device="cpu")
    tree = params_to_numpy(flat)
    ref = _jax_params()
    for layer, fan_in in (("fc1", 784), ("fc2", 56)):
        w = tree[layer]["w"]
        assert w.shape == ref[layer]["w"].shape
        assert np.all(tree[layer]["b"] == 0)
        std = np.sqrt(2.0 / fan_in)
        bound = 2 * std / 0.87962566103423978
        assert np.abs(w).max() <= bound + 1e-7
        assert abs(w.std() - std) < 0.1 * std
        assert abs(w.std() - ref[layer]["w"].std()) < 0.1 * std


def test_mlp_logits_match_single_and_stacked():
    rng = np.random.default_rng(0)
    tree = _jax_params()
    x = rng.random((2, 16, 28, 28, 1)).astype(np.float32)
    want = np.asarray(jax_apply(tree, jnp.asarray(x[0])))
    flat1 = params_from_jax(tree, device="cpu")
    got = femnist_mlp_apply(FEMNIST_MLP.views(flat1), torch.as_tensor(x[0]))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    trees = [tree, _jax_params(3)]
    flat = torch.stack([params_from_jax(t, device="cpu") for t in trees])
    got2 = femnist_mlp_apply(FEMNIST_MLP.views(flat), torch.as_tensor(x))
    for c in range(2):
        want_c = np.asarray(jax_apply(trees[c], jnp.asarray(x[c])))
        np.testing.assert_allclose(got2[c].numpy(), want_c,
                                   rtol=1e-5, atol=1e-5)


def _client_inputs(seed: int = 1):
    rng = np.random.default_rng(seed)
    C, N = 4, 60
    x = rng.random((C, N, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 47, size=(C, N)).astype(np.int32)
    n = np.array([60, 41, 7, 33], np.int32)
    steps = np.array([5, 0, 3, 8], np.int32)
    return x, y, n, steps


@pytest.mark.parametrize("mu", [0.0, 0.1])
@pytest.mark.parametrize("anchored", [False, True])
def test_vmapped_client_update_matches_reference(mu, anchored):
    x, y, n, steps = _client_inputs()
    C, bound, B, lr = len(n), 8, 16, 0.05
    base = _jax_params()
    if anchored:
        trees = [_jax_params(s) for s in range(C)]
        stacked = jax.tree.map(lambda *xs: np.stack(xs), *trees)
        params0, anchor = stacked, stacked
    else:
        stacked = jax.tree.map(lambda a: np.broadcast_to(a, (C,) + a.shape),
                               base)
        params0, anchor = stacked, base
    rngs = jax.random.split(jax.random.PRNGKey(3), C)
    update = jax.jit(jax_vmapped(jax_ce_loss(jax_apply), lr=lr, batch_size=B,
                                 max_steps=bound, anchored=anchored))
    want = update(params0, anchor, jnp.asarray(x), jnp.asarray(y),
                  jnp.asarray(n), jnp.asarray(steps), mu, rngs)

    idx = torch.as_tensor(replay_indices(rngs, n, bound, B))
    mine = vmapped_client_update(classification_loss(femnist_mlp_apply),
                                 lr=lr, batch_size=B, max_steps=bound)
    p0 = params_from_jax(params0, device="cpu")
    got = mine(p0, params_from_jax(anchor, device="cpu"), torch.as_tensor(x),
               torch.as_tensor(y).long(), steps.tolist(), mu, idx)
    # input untouched
    assert torch.equal(p0, params_from_jax(params0, device="cpu"))
    for a, b in zip(_leaves(params_to_numpy(got)),
                    _leaves(jax.device_get(want))):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    # A client with a zero step budget returns its start params bitwise.
    assert torch.equal(got[1], p0[1])


def test_single_client_update_is_the_stack_of_one():
    x, y, n, steps = _client_inputs(2)
    rngs = jax.random.split(jax.random.PRNGKey(4), 4)
    idx = torch.as_tensor(replay_indices(rngs, n, 8, 16))
    p0 = params_from_jax(_jax_params(), device="cpu")
    loss = classification_loss(femnist_mlp_apply)
    stacked = vmapped_client_update(loss, batch_size=16, max_steps=8)
    single = make_client_update(femnist_mlp_apply, batch_size=16,
                                max_steps=8)
    want = stacked(p0.expand(4, -1), p0, torch.as_tensor(x),
                   torch.as_tensor(y).long(), steps.tolist(), 0.1, idx)
    for c in range(4):
        got = single(p0, p0, torch.as_tensor(x[c]),
                     torch.as_tensor(y[c]).long(), int(steps[c]), 0.1,
                     idx[c])
        np.testing.assert_allclose(got.numpy(), want[c].numpy(),
                                   rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="max_steps"):
        stacked(p0.expand(4, -1), p0, torch.as_tensor(x),
                torch.as_tensor(y).long(), [9, 0, 0, 0], 0.1, idx)


def test_evaluate_matches_reference():
    rng = np.random.default_rng(5)
    K, N = 4, 64
    x = rng.random((K, N, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 47, size=(K, N)).astype(np.int32)
    n_valid = np.array([64, 64, 20, 0], np.int32)
    tree = _jax_params()
    # Label half of each client's samples with the model's own prediction
    # so the accuracy is well away from zero.
    for c in range(K):
        y[c, : N // 2] = np.asarray(
            jnp.argmax(jax_apply(tree, jnp.asarray(x[c, : N // 2])), -1))
    want = float(jax_evaluate(jax_apply, tree, jnp.asarray(x),
                              jnp.asarray(y), jnp.asarray(n_valid)))
    got = float(evaluate(femnist_mlp_apply,
                         params_from_jax(tree, device="cpu"),
                         torch.as_tensor(x), torch.as_tensor(y).long(),
                         torch.as_tensor(n_valid)))
    assert want > 0.3
    assert abs(got - want) <= 1e-6
