"""The reference's remaining public names, each against its counterpart in
the port: `core/timing.lm_hardware_model`,
`orbits/propagation.sat_to_sat_range_m`,
`core/client.make_batched_client_update`, `kernels/ops.fedagg_pytree` and
`prox_sgd_pytree` (plain versions here, at `tests/test_kernels.py`'s
tolerances), `kernels/ref.attention_ref`, `models/femnist_cnn.count_params`,
`models/lm/scan_core.reference_scan` and `models/lm/layers.causal_mask`
(1e-5 elsewhere).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.client import make_batched_client_update as jax_batched
from repro.core.timing import lm_hardware_model as jax_lm_hw
from repro.kernels.ops import fedagg_pytree as jax_fedagg_pytree
from repro.kernels.ops import prox_sgd_pytree as jax_prox_pytree
from repro.kernels.ref import attention_ref as jax_attention_ref
from repro.models.femnist_cnn import count_params as jax_count_params
from repro.models.femnist_cnn import femnist_cnn_init as jax_cnn_init
from repro.models.femnist_mlp import femnist_mlp_apply as jax_apply
from repro.models.femnist_mlp import femnist_mlp_init as jax_init
from repro.models.lm.layers import causal_mask as jax_causal_mask
from repro.models.lm.scan_core import reference_scan as jax_reference_scan
from repro.orbits import WalkerStar as JaxWalkerStar
from repro.orbits.constants import R_EARTH
from repro.orbits.propagation import eci_positions as jax_eci
from repro.orbits.propagation import sat_to_sat_range_m as jax_sat_range
from repro_torch.core.client import make_batched_client_update
from repro_torch.core.timing import lm_hardware_model
from repro_torch.kernels.ops import fedagg_pytree, prox_sgd_pytree
from repro_torch.kernels.ref import attention_ref
from repro_torch.models.femnist_cnn import count_params
from repro_torch.models.femnist_mlp import femnist_mlp_apply
from repro_torch.models.lm.layers import causal_mask
from repro_torch.models.lm.scan_core import reference_scan
from repro_torch.orbits.propagation import sat_to_sat_range_m
from repro_torch.params import FEMNIST_CNN, params_from_jax, \
    params_to_numpy
from torch_parity import replay_indices

TOL = {"float32": 2e-5, "bfloat16": 2e-2}      # tests/test_kernels.py


def _pair(x: np.ndarray, dtype: str):
    """The same float32 values in both packages, each cast to `dtype`
    (round to nearest even on both sides)."""
    return (jnp.asarray(x, jnp.float32).astype(dtype),
            torch.as_tensor(x, dtype=torch.float32).to(getattr(torch, dtype)))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


# --------------------------------------------------------------------- #
# core/timing.lm_hardware_model
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("kw", [
    dict(n_params=2_506_172_416, flops_per_step=1.5e13),
    dict(n_params=7_241_732_096, flops_per_step=4.5e13, steps_per_epoch=32,
         bytes_per_param=2),
    dict(n_params=1000, flops_per_step=1e6, gflops=40.0, link_mbps=100.0),
])
def test_lm_hardware_model_matches_reference(kw):
    mine, ref = lm_hardware_model(**kw), jax_lm_hw(**kw)
    for f in dataclasses.fields(ref):
        assert getattr(mine, f.name) == getattr(ref, f.name), f.name
    assert (mine.epoch_time_s, mine.tx_time_s, mine.round_trip_bytes) == \
        (ref.epoch_time_s, ref.tx_time_s, ref.round_trip_bytes)


# --------------------------------------------------------------------- #
# orbits/propagation.sat_to_sat_range_m
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("clusters,sats", [(2, 5), (3, 4)])
def test_sat_to_sat_range_matches_reference(clusters, sats):
    cst = JaxWalkerStar(clusters, sats)
    t = jnp.linspace(0.0, 6 * 3600.0, 240)
    pos = np.array(jax_eci(cst.elements(), t), np.float32)       # (K, T, 3)
    want = np.asarray(jax_sat_range(jnp.asarray(pos)))
    got = sat_to_sat_range_m(torch.as_tensor(pos)).numpy()
    assert got.shape == want.shape == (cst.n_sats, cst.n_sats, 240)
    assert got.dtype == np.float32
    # The closest approach of each segment, in float64: a flip of the
    # line-of-sight test is allowed only within 50 m of the pad.
    p = pos.astype(np.float64)
    diff = p[None] - p[:, None]
    a = np.broadcast_to(p[:, None], diff.shape)
    tt = np.clip(-np.einsum("kjtc,kjtc->kjt", a, diff)
                 / np.maximum(np.einsum("kjtc,kjtc->kjt", diff, diff), 1.0),
                 0.0, 1.0)
    min_r = np.linalg.norm(a + tt[..., None] * diff, axis=-1)
    tie = np.abs(min_r - (R_EARTH + 100e3)) <= 50.0
    flips = np.isinf(got) != np.isinf(want)
    assert not np.any(flips & ~tie)
    both = np.isfinite(got) & np.isfinite(want)
    assert both.any() and np.isinf(want).any()
    np.testing.assert_allclose(got[both], want[both], rtol=1e-5, atol=1e-5)


def test_sat_to_sat_range_diagonal_and_symmetry():
    pos = np.array(jax_eci(JaxWalkerStar(1, 6).elements(),
                            jnp.linspace(0.0, 3600.0, 16)), np.float32)
    got = sat_to_sat_range_m(torch.as_tensor(pos))
    assert torch.all(torch.diagonal(got, dim1=0, dim2=1) == 0)
    finite = torch.isfinite(got)
    assert torch.equal(finite, finite.transpose(0, 1))


# --------------------------------------------------------------------- #
# core/client.make_batched_client_update
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("mu", [0.0, 0.1])
def test_make_batched_client_update_matches_reference(mu):
    rng = np.random.default_rng(5)
    C, N, bound, B, lr = 4, 40, 6, 8, 0.05
    x = rng.normal(size=(C, N, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 47, (C, N)).astype(np.int32)
    n = np.array([40, 0, 17, 33], np.int32)
    steps = np.array([6, 0, 3, 5], np.int32)
    base = jax.device_get(jax_init(jax.random.PRNGKey(0)))
    stacked = jax.tree.map(lambda a: np.broadcast_to(a, (C,) + a.shape),
                           base)
    rngs = jax.random.split(jax.random.PRNGKey(9), C)
    want = jax_batched(jax_apply, lr=lr, batch_size=B, max_steps=bound)(
        stacked, base, jnp.asarray(x), jnp.asarray(y), jnp.asarray(n),
        jnp.asarray(steps), mu, rngs)
    mine = make_batched_client_update(femnist_mlp_apply, lr=lr,
                                      batch_size=B, max_steps=bound)
    idx = torch.as_tensor(replay_indices(rngs, n, bound, B))
    got = mine(params_from_jax(stacked, device="cpu"),
               params_from_jax(base, device="cpu"), torch.as_tensor(x),
               torch.as_tensor(y).long(), steps.tolist(), mu, idx)
    for a, b in zip(jax.tree.leaves(params_to_numpy(got)),
                    jax.tree.leaves(jax.device_get(want))):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------- #
# kernels/ops.fedagg_pytree and prox_sgd_pytree (plain versions on CPU)
# --------------------------------------------------------------------- #
def _tree(rng, lead: tuple[int, ...], dtype: str):
    shapes = {"b": (7,), "a": (3, 5), "c": {"w": (4, 2), "z": (11,)}}

    def make(node):
        if isinstance(node, dict):
            return {k: make(v) for k, v in node.items()}
        return _pair(rng.normal(size=lead + node).astype(np.float32), dtype)

    both = make(shapes)
    split = lambda i: jax.tree.map(lambda p: p[i], both,
                                   is_leaf=lambda v: isinstance(v, tuple))
    return split(0), split(1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fedagg_pytree_matches_reference(dtype):
    rng = np.random.default_rng(11)
    jt, tt = _tree(rng, (5,), dtype)
    w = rng.random(5).astype(np.float32)
    w /= w.sum()
    want = jax_fedagg_pytree(jt, jnp.asarray(w))
    got = fedagg_pytree(tt, torch.as_tensor(w))
    assert list(got) == list(tt)             # the caller's key order
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == getattr(torch, dtype)
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(_np(a), _np(b), rtol=TOL[dtype],
                                   atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prox_sgd_pytree_matches_reference(dtype):
    rng = np.random.default_rng(12)
    (jp, tp), (jg, tg), (ja, ta) = (_tree(rng, (), dtype) for _ in range(3))
    want = jax_prox_pytree(jp, jg, ja, 0.05, 0.1)
    before = [l.clone() for l in jax.tree.leaves(tp)]
    got = prox_sgd_pytree(tp, tg, ta, 0.05, 0.1)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == getattr(torch, dtype)
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(_np(a), _np(b), rtol=TOL[dtype],
                                   atol=TOL[dtype])
    # A new tree: the inputs keep their values.
    assert all(torch.equal(a, b) for a, b in
               zip(before, jax.tree.leaves(tp)))


# --------------------------------------------------------------------- #
# kernels/ref.attention_ref
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("causal,window,softcap",
                         [(True, None, None), (True, 5, None),
                          (False, None, 20.0), (True, 3, 10.0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_ref_matches_reference(causal, window, softcap, dtype):
    rng = np.random.default_rng(13)
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(rng.normal(size=s).astype(np.float32), dtype)
        for s in ((2, 4, 12, 16), (2, 2, 12, 16), (2, 2, 12, 16)))
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = jax_attention_ref(jq, jk, jv, **kw)
    got = attention_ref(tq, tk, tv, **kw)
    assert got.dtype == tq.dtype and tuple(got.shape) == want.shape
    tol = 1e-5 if dtype == "float32" else TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


# --------------------------------------------------------------------- #
# models/femnist_cnn.count_params, scan_core.reference_scan, causal_mask
# --------------------------------------------------------------------- #
def test_count_params_matches_reference():
    tree = jax.device_get(jax_cnn_init(jax.random.PRNGKey(0)))
    flat = params_from_jax(tree, FEMNIST_CNN, device="cpu")
    assert count_params(FEMNIST_CNN.views(flat)) == jax_count_params(tree) \
        == count_params(params_to_numpy(flat, FEMNIST_CNN)) == 47_887
    assert count_params(flat) == 47_887


@pytest.mark.parametrize("T", [1, 9, 24])
def test_reference_scan_matches_reference(T):
    rng = np.random.default_rng(T)
    B, H, K, V = 2, 3, 8, 6
    r, k = (rng.normal(size=(B, H, T, K)).astype(np.float32)
            for _ in range(2))
    v = rng.normal(size=(B, H, T, V)).astype(np.float32)
    logw = -np.exp(rng.normal(size=(B, H, T, K))).astype(np.float32)
    s0 = rng.normal(size=(B, H, K, V)).astype(np.float32)
    u = rng.normal(size=(H, K)).astype(np.float32)
    want_o, want_s = jax_reference_scan(*(jnp.asarray(a) for a in
                                          (r, k, v, logw, s0, u)))
    got_o, got_s = reference_scan(*(torch.as_tensor(a) for a in
                                    (r, k, v, logw, s0, u)))
    assert tuple(got_o.shape) == want_o.shape == (B, H, T, V)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", [None, 1, 4])
def test_causal_mask_matches_reference(window):
    q = np.array([[3, 4, 5, 6], [0, 1, 2, 3]])
    k = np.arange(7)[None].repeat(2, 0)
    want = np.asarray(jax_causal_mask(jnp.asarray(q), jnp.asarray(k), window))
    got = causal_mask(torch.as_tensor(q), torch.as_tensor(k), window)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
