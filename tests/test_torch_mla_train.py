"""Training deepseek-v3's MLA at its published head and latent widths: the
port against the JAX reference's `jax.grad`, on the CPU.

The model is deepseek-v3 with every MLA width as published (nope 128,
rope 64, v 128: heads of (D, Dv) = (192, 128); q / kv latents of 1536 /
512) and narrow elsewhere: d_model 256, 2 heads, 2 dense layers, d_ff
512, vocab 512, with its untied head and MTP head. Both packages get the
reference's init, carried across with `lm_params_from_jax`; the port's
attention runs the `flash_attention` kernel's plain versions (CPU
tensors), forward and backward at (192, 128).

- f32: the loss and each metric within 1e-5, every gradient leaf within
  atol 1e-5 + rtol 1e-4 of `jax.grad` (the bound of
  `test_torch_mla.py::test_loss_metrics_and_grads_match_reference`).
- bf16: the weights rounded to bf16 go to both packages in bf16, and
  each package's bf16 gradient is held against the reference's f32
  `jax.grad` of the same weights. A leaf's distance is max |g - g_f32|
  over max |g_f32|; the port's must be within BF16_SLACK times the
  reference's own. The port's attention keeps its scores in f32 where
  the reference's jnp attention rounds them to bf16, so the port is not
  expected to match the reference's bf16 gradient more closely than
  either matches the f32 one.
- The bf16 tree crosses the packages bit for bit.
- The attention's inputs at these widths are what the card's kernels
  take without a copy: rows of q, k, v, o and dO on 16 bytes, lse dense
  f32.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.lm.config import Segment as JaxSegment
from repro.models.lm.transformer import init_params as jax_init_params
from repro.train import step as jax_step
from repro_torch.configs import get_config
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import _aligned
from repro_torch.models.lm.config import Segment
from repro_torch.models.lm.params import (
    lm_params_from_jax,
    lm_params_to_numpy,
    map_tree,
    tree_leaves,
)
from repro_torch.train import step

ARCH = "deepseek-v3-671b"
TOL = 1e-5
# The port's bf16 gradient distance from the f32 gradient, at most this
# many times the reference's own (as chip_smoke's F64_SLACK).
BF16_SLACK = 2.0
NARROW = dict(n_layers=2, d_model=256, n_heads=2, n_kv_heads=2, d_ff=512,
              vocab_size=512)


def _cfgs(dtype: str):
    """deepseek-v3 at its published MLA widths, narrow elsewhere, in both
    packages."""
    return tuple(dataclasses.replace(
        get(ARCH), name=f"{ARCH}-mla-widths", segments=(seg("attn", 2),),
        dtype=dtype, **NARROW)
        for get, seg in ((get_config, Segment),
                         (jax_get_config, JaxSegment)))


@functools.lru_cache(maxsize=None)
def _jax_tree(dtype: str):
    _, jcfg = _cfgs(dtype)
    return jax.device_get(jax.jit(jax_init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0)))


def _tokens(seq: int) -> np.ndarray:
    return np.random.default_rng(seq).integers(0, NARROW["vocab_size"],
                                               (2, seq), dtype=np.int32)


def _jax_grads(jcfg, tree, toks):
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: jax_step.lm_loss(jcfg, p, {"tokens": jnp.asarray(toks)}),
        has_aux=True)(tree)
    return loss, metrics, jax.tree.leaves(jax.device_get(grads))


def _port_grads(cfg, params, toks):
    leaves = []
    map_tree(lambda p: leaves.append(p.requires_grad_(True)), params)
    loss, metrics = step.lm_loss(cfg, params,
                                 {"tokens": torch.as_tensor(toks).long()})
    grads = iter(torch.autograd.grad(loss, leaves))
    for p in leaves:
        p.requires_grad_(False)
    grads = map_tree(lambda _: next(grads), params)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_leaves(lm_params_to_numpy(grads)))


def test_init_has_the_published_mla_widths():
    """(192, 128) heads and the published latents, the reference's leaves
    leaf for leaf."""
    cfg, _ = _cfgs("float32")
    mla = cfg.mla
    assert (mla.nope_head_dim + mla.rope_head_dim, mla.v_head_dim,
            mla.q_lora_rank, mla.kv_lora_rank) == (192, 128, 1536, 512)
    tree = _jax_tree("float32")
    params = lm_params_from_jax(tree, "cpu")
    assert params["segments"][0]["mla"]["wq_b"].shape == (2, 1536, 2 * 192)
    assert params["segments"][0]["mla"]["wv_b"].shape == (2, 512, 2 * 128)
    assert [a.shape for a in tree_leaves(lm_params_to_numpy(params))] == \
        [a.shape for a in jax.tree.leaves(tree)]


@pytest.mark.parametrize("seq", [33, 130])
def test_f32_loss_metrics_and_grads_match_reference(seq):
    """The loss and each metric (ce, moe_aux, mtp, loss) within 1e-5 and
    every gradient leaf within atol 1e-5 + rtol 1e-4 of jax.grad, the
    attention's gradient through the plain flash backward at (192, 128)
    (130 tokens: a ragged tail past two 64-row tiles)."""
    cfg, jcfg = _cfgs("float32")
    tree = _jax_tree("float32")
    toks = _tokens(seq)
    jloss, jmetrics, want = _jax_grads(jcfg, tree, toks)
    loss, metrics, got = _port_grads(cfg, lm_params_from_jax(tree, "cpu"),
                                     toks)
    assert sorted(metrics) == sorted(jmetrics) == ["ce", "loss", "moe_aux",
                                                   "mtp"]
    for k in metrics:
        assert abs(float(metrics[k]) - float(jmetrics[k])) <= TOL, k
    assert abs(float(loss) - float(jloss)) <= TOL
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape
        assert (np.abs(a - b) <= 1e-5 + 1e-4 * np.abs(b)).all(), \
            float(np.abs(a - b).max())


def _distance(g, g32: np.ndarray) -> float:
    """max |g - g32| over max |g32|."""
    g = np.asarray(g, np.float64)
    return float(np.abs(g - g32).max() / np.abs(g32).max())


def test_bf16_grads_as_close_to_f32_as_the_reference():
    """bf16 weights in both packages: the port's bf16 gradient of each
    leaf within BF16_SLACK times the reference's own bf16 distance from
    the f32 jax.grad of the same weights; the losses within the bf16
    loss's own rounding of each other."""
    cfg, jcfg = _cfgs("bfloat16")
    _, jcfg32 = _cfgs("float32")
    tree = _jax_tree("bfloat16")
    assert all(a.dtype.name == "bfloat16" for a in jax.tree.leaves(tree))
    toks = _tokens(65)
    loss32, _, exact = _jax_grads(
        jcfg32, jax.tree.map(lambda a: np.asarray(a, np.float32), tree),
        toks)
    jloss, _, jgot = _jax_grads(jcfg, tree, toks)
    loss, _, got = _port_grads(cfg, lm_params_from_jax(tree, "cpu"), toks)
    assert all(a.dtype.name == "bfloat16" for a in got)
    exact = [np.asarray(a, np.float64) for a in exact]
    ours = [_distance(a, e) for a, e in zip(got, exact)]
    theirs = [_distance(a, e) for a, e in zip(jgot, exact)]
    worst = [(i, o, t) for i, (o, t) in enumerate(zip(ours, theirs))
             if o > BF16_SLACK * t]
    assert not worst, worst
    # Both bf16 losses within 2^-7 (one bf16 step) of the f32 loss.
    for x in (float(loss), float(jloss)):
        assert abs(x - float(loss32)) <= 2 ** -7 * abs(float(loss32))


def test_bf16_tree_round_trips_bitwise():
    """The reference's bf16 deepseek-v3 tree through lm_params_from_jax
    and lm_params_to_numpy: every leaf's bits, dtype and shape."""
    tree = _jax_tree("bfloat16")
    back = tree_leaves(lm_params_to_numpy(lm_params_from_jax(tree, "cpu")))
    want = jax.tree.leaves(tree)
    assert len(back) == len(want)
    for a, b in zip(back, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint16),
                                      np.asarray(b).view(np.uint16))


def test_bf16_training_passes_the_kernels_aligned_rows(monkeypatch):
    """One bf16 training step: each attention backward gets q, k of 192
    and v, o, dO of 128 whose rows start on 16 bytes (so the card's
    wrapper copies none of them) and a dense f32 lse."""
    cfg, _ = _cfgs("bfloat16")
    params = lm_params_from_jax(_jax_tree("bfloat16"), "cpu")
    seen = []
    plain = ref.flash_attention_bwd_ref

    def record(q, k, v, o, do, *args, lse=None, **kw):
        seen.append(((q, k, v, o, do), lse))
        return plain(q, k, v, o, do, *args, lse=lse, **kw)

    monkeypatch.setattr(ref, "flash_attention_bwd_ref", record)
    _port_grads(cfg, params, _tokens(33))
    assert len(seen) == 2                 # one a layer
    for tensors, lse in seen:
        assert [t.shape[-1] for t in tensors] == [192, 192, 128, 128, 128]
        assert all(t.dtype == torch.bfloat16 and _aligned(t) is t
                   for t in tensors)
        assert lse.dtype == torch.float32 and lse.is_contiguous()
