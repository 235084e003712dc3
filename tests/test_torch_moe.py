"""The port's routed experts (`models/lm/moe.py`, the `moe` segment kind
on GQA attention, grok-1) vs the JAX reference, on the CPU.

The reference's MoE is pure jnp (its expert products never go through a
Pallas kernel), so its functions are the oracle; the port's attention
runs the flash kernel's plain version (CPU tensors). `_route`'s expert
ids equal and its gates and both aux terms within 1e-5; the dispatch
buffer and its metadata bitwise, with tied expert ids and a capacity
that overflows; `apply_moe` within 1e-5 row-local (S = 64) and global
(S = 8), gelu and swiglu with a shared expert, at capacity factors that
drop tokens; reduced grok-1 prefill and decode within 1e-4 with
identical greedy tokens; the loss with its MoE aux within 1e-5 and every
gradient leaf within 1e-5 + 1e-4 relative of `jax.grad`; a client
stack's losses, each with its own aux, equal to each client's `lm_loss`.
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
from repro.models.lm import moe as jmoe
from repro.models.lm.config import MoEConfig as JaxMoEConfig
from repro.models.lm.transformer import forward_train as jax_forward_train
from repro.models.lm.transformer import init_params as jax_init_params
from repro.models.lm.transformer import prefill as jax_prefill
from repro.train import step as jax_step
from repro.train.step import make_serve_step as jax_make_serve_step
from repro_torch.configs import get_config
from repro_torch.core.workload import lm_layout
from repro_torch.launch import serve, train
from repro_torch.models.lm import moe
from repro_torch.models.lm.config import MoEConfig
from repro_torch.models.lm.params import (
    lm_params_from_jax,
    lm_params_to_numpy,
    map_tree,
    tree_leaves,
)
from repro_torch.models.lm.transformer import (
    forward_train,
    forward_train_stacked,
    init_params,
)
from repro_torch.train import step
from repro_torch.train.step import make_prefill_step, make_serve_step

TOL = 1e-5
ARCH = "grok-1-314b"
D = 64


def _close(got: torch.Tensor, want, tol: float = TOL) -> None:
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _pair(a, dtype=np.float32):
    a = np.asarray(a, dtype)
    return jnp.asarray(a), torch.as_tensor(a)


def _cfgs(E=8, K=2, cf=1.5, n_shared=0):
    kw = dict(n_experts=E, top_k=K, d_ff_expert=96, n_shared=n_shared,
              capacity_factor=cf)
    return MoEConfig(**kw), JaxMoEConfig(**kw)


@functools.lru_cache(maxsize=None)
def _moe_tree(kind: str, E: int, n_shared: int):
    _, jcfg = _cfgs(E, n_shared=n_shared)
    tree = jax.device_get(jmoe.init_moe(jax.random.PRNGKey(E + n_shared), D,
                                        jcfg, kind))
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _trees(tree):
    return (jax.tree.map(jnp.asarray, tree), lm_params_from_jax(tree, "cpu"))


# ---------------------------------------------------------------- route
def test_route_matches():
    cfg, jcfg = _cfgs()
    pj, pt = _trees(_moe_tree("gelu", 8, 0))
    xj, xt = _pair(np.random.default_rng(0).normal(size=(50, D)))
    gj, ij, auxj = jmoe._route(pj, xj, jcfg)
    gt, it, auxt = moe._route(pt, xt, cfg)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    _close(gt, gj)
    for name in ("load_balance", "router_z"):
        assert auxt[name].shape == ()
        _close(auxt[name], auxj[name])


def test_route_breaks_ties_toward_the_lower_expert():
    """With a zero router every expert ties: both packages pick experts 0
    and 1 for every token (lax.top_k's order), with gates of 1/2."""
    cfg, jcfg = _cfgs()
    tree = dict(_moe_tree("gelu", 8, 0))
    tree["router"] = np.zeros_like(tree["router"])
    pj, pt = _trees(tree)
    xj, xt = _pair(np.random.default_rng(1).normal(size=(9, D)))
    _, ij, _ = jmoe._route(pj, xj, jcfg)
    gt, it, _ = moe._route(pt, xt, cfg)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert (it.numpy() == [0, 1]).all() and torch.equal(
        gt, torch.full_like(gt, 0.5))


# ------------------------------------------------------------- dispatch
@pytest.mark.parametrize("C", [2, 5, 40])
def test_dispatch_tokens_is_bitwise(C):
    """Expert ids with many ties (3 experts for 20 tokens x top-2), so
    capacity 2 and 5 overflow and drop tokens (which ones depends on the
    stable sort), 40 keeps all: the buffer, slots, tokens, gates and keep
    mask equal the reference's bit for bit."""
    rng = np.random.default_rng(C)
    E, T, K = 4, 20, 2
    ids = np.stack([rng.permutation(3)[:K] for _ in range(T)]).astype(
        np.int32)
    (xj, xt), (gj, gt) = _pair(rng.normal(size=(T, D))), \
        _pair(rng.uniform(size=(T, K)))
    bj, (slot_j, st_j, sg_j, keep_j) = jmoe._dispatch_tokens(
        xj, gj, jnp.asarray(ids), E, C)
    bt, (slot_t, st_t, sg_t, keep_t) = moe._dispatch_tokens(
        xt[None], gt[None], torch.as_tensor(ids, dtype=torch.int64)[None],
        E, C)
    assert bt.shape == (1, E, C, D)
    np.testing.assert_array_equal(bt[0].numpy(), np.asarray(bj))
    for got, want in ((slot_t, slot_j), (st_t, st_j), (sg_t, sg_j),
                      (keep_t, keep_j)):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))
    assert bool((~keep_t).any()) == (C < 20)


@pytest.mark.parametrize("kind,n_shared", [("gelu", 0), ("swiglu", 1)])
@pytest.mark.parametrize("S", [64, 8])
@pytest.mark.parametrize("cf", [1.0, 8.0])
def test_apply_moe_matches(kind, n_shared, S, cf):
    """Row-local dispatch (S = 64) and one global dispatch (S = 8), at a
    capacity factor that drops tokens (1.0) and one that keeps them all."""
    cfg, jcfg = _cfgs(cf=cf, n_shared=n_shared)
    pj, pt = _trees(_moe_tree(kind, 8, n_shared))
    xj, xt = _pair(np.random.default_rng(S).normal(size=(3, S, D)))
    yj, auxj = jmoe.apply_moe(pj, xj, jcfg, kind)
    yt, auxt = moe.apply_moe(pt, xt, cfg, kind)
    _close(yt, yj)
    for name in auxj:
        _close(auxt[name], auxj[name])


def test_apply_moe_stacked_keeps_each_clients_aux():
    """Three clients through the stacked form: each client's output and
    aux terms equal its own `apply_moe`; nothing is pooled over the
    stack."""
    cfg, _ = _cfgs(cf=1.5, n_shared=1)
    trees = [lm_params_from_jax(_moe_tree("swiglu", 8, 1), "cpu")]
    trees += [map_tree(lambda t, s=s: t * (1 + 0.1 * s), trees[0])
              for s in (1, 2)]
    stacked = map_tree(lambda *ts: torch.stack(ts), *trees)
    x = torch.as_tensor(np.random.default_rng(3).normal(
        size=(3, 2 * 64, D)).astype(np.float32))
    y, aux = moe.apply_moe_stacked(stacked, x, cfg, "swiglu", 64)
    assert aux["load_balance"].shape == aux["router_z"].shape == (3,)
    for g in range(3):
        yg, auxg = moe.apply_moe(trees[g], x[g].view(2, 64, D), cfg,
                                 "swiglu")
        torch.testing.assert_close(y[g], yg.reshape(-1, D), rtol=1e-6,
                                   atol=1e-6)
        for name in auxg:
            torch.testing.assert_close(aux[name][g], auxg[name], rtol=1e-6,
                                       atol=1e-7)


# ----------------------------------------------------------- whole model
@functools.lru_cache(maxsize=None)
def _jax_tree():
    cfg = jax_get_config(ARCH).reduced()
    return jax.device_get(jax.jit(jax_init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _jax_steps(max_seq: int):
    cfg = jax_get_config(ARCH).reduced()
    return (jax.jit(lambda p, t: jax_prefill(cfg, p, t, max_seq)),
            jax.jit(jax_make_serve_step(cfg)))


@pytest.mark.parametrize("prompt_len", [4, 70])
def test_reduced_grok_prefill_and_decode_match(prompt_len):
    """Global dispatch (4-token prompts and every decode step) and
    row-local (70-token prompts); softcapped GQA attention: logits within
    1e-4, identical greedy tokens over 8 decode steps, KV caches within
    1e-4."""
    max_seq = prompt_len + 16
    jprefill, jstep = _jax_steps(max_seq)
    cfg = get_config(ARCH).reduced()
    tree = _jax_tree()
    params = lm_params_from_jax(tree, "cpu")
    prompts = np.random.default_rng(prompt_len).integers(
        0, cfg.vocab_size, (2, prompt_len), dtype=np.int32)
    jlogits, jcache = jprefill(tree, jnp.asarray(prompts))
    logits, cache = make_prefill_step(cfg, max_seq)(
        params, {"tokens": torch.as_tensor(prompts, dtype=torch.int64)})
    _close(logits, jlogits, 1e-4)
    jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)[:, None]
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    serve_step = make_serve_step(cfg)
    for _ in range(8):
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        jtok, jlogits, jcache = jstep(tree, jtok, jcache)
        tok, logits, cache = serve_step(params, tok, cache)
        _close(logits, jlogits, 1e-4)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    for got, want in zip(cache["segments"], jcache["segments"]):
        for name in want:
            _close(got[name], want[name], 1e-4)


def _grads(cfg, params, toks):
    leaves = []
    map_tree(lambda p: leaves.append(p.requires_grad_(True)), params)
    loss, metrics = step.lm_loss(cfg, params, {"tokens": toks})
    grads = iter(torch.autograd.grad(loss, leaves))
    for p in leaves:
        p.requires_grad_(False)
    return loss.detach(), metrics, map_tree(lambda _: next(grads), params)


@pytest.mark.parametrize("seq", [33, 65])
def test_loss_with_moe_aux_and_grads_match_reference(seq):
    """Global (33 tokens) and row-local (65) dispatch: the aux, CE and
    loss within 1e-5, every gradient leaf (the router's through the gates
    and the aux terms) within atol 1e-5 + rtol 1e-4 of jax.grad."""
    cfg, jcfg = get_config(ARCH).reduced(), jax_get_config(ARCH).reduced()
    jp = _jax_tree()
    toks = np.random.default_rng(seq).integers(0, cfg.vocab_size, (2, seq),
                                               dtype=np.int32)
    params = lm_params_from_jax(jp, "cpu")
    _, aux = forward_train(cfg, params, torch.as_tensor(toks).long())
    _, jaux = jax_forward_train(jcfg, jp, jnp.asarray(toks))
    assert aux["moe_aux"].shape == () and float(jaux["moe_aux"]) > 0
    _close(aux["moe_aux"], jaux["moe_aux"])
    (jloss, jmetrics), jgrads = jax.value_and_grad(
        lambda p: jax_step.lm_loss(jcfg, p, {"tokens": jnp.asarray(toks)}),
        has_aux=True)(jp)
    loss, metrics, grads = _grads(cfg, params, torch.as_tensor(toks).long())
    assert sorted(metrics) == sorted(jmetrics)
    for k in metrics:
        assert abs(float(metrics[k].detach()) - float(jmetrics[k])) <= TOL, k
    gl = tree_leaves(lm_params_to_numpy(grads))
    wl = jax.tree.leaves(jax.device_get(jgrads))
    assert len(gl) == len(wl)
    for a, b in zip(gl, wl):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert (np.abs(a - b) <= 1e-5 + 1e-4 * np.abs(b)).all(), \
            float(np.abs(a - b).max())


def test_client_losses_add_each_clients_own_aux():
    """`client_lm_losses` of a 3-client stack (one forward) equals each
    client's own `lm_loss`, MoE aux included; the stacked forward's aux
    is (3,) and each entry is that client's."""
    cfg = get_config(ARCH).reduced()
    layout = lm_layout(cfg)
    trees = [init_params(cfg, torch.Generator().manual_seed(s), "cpu")
             for s in range(3)]
    stack = layout.views(torch.stack([layout.pack(t) for t in trees]))
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (3, 2, 65))).long()
    got = step.client_lm_losses(cfg, stack, toks)
    _, aux = forward_train_stacked(cfg, stack, toks)
    assert aux["moe_aux"].shape == (3,)
    for c, tree in enumerate(trees):
        want, metrics = step.lm_loss(cfg, tree, {"tokens": toks[c]})
        assert abs(float(got[c]) - float(want)) <= TOL
        assert abs(float(aux["moe_aux"][c]) - float(metrics["moe_aux"])) \
            <= 1e-7
    assert len(set(aux["moe_aux"].tolist())) == 3


def test_grok_bf16_init_and_launchers_on_cpu():
    """The bf16 tree has the reference's leaves; the launchers serve and
    train reduced grok-1 on the CPU."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="bfloat16")
    p = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert sorted(p["segments"][0]["moe"]) == ["router", "w1", "w2"]
    assert p["segments"][0]["moe"]["w1"].shape == (2, 4, 256, 256)
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(p))
    done, tokens, logits = serve.main([
        "--arch", ARCH, "--device", "cpu", "--requests", "2", "--batch", "2",
        "--prompt-len", "70", "--max-new", "3"])
    assert done["requests"] == 2 and tokens.shape == (2, 4)
    assert bool(torch.isfinite(logits).all())
    done = train.main(["--arch", ARCH, "--device", "cpu", "--steps", "2",
                       "--batch", "2", "--seq", "65"])
    assert len(done["losses"]) == 2 and np.isfinite(done["losses"]).all()
