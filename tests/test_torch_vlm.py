"""The port's prefix embeddings (llava-next-mistral-7b) vs the JAX
reference, on the CPU.

Both packages get the same numpy inputs (the stubbed vision tower's patch
embeddings, tokens) and weights (the reference's init carried across with
`lm_params_from_jax`), on reduced llava-next-mistral-7b: 2 layers, d 256,
4 query heads on 4 KV heads of 64, 16 prefix embeddings, a 128-token
window. The prefix goes before the text at positions 0..P-1 and carries
no loss. `_embed` with a prefix and a position offset and the training
logits within 1e-5; prefill and 8 greedy decode steps within 1e-4 with
identical tokens, with a text long enough that prefix + text passes the
window (the ring-aligned cache branch); the loss within 1e-5 and every
gradient leaf within 1e-5 + 1e-4 relative of `jax.grad`; the full-width
parameter count equal to the reference's.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.lm import transformer as jtf
from repro.train import step as jax_step
from repro.train.step import make_serve_step as jax_make_serve_step
from repro_torch.configs import get_config
from repro_torch.launch import train
from repro_torch.models.lm import transformer
from repro_torch.models.lm.params import (
    lm_params_from_jax,
    lm_params_to_numpy,
    map_tree,
    tree_leaves,
)
from repro_torch.train import step
from repro_torch.train.step import make_prefill_step, make_serve_step

TOL = 1e-5
ARCH = "llava-next-mistral-7b"


def _cfgs(arch: str = ARCH):
    return get_config(arch).reduced(), jax_get_config(arch).reduced()


def _close(got: torch.Tensor, want, tol: float = TOL) -> None:
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@functools.lru_cache(maxsize=None)
def _jax_tree(arch: str = ARCH):
    _, jcfg = _cfgs(arch)
    return jax.device_get(jax.jit(jtf.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0)))


def _prefix(seed: int, B: int = 2, P: int | None = None):
    cfg, _ = _cfgs()
    P = P or cfg.n_prefix_tokens
    return np.random.default_rng(seed).normal(
        size=(B, P, cfg.d_model)).astype(np.float32)


# ------------------------------------------------------------ embedding
@pytest.mark.parametrize("arch", [ARCH, "whisper-medium"])
@pytest.mark.parametrize("offset", [0, 37])
def test_embed_with_prefix_and_offset_matches(arch, offset):
    """The prefix first, then the text's embeddings, at positions offset +
    0..S-1 (whisper's sinusoidal table added, rounded once to the model's
    dtype; llava's positions go to RoPE instead)."""
    cfg, jcfg = _cfgs(arch)
    tree = _jax_tree(arch)
    toks = np.random.default_rng(offset).integers(0, cfg.vocab_size, (2, 9),
                                                  dtype=np.int32)
    pre = _prefix(offset, P=5)
    x, pos = transformer._embed(cfg, lm_params_from_jax(tree, "cpu"),
                                torch.as_tensor(toks).long(),
                                torch.as_tensor(pre), pos_offset=offset)
    jx, jpos = jtf._embed(jcfg, tree, jnp.asarray(toks), jnp.asarray(pre),
                          pos_offset=offset)
    assert x.shape == (2, 14, cfg.d_model)
    _close(x, jx)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))


def test_bf16_sinusoidal_table_is_rounded_once():
    """In bf16 the f32 table is rounded to bf16 and then added (two
    roundings in all), as the reference's `.astype(x.dtype)`; adding it
    in f32 would round once."""
    import dataclasses
    cfg = dataclasses.replace(_cfgs("whisper-medium")[0], dtype="bfloat16")
    x = torch.full((1, 300, cfg.d_model), 0.0123, dtype=torch.bfloat16)
    pos = torch.arange(300)
    table = transformer._sinusoidal(pos, cfg.d_model)
    got = transformer._add_sinusoidal(cfg, x, pos)
    assert torch.equal(got, x + table.to(torch.bfloat16))
    assert not torch.equal(got, (x.float() + table).to(torch.bfloat16))


# ----------------------------------------------------------- whole model
def test_full_width_count_matches_reference():
    """7,241,732,096 params at the published widths, the reference's
    `eval_shape` count (the port's tree built with fake tensors)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    jcfg = jax_get_config(ARCH)
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jax.eval_shape(
        lambda: jtf.init_params(jcfg, jax.random.PRNGKey(0)))))
    init = torch.nn.init.trunc_normal_
    torch.nn.init.trunc_normal_ = lambda w, *a, **k: w
    try:
        with FakeTensorMode():
            got = transformer.count_params(transformer.init_params(
                get_config(ARCH), torch.Generator().manual_seed(0), "cpu"))
    finally:
        torch.nn.init.trunc_normal_ = init
    assert got == want == 7_241_732_096


def test_forward_train_logits_match():
    """Logits for every position, the prefix's too (P + S of them)."""
    cfg, jcfg = _cfgs()
    tree = _jax_tree()
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 33),
                                             dtype=np.int32)
    pre = _prefix(5)
    logits, _ = transformer.forward_train(
        cfg, lm_params_from_jax(tree, "cpu"), torch.as_tensor(toks).long(),
        prefix_embeds=torch.as_tensor(pre))
    jlogits, _ = jtf.forward_train(jcfg, tree, jnp.asarray(toks),
                                   prefix_embeds=jnp.asarray(pre))
    assert logits.shape == (2, 16 + 33, cfg.vocab_size)
    _close(logits, jlogits)


def _grads(cfg, params, batch):
    leaves = []
    map_tree(lambda p: leaves.append(p.requires_grad_(True)), params)
    loss, metrics = step.lm_loss(cfg, params, batch)
    grads = iter(torch.autograd.grad(loss, leaves))
    for p in leaves:
        p.requires_grad_(False)
    return loss.detach(), metrics, map_tree(lambda _: next(grads), params)


@pytest.mark.parametrize("seq", [33, 130])
def test_loss_metrics_and_grads_match_reference(seq):
    """The loss over the text positions only, and each metric, within
    1e-5; every gradient leaf within atol 1e-5 + rtol 1e-4 of jax.grad;
    at 130 text tokens prefix + text passes the 128-token window."""
    cfg, jcfg = _cfgs()
    tree = _jax_tree()
    toks = np.random.default_rng(seq).integers(0, cfg.vocab_size, (2, seq),
                                               dtype=np.int32)
    pre = _prefix(seq)
    (jloss, jmetrics), jgrads = jax.value_and_grad(
        lambda p: jax_step.lm_loss(jcfg, p, {
            "tokens": jnp.asarray(toks), "prefix_embeds": jnp.asarray(pre)}),
        has_aux=True)(tree)
    loss, metrics, grads = _grads(cfg, lm_params_from_jax(tree, "cpu"), {
        "tokens": torch.as_tensor(toks).long(),
        "prefix_embeds": torch.as_tensor(pre)})
    assert sorted(metrics) == sorted(jmetrics)
    for k in metrics:
        assert abs(float(metrics[k].detach()) - float(jmetrics[k])) <= TOL, k
    assert abs(float(loss) - float(jloss)) <= TOL
    gl = tree_leaves(lm_params_to_numpy(grads))
    wl = jax.tree.leaves(jax.device_get(jgrads))
    assert len(gl) == len(wl)
    for a, b in zip(gl, wl):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert (np.abs(a - b) <= 1e-5 + 1e-4 * np.abs(b)).all(), \
            float(np.abs(a - b).max())


@functools.lru_cache(maxsize=None)
def _jax_steps(max_seq: int):
    _, jcfg = _cfgs()
    return (jax.jit(lambda p, t, e: jtf.prefill(jcfg, p, t, max_seq,
                                                prefix_embeds=e)),
            jax.jit(jax_make_serve_step(jcfg)))


@pytest.mark.parametrize("text_len", [20, 130])
def test_reduced_llava_prefill_and_decode_match(text_len):
    """Prefill of 16 prefix embeddings + the text, then 8 greedy decode
    steps from position P + S on: logits within 1e-4, identical tokens,
    the caches within 1e-4. At 130 text tokens (146 positions) the
    128-slot window cache keeps the last 128, ring-aligned."""
    cfg, _ = _cfgs()
    P = cfg.n_prefix_tokens
    max_seq = P + text_len + 16
    jprefill, jstep = _jax_steps(max_seq)
    tree = _jax_tree()
    params = lm_params_from_jax(tree, "cpu")
    prompts = np.random.default_rng(text_len).integers(
        0, cfg.vocab_size, (2, text_len), dtype=np.int32)
    pre = _prefix(text_len)
    jlogits, jcache = jprefill(tree, jnp.asarray(prompts), jnp.asarray(pre))
    logits, cache = make_prefill_step(cfg, max_seq)(params, {
        "tokens": torch.as_tensor(prompts, dtype=torch.int64),
        "prefix_embeds": torch.as_tensor(pre)})
    _close(logits, jlogits, 1e-4)
    assert cache["pos"] == P + text_len == int(jcache["pos"])
    assert cache["segments"][0]["k"].shape[2] == min(max_seq, 128)
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
        assert sorted(got) == sorted(want) == ["k", "v"]
        for name in want:
            _close(got[name], want[name], 1e-4)


def test_init_decode_cache_serves_a_prefix():
    """`init_decode_cache(..., prompt=, prefix_embeds=)` and the serve
    step, the entry points that serve a prefix: the same logits as
    `prefill` from the same inputs, and the decode position after the
    prefix."""
    cfg, _ = _cfgs()
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu")
    prompts = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 10))).long()
    pre = torch.as_tensor(_prefix(1))
    logits, cache = transformer.init_decode_cache(
        cfg, params, 2, 40, prompt=prompts, prefix_embeds=pre)
    want, _ = transformer.prefill(cfg, params, prompts, 40,
                                  prefix_embeds=pre)
    assert torch.equal(logits, want) and cache["pos"] == 26
    tok = torch.argmax(logits, -1)[:, None]
    tok, logits, cache = make_serve_step(cfg)(params, tok, cache)
    assert cache["pos"] == 27 and bool(torch.isfinite(logits).all())


def test_train_launcher_runs_llava_on_cpu():
    """`train.main` adds zero prefix embeddings to each batch, as the
    reference's launcher; the loss covers the text only."""
    out = train.main(["--arch", ARCH, "--device", "cpu", "--steps", "2",
                      "--batch", "2", "--seq", "17"])
    assert len(out["losses"]) == 2
    assert all(np.isfinite(out["losses"]))
    cfg, _ = _cfgs()
    stub = train.stub_embeds(cfg, 3, "cpu")
    assert list(stub) == ["prefix_embeds"]
    assert stub["prefix_embeds"].shape == (3, 16, cfg.d_model)
    assert not bool(stub["prefix_embeds"].any())
