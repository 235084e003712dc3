"""The port's encoder-decoder (whisper-medium) vs the JAX reference, on the
CPU.

Both packages get the same numpy inputs (frame embeddings, tokens) and
weights (the reference's init carried across with `lm_params_from_jax`),
on reduced whisper-medium: 2 encoder and 2 decoder layers, d 256, 4 heads
of 64, 64 frames, sinusoidal positions, tied embeddings. The reference
computes cross-attention in jnp (`attention_prefill` with keys at
`arange(F)`, no mask); the port through the `flash_attention` kernel's
plain version (CPU tensors) with keys of their own length. Functions
(`_sinusoidal`, `cross_kv`, `encoder_forward`, the plain flash forward at
Sk != S and its backward) and the training logits within 1e-5; prefill
and 8 greedy decode steps within 1e-4 with identical tokens; the loss
within 1e-5 and every gradient leaf within 1e-5 + 1e-4 relative of
`jax.grad`; the full-width parameter count equal to the reference's.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.lm import attention as jattn
from repro.models.lm import transformer as jtf
from repro.train import step as jax_step
from repro.train.step import make_serve_step as jax_make_serve_step
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve, train
from repro_torch.models.lm import attention, transformer
from repro_torch.models.lm.params import (
    lm_params_from_jax,
    lm_params_to_numpy,
    map_tree,
    tree_leaves,
)
from repro_torch.train import step
from repro_torch.train.step import make_prefill_step, make_serve_step

TOL = 1e-5
ARCH = "whisper-medium"


def _cfgs():
    return get_config(ARCH).reduced(), jax_get_config(ARCH).reduced()


def _close(got: torch.Tensor, want, tol: float = TOL) -> None:
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _pair(a):
    a = np.asarray(a, np.float32)
    return jnp.asarray(a), torch.as_tensor(a)


@functools.lru_cache(maxsize=None)
def _jax_tree():
    """The reference's reduced init, with the zero norm scales made random
    so that they show."""
    _, jcfg = _cfgs()
    tree = jax.device_get(jax.jit(jtf.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: (0.1 * rng.normal(size=a.shape)).astype(a.dtype)
        if "norm" in jax.tree_util.keystr(path) else a, tree)


def _frames(seed: int, B: int = 2):
    cfg, _ = _cfgs()
    return np.random.default_rng(seed).normal(
        size=(B, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)


# ------------------------------------------------------------ functions
@pytest.mark.parametrize("offset", [0, 150])
def test_sinusoidal_matches(offset):
    pos = np.arange(offset, offset + 70)
    _close(transformer._sinusoidal(torch.as_tensor(pos), 256),
           jtf._sinusoidal(jnp.asarray(pos), 256))


@pytest.mark.parametrize("S,Sk,h,kv", [(33, 64, 4, 4), (100, 37, 4, 2),
                                       (1, 64, 2, 1)])
def test_flash_ref_with_keys_of_their_own_length_matches(S, Sk, h, kv):
    """Queries at 0..S-1 against keys at 0..Sk-1, no mask: the plain
    forward against the reference's `attention_prefill(q, k, v, qpos,
    arange(Sk), causal=False)`."""
    rng = np.random.default_rng(S + Sk)
    qj, qt = _pair(rng.normal(size=(2, S, h, 64)))
    kj, kt = _pair(rng.normal(size=(2, Sk, kv, 64)))
    vj, vt = _pair(rng.normal(size=(2, Sk, kv, 64)))
    want = jattn.attention_prefill(qj, kj, vj, jnp.arange(S), jnp.arange(Sk),
                                   causal=False)
    got = ref.flash_attention_ref(qt.transpose(1, 2), kt.transpose(1, 2),
                                  vt.transpose(1, 2),
                                  causal=False).transpose(1, 2)
    assert got.shape == (2, S, h, 64)
    _close(got, want)
    _close(attention.attention_prefill(qt, kt, vt, causal=False), want)


@pytest.mark.parametrize("S,Sk", [(33, 64), (70, 45)])
def test_flash_bwd_ref_with_keys_of_their_own_length_matches_autograd(S, Sk):
    """The plain backward's formulas at Sk != S (dk and dv of Sk rows)
    against torch autograd of the plain forward, with the forward's lse
    and recomputing it; and `flash_attention_op`'s backward on the CPU."""
    rng = np.random.default_rng(S * Sk)
    q, k, v = (torch.as_tensor(rng.normal(size=shape).astype(np.float32))
               for shape in ((2, 4, S, 64), (2, 2, Sk, 64), (2, 2, Sk, 64)))
    do = torch.as_tensor(rng.normal(size=(2, 4, S, 64)).astype(np.float32))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(ref.flash_attention_ref(*leaves, causal=False),
                               leaves, do)
    o, lse = ref.flash_attention_ref(q, k, v, causal=False, return_lse=True)
    for saved in (lse, None):
        got = ref.flash_attention_bwd_ref(q, k, v, o, do, causal=False,
                                          lse=saved)
        for a, w in zip(got, want):
            assert a.shape == w.shape
            _close(a, w)
    got = torch.autograd.grad(ops.flash_attention_op(*leaves, causal=False),
                              leaves, do)
    for a, w in zip(got, want):
        _close(a, w)


@pytest.mark.parametrize("causal,window", [(True, None), (False, 16),
                                           (True, 16)])
def test_keys_of_their_own_length_take_no_mask(causal, window):
    q = torch.zeros((1, 8, 2, 64))
    kv = torch.zeros((1, 12, 2, 64))
    with pytest.raises(ValueError, match="no causal or window mask"):
        attention.attention_prefill(q, kv, kv, window=window, causal=causal)


def test_cross_kv_matches():
    cfg, jcfg = _cfgs()
    tree = _jax_tree()
    layer = jax.tree.map(lambda a: a[1], tree["segments"][0]["xattn"])
    enc_j, enc_t = _pair(_frames(3))
    want = jtf.cross_kv(layer, enc_j, jcfg)
    got = transformer.cross_kv(lm_params_from_jax(layer, "cpu"), enc_t, cfg)
    for a, w in zip(got, want):
        assert tuple(a.shape) == w.shape == (2, 64, 4, 64)
        _close(a, w)


def test_encoder_forward_matches():
    """Bidirectional layers over the frames at positions 0..F-1 with the
    sinusoidal table added, then `enc_final_norm`."""
    cfg, jcfg = _cfgs()
    tree = _jax_tree()
    enc_j, enc_t = _pair(_frames(4))
    _close(transformer.encoder_forward(cfg, lm_params_from_jax(tree, "cpu"),
                                       enc_t),
           jtf.encoder_forward(jcfg, tree, enc_j))


# ----------------------------------------------------------- whole model
def test_init_has_the_references_leaves():
    """The encoder, its final norm and each decoder layer's `xattn` and
    `norm_x`, names and shapes as the reference's tree."""
    cfg, _ = _cfgs()
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu")
    mine = tree_leaves(lm_params_to_numpy(params))
    want = jax.tree.leaves(_jax_tree())
    assert [a.shape for a in mine] == [a.shape for a in want]
    assert list(params) == ["embed", "final_norm", "segments", "encoder",
                            "enc_final_norm"]
    assert sorted(params["segments"][0]) == ["attn", "mlp", "norm1", "norm2",
                                             "norm_x", "xattn"]
    assert sorted(params["encoder"]) == ["attn", "mlp", "norm1", "norm2"]
    assert transformer.count_params(params) == sum(a.size for a in want)


def test_full_width_count_matches_reference():
    """757,877,760 params at the published widths, the reference's
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
    assert got == want == 757_877_760


def test_forward_train_logits_match():
    cfg, jcfg = _cfgs()
    tree = _jax_tree()
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 33),
                                             dtype=np.int32)
    enc_j, enc_t = _pair(_frames(5))
    logits, aux = transformer.forward_train(
        cfg, lm_params_from_jax(tree, "cpu"), torch.as_tensor(toks).long(),
        enc_embeds=enc_t)
    jlogits, _ = jtf.forward_train(jcfg, tree, jnp.asarray(toks),
                                   enc_embeds=enc_j)
    assert logits.shape == (2, 33, cfg.vocab_size)
    _close(logits, jlogits)
    assert float(aux["moe_aux"]) == 0.0


def test_forward_train_stacked_runs_the_encoder_per_client():
    """Two clients' weights in one stack, each with its own frames: each
    client's logits are its own `forward_train`'s, and the encoder's and
    cross-attention's launches fold the clients into one batch."""
    cfg, _ = _cfgs()
    trees = [transformer.init_params(cfg, torch.Generator().manual_seed(s),
                                     "cpu") for s in range(2)]
    stack = map_tree(lambda *ts: torch.stack(ts), *trees)
    rng = np.random.default_rng(6)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 3, 20))).long()
    enc = torch.as_tensor(rng.normal(size=(2, 3, 64, cfg.d_model))
                          .astype(np.float32))
    got, _ = transformer.forward_train_stacked(cfg, stack, toks,
                                               enc_embeds=enc)
    for c, tree in enumerate(trees):
        want, _ = transformer.forward_train(cfg, tree, toks[c],
                                            enc_embeds=enc[c])
        _close(got[c], want)


def _grads(cfg, params, batch):
    leaves = []
    map_tree(lambda p: leaves.append(p.requires_grad_(True)), params)
    loss, metrics = step.lm_loss(cfg, params, batch)
    grads = iter(torch.autograd.grad(loss, leaves))
    for p in leaves:
        p.requires_grad_(False)
    return loss.detach(), metrics, map_tree(lambda _: next(grads), params)


def test_loss_metrics_and_grads_match_reference():
    """The loss and each metric within 1e-5; every gradient leaf (the
    encoder's through the non-causal plain backward, each decoder layer's
    cross-attention through the backward at Sk != S) within atol 1e-5 +
    rtol 1e-4 of jax.grad."""
    cfg, jcfg = _cfgs()
    tree = _jax_tree()
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 33),
                                             dtype=np.int32)
    frames = _frames(7)
    (jloss, jmetrics), jgrads = jax.value_and_grad(
        lambda p: jax_step.lm_loss(jcfg, p, {
            "tokens": jnp.asarray(toks), "enc_embeds": jnp.asarray(frames)}),
        has_aux=True)(tree)
    loss, metrics, grads = _grads(cfg, lm_params_from_jax(tree, "cpu"), {
        "tokens": torch.as_tensor(toks).long(),
        "enc_embeds": torch.as_tensor(frames)})
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
                                                enc_embeds=e)),
            jax.jit(jax_make_serve_step(jcfg)))


@pytest.mark.parametrize("prompt_len", [1, 40])
def test_reduced_whisper_prefill_and_decode_match(prompt_len):
    """The encoder once, prefill (each layer's cross K/V cached), then 8
    greedy decode steps against the cached frames: logits within 1e-4,
    identical tokens, every cache (self k / v, cross xk / xv) within
    1e-4."""
    cfg, _ = _cfgs()
    max_seq = prompt_len + 16
    jprefill, jstep = _jax_steps(max_seq)
    tree = _jax_tree()
    params = lm_params_from_jax(tree, "cpu")
    prompts = np.random.default_rng(prompt_len).integers(
        0, cfg.vocab_size, (2, prompt_len), dtype=np.int32)
    frames = _frames(prompt_len)
    jlogits, jcache = jprefill(tree, jnp.asarray(prompts),
                               jnp.asarray(frames))
    logits, cache = make_prefill_step(cfg, max_seq)(params, {
        "tokens": torch.as_tensor(prompts, dtype=torch.int64),
        "enc_embeds": torch.as_tensor(frames)})
    _close(logits, jlogits, 1e-4)
    assert cache["pos"] == prompt_len
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
        assert sorted(got) == sorted(want) == ["k", "v", "xk", "xv"]
        for name in want:
            _close(got[name], want[name], 1e-4)


def test_prefill_launches_the_attention_three_times_a_layer(monkeypatch):
    """One plain-flash call a layer for the encoder (non-causal, 64 frames),
    and for each decoder layer one causal self-attention and one
    cross-attention of the prompt against the frames."""
    cfg, _ = _cfgs()
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu")
    calls = []
    plain = ref.flash_attention_ref

    def count(q, k, v, causal=True, *args, **kw):
        calls.append((q.shape[2], k.shape[2], causal))
        return plain(q, k, v, causal, *args, **kw)

    monkeypatch.setattr(ref, "flash_attention_ref", count)
    transformer.prefill(cfg, params, torch.zeros((2, 12), dtype=torch.int64),
                        20, enc_embeds=torch.zeros((2, 64, cfg.d_model)))
    assert calls == [(64, 64, False)] * 2 + [(12, 12, True),
                                             (12, 64, False)] * 2


def test_serve_and_train_launchers_run_whisper_on_cpu():
    """`serve.main` builds zero frames a batch and passes them as `enc=`;
    `train.main` adds them to each batch: both run reduced whisper on the
    CPU with finite results."""
    done, tokens, logits = serve.main([
        "--arch", ARCH, "--device", "cpu", "--requests", "2", "--batch", "2",
        "--prompt-len", "6", "--max-new", "3"])
    assert tokens.shape == (2, 4) and bool(torch.isfinite(logits).all())
    assert done["requests"] == 2
    out = train.main(["--arch", ARCH, "--device", "cpu", "--steps", "2",
                      "--batch", "2", "--seq", "17"])
    assert len(out["losses"]) == 2
    assert all(np.isfinite(out["losses"]))
