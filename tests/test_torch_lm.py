"""The port's LM serving path vs the JAX reference, on the CPU.

Both packages get the same inputs, made with numpy from a seed, and the
same weights (the reference's `init_params` tree carried across with
`lm_params_from_jax`). Each ported function is held to its counterpart
within 1e-5 in f32; whole reduced models (hymba-1.5b: hybrid attention +
SSD, a full-attention anchor layer and a 128-token window; gemma-2b: MQA,
GeGLU, tied embeddings) to logits within 1e-4 and identical greedy tokens
over a prefill and 8 decode steps, with prompts of 4 tokens and of 160,
which rolls the ring cache of the windowed layer. On the CPU the prefill's
kernels are their plain versions (`tests/test_torch_lm_kernels.py` holds
those to the Pallas kernels).
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
from repro.models.lm import attention as jattn
from repro.models.lm import layers as jlayers
from repro.models.lm import scan_core as jscan
from repro.models.lm import ssm as jssm
from repro.models.lm.transformer import init_params as jax_init_params
from repro.models.lm.transformer import prefill as jax_prefill
from repro.train.step import make_serve_step as jax_make_serve_step
from repro_torch import obs
from repro_torch.configs import get_config, lm_arch_ids
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models.lm import attention, layers, scan_core, ssm
from repro_torch.models.lm.params import lm_params_from_jax, \
    lm_params_to_numpy
from repro_torch.models.lm.transformer import (
    count_params,
    decode_step,
    forward_train,
    init_decode_cache,
    init_params,
    prefill,
)
from repro_torch.train.step import make_prefill_step, make_serve_step

TOL = 1e-5
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _pair(a):
    a = np.asarray(a, np.float32)
    return jnp.asarray(a), torch.as_tensor(a)


def _close(got: torch.Tensor, want, tol: float = TOL) -> None:
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# --------------------------------------------------------------- layers
def test_rmsnorm_matches():
    rng = np.random.default_rng(0)
    (xj, xt), (gj, gt) = _pair(rng.normal(size=(2, 5, 64))), \
        _pair(rng.normal(size=(64,)) * 0.1)
    _close(layers.rmsnorm(xt, gt, 1e-5), jlayers.rmsnorm(xj, gj, 1e-5))


@pytest.mark.parametrize("pos_shape", ["1d", "2d"])
def test_apply_rope_matches(pos_shape):
    rng = np.random.default_rng(1)
    xj, xt = _pair(rng.normal(size=(2, 7, 3, 64)))
    pos = np.arange(150, 157) if pos_shape == "1d" \
        else np.stack([np.arange(7), np.arange(160, 167)])
    _close(layers.apply_rope(xt, torch.as_tensor(pos), 10000.0),
           jlayers.apply_rope(xj, jnp.asarray(pos), 10000.0))


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_apply_mlp_matches(kind):
    rng = np.random.default_rng(2)
    xj, xt = _pair(rng.normal(size=(2, 5, 32)))
    pj, pt = {}, {}
    for name, shape in (("w1", (32, 48)), ("w2", (48, 32)), ("w3", (32, 48))):
        pj[name], pt[name] = _pair(rng.normal(size=shape) * 0.2)
    _close(layers.apply_mlp(pt, xt, kind), jlayers.apply_mlp(pj, xj, kind))


# ------------------------------------------------------------ attention
@pytest.mark.parametrize("h,kv,window,softcap", [
    (4, 2, None, None), (4, 1, 16, None), (2, 2, None, 30.0)])
def test_attention_prefill_matches(h, kv, window, softcap):
    rng = np.random.default_rng(h + kv)
    S = 40
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng.normal(size=(2, S, n, 64))) for n in (h, kv, kv))
    pos = jnp.arange(S)
    want = jattn.attention_prefill(qj, kj, vj, pos, pos, window=window,
                                   softcap=softcap, q_chunk=16)
    got = attention.attention_prefill(qt, kt, vt, window=window,
                                      softcap=softcap)
    assert got.shape == (2, S, h, 64)
    _close(got, want)


@pytest.mark.parametrize("window,pos", [(None, 9), (8, 5), (8, 21)])
def test_attention_decode_and_cache_update_match(window, pos):
    rng = np.random.default_rng(pos)
    slots = window or 24
    (qj, qt) = _pair(rng.normal(size=(2, 1, 4, 64)))
    (ckj, ckt), (cvj, cvt) = (_pair(rng.normal(size=(2, slots, 2, 64)))
                              for _ in range(2))
    (nkj, nkt), (nvj, nvt) = (_pair(rng.normal(size=(2, 1, 2, 64)))
                              for _ in range(2))
    ckj = jattn.cache_update(ckj, nkj, jnp.asarray(pos), window)
    cvj = jattn.cache_update(cvj, nvj, jnp.asarray(pos), window)
    assert attention.cache_update(ckt, nkt, pos, window) is ckt
    attention.cache_update(cvt, nvt, pos, window)
    _close(ckt, ckj, 0.0)
    _close(cvt, cvj, 0.0)
    np.testing.assert_array_equal(
        attention.cache_positions(pos, slots, window, "cpu").numpy(),
        np.asarray(jattn.cache_positions(jnp.asarray(pos), slots, window)))
    want = jattn.attention_decode(qj, ckj, cvj, jnp.asarray(pos),
                                  window=window, softcap=30.0)
    _close(attention.attention_decode(qt, ckt, cvt, pos, window=window,
                                      softcap=30.0), want)


# ------------------------------------------------------------ scan core
@pytest.mark.parametrize("T,chunk", [(64, 16), (50, 16)])
def test_chunked_decay_scan_matches(T, chunk):
    rng = np.random.default_rng(T)
    B, H, K, V = 2, 3, 16, 32
    (rj, rt), (kj, kt), (vj, vt) = (
        _pair(rng.normal(size=(B, H, T, n))) for n in (K, K, V))
    lwj, lwt = _pair(-np.abs(rng.normal(size=(B, H, T, K))) * 0.3)
    sj, st = _pair(rng.normal(size=(B, H, K, V)))
    o, s = scan_core.chunked_decay_scan(rt, kt, vt, lwt, st, chunk=chunk)
    wo, ws = jscan.chunked_decay_scan(rj, kj, vj, lwj, sj, chunk=chunk)
    _close(o, wo)
    _close(s, ws)


def test_decay_scan_step_matches():
    rng = np.random.default_rng(3)
    (rj, rt), (kj, kt), (uj, ut) = (_pair(rng.normal(size=(2, 3, 16)))
                                    for _ in range(3))
    vj, vt = _pair(rng.normal(size=(2, 3, 32)))
    lwj, lwt = _pair(-np.abs(rng.normal(size=(2, 3, 16))))
    sj, st = _pair(rng.normal(size=(2, 3, 16, 32)))
    for u in ((None, None), (uj, ut)):
        o, s = scan_core.decay_scan_step(rt, kt, vt, lwt, st, u[1])
        wo, ws = jscan.decay_scan_step(rj, kj, vj, lwj, sj, u[0])
        _close(o, wo)
        _close(s, ws)


# ------------------------------------------------------------------ ssm
@functools.lru_cache(maxsize=None)
def _ssm_params():
    cfg = jax_get_config("hymba-1.5b").reduced().ssm
    tree = jax.device_get(jax.jit(jssm.init_ssm, static_argnums=(1, 2))(
        jax.random.PRNGKey(4), 128, cfg))
    # Non-trivial norms and biases so every term of the block shows.
    rng = np.random.default_rng(4)
    tree = dict(tree, out_norm=rng.normal(size=tree["out_norm"].shape) * 0.1,
                conv_b=rng.normal(size=tree["conv_b"].shape) * 0.1)
    tree = {k: np.asarray(v, np.float32) for k, v in tree.items()}
    return cfg, tree


@pytest.mark.parametrize("T", [70, 128])
def test_ssm_forward_and_step_match(T):
    cfg, tree = _ssm_params()
    pj = {k: jnp.asarray(v) for k, v in tree.items()}
    pt = lm_params_from_jax(tree, "cpu")
    rng = np.random.default_rng(T)
    xj, xt = _pair(rng.normal(size=(2, T, 128)))
    yj, (sj, tj) = jax.jit(jssm.ssm_forward, static_argnums=2)(pj, xj, cfg)
    yt, (st, tt) = ssm.ssm_forward(pt, xt, cfg)
    _close(yt, yj)
    _close(st, sj)
    _close(tt, tj)
    x1j, x1t = _pair(rng.normal(size=(2, 1, 128)))
    y1j, (s1j, t1j) = jax.jit(jssm.ssm_step, static_argnums=2)(pj, x1j, cfg,
                                                                sj, tj)
    y1t, (s1t, t1t) = ssm.ssm_step(pt, x1t, cfg, st, tt)
    _close(y1t, y1j)
    _close(s1t, s1j)
    _close(t1t, t1j)


# The SSD heads' kernels' plain versions (`ref.ssd_*_ref`): their
# hand-written backward against autograd of the composition they replace
# (the causal conv as shifted adds, softplus, the scan as plain ops, the
# diagonal, the D skip, the gate and the RMSNorm), every input gradient.
def _ssd_composition(xz, dt_raw, bt, ct, conv_w, conv_b, dt_b, a_log, d_skip,
                     out_norm, s0, conv_tail, T: int):
    G, n, E2 = xz.shape
    E, B = E2 // 2, n // T
    H = E // 64
    xs, z = xz.chunk(2, dim=-1)
    xs, _ = ssm._causal_conv(xs.reshape(G, B, T, E), conv_w[:, None, None],
                             conv_b[:, None, None], conv_tail)
    xh = xs.reshape(G * B, T, H, 64)
    u = (dt_raw + dt_b[:, None]).float()
    dt = torch.logaddexp(u, torch.zeros(()))
    logw = (-dt * torch.exp(a_log[:, None])).reshape(G * B, T, H)
    dt = dt.reshape(G * B, T, H)
    b32, c32 = (t.float().reshape(G * B, T, -1) for t in (bt, ct))
    r = c32[:, None] * torch.exp(logw).transpose(1, 2)[..., None]
    k = b32[:, None].expand(G * B, H, T, 16)
    v = (xh.float() * dt[..., None]).transpose(1, 2)
    lw = logw.transpose(1, 2)[..., None].expand(G * B, H, T, 16)
    o, s_final = ops.ref.wkv6_ref(r, k, v, lw, s0)
    o = o.transpose(1, 2) + torch.einsum("btn,btn->bt", c32, b32)[
        ..., None, None] * v.transpose(1, 2)
    o = o.reshape(G, B, T, H, 64) + d_skip[:, None, None, :, None] \
        * xh.float().reshape(G, B, T, H, 64)
    y = o.reshape(G, n, E).to(xz.dtype)
    return layers.rmsnorm(y * torch.nn.functional.silu(z),
                          out_norm[:, None]), s_final


@pytest.mark.parametrize("T,tail", [(64, False), (64, True), (70, False),
                                    (70, True), (2, True)])
def test_ssd_plain_backward_matches_autograd(T, tail):
    """The op's plain path (`ref.ssd_front_ref` / `ssd_back_ref` around the
    plain scan, and the hand-written `ssd_back_bwd_ref` /
    `ssd_front_bwd_ref` around `wkv6_bwd_ref`) against autograd of the
    composition, two clients of two sequences, with and without a conv
    tail, at T a multiple of 64 and not (and T = 2, shorter than the
    tail): outputs and every input gradient within 1e-5 of each one's
    scale (f32, sums in other orders)."""
    G, B, E, H = 2, 2, 128, 2
    rng = np.random.default_rng(T + 10 * tail)
    rnd = lambda *s, scale=1.0: torch.tensor(
        scale * rng.normal(size=s), dtype=torch.float32)
    args = [rnd(G, B * T, 2 * E), rnd(G, B * T, H, scale=0.5),
            rnd(G, B * T, 16, scale=0.3), rnd(G, B * T, 16, scale=0.3),
            rnd(G, 4, E, scale=0.3), rnd(G, E, scale=0.1),
            -2.0 + rnd(G, H, scale=0.3), rnd(G, H, scale=0.5),
            1.0 + rnd(G, H, scale=0.3), rnd(G, E, scale=0.1),
            rnd(G * B, H, 16, 64, scale=0.3),
            rnd(G, B, 3, E) if tail else None]
    leaves = [a.requires_grad_(True) for a in args if a is not None]
    gy, gs = rnd(G, B * T, E), rnd(G * B, H, 16, 64)
    got = ops.ssd_heads_op(*args, seq_len=T, head_dim=64)
    want = _ssd_composition(*args, T)
    for a, w in zip(got, want):
        _close(a, w.detach().numpy(), 1e-5)
    g_got = torch.autograd.grad(got, leaves, (gy, gs))
    g_want = torch.autograd.grad(want, leaves, (gy, gs))
    for a, w in zip(g_got, g_want):
        scale = float(w.abs().max())
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5 * scale)


@pytest.mark.parametrize("T,tail", [(64, False), (70, True)])
def test_ssm_gradients_match_jax_grad(T, tail):
    """`ssm_forward`'s gradients (through the op's plain path) at the
    reduced hymba-1.5b's SSD heads against `jax.grad` of the reference's
    `ssm_forward`: x, every weight, the start state and the conv tail,
    within 1e-4 of each one's scale (f32; the reference differentiates
    its jnp scan, the port the scan's hand-written backward)."""
    cfg, tree = _ssm_params()
    rng = np.random.default_rng(T)
    x = rng.normal(size=(2, T, 128)).astype(np.float32)
    s0 = (0.3 * rng.normal(size=(2, 4, 16, 64))).astype(np.float32)
    tail_np = rng.normal(size=(2, 3, 256)).astype(np.float32) if tail \
        else None
    gy = rng.normal(size=(2, T, 128)).astype(np.float32)
    gs = rng.normal(size=(2, 4, 16, 64)).astype(np.float32)
    names = sorted(tree)

    def jax_loss(p, x, s0, tail_):
        y, (s, _) = jssm.ssm_forward(p, x, cfg, s0, tail_)
        return jnp.sum(y * gy) + jnp.sum(s * gs)

    argnums = (0, 1, 2, 3) if tail else (0, 1, 2)
    want = jax.grad(jax_loss, argnums=argnums)(
        {k: jnp.asarray(v) for k, v in tree.items()}, jnp.asarray(x),
        jnp.asarray(s0), None if tail_np is None else jnp.asarray(tail_np))
    pt = lm_params_from_jax(tree, "cpu")
    leaves = [pt[k].requires_grad_(True) for k in names]
    xt, st = (torch.tensor(a, requires_grad=True) for a in (x, s0))
    tt = None if tail_np is None else torch.tensor(tail_np,
                                                   requires_grad=True)
    y, (s, _) = ssm.ssm_forward(pt, xt, cfg, st, tt)
    loss = (y * torch.tensor(gy)).sum() + (s * torch.tensor(gs)).sum()
    inputs = leaves + [xt, st] + ([tt] if tail else [])
    got = torch.autograd.grad(loss, inputs)
    wants = [want[0][k] for k in names] + list(want[1:])
    for name, a, w in zip(names + ["x", "state", "tail"], got, wants):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(
            a.numpy(), w, rtol=1e-4, atol=1e-4 * float(np.abs(w).max()),
            err_msg=name)


# --------------------------------------------------------------- params
@functools.lru_cache(maxsize=None)
def _jax_init(arch: str, dtype: str = "float32"):
    """The reference's init tree (numpy leaves) for the reduced `arch`
    from PRNGKey(0). The reference draws in f32 and casts every leaf to
    `cfg.dtype`, so the bf16 tree is the f32 one cast."""
    if dtype != "float32":
        return jax.tree.map(lambda a: a.astype(JNP[dtype]),
                            _jax_init(arch))
    cfg = jax_get_config(arch).reduced()
    return jax.device_get(jax.jit(jax_init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0)))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _leaves(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _leaves(v, f"{prefix}/{i}").items()}
    return {prefix: tree}


@pytest.mark.parametrize("arch", ["hymba-1.5b", "gemma-2b", "rwkv6-1.6b",
                                  "grok-1-314b", "whisper-medium",
                                  "llava-next-mistral-7b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_params_round_trip(arch, dtype):
    tree = _jax_init(arch, dtype)
    params = lm_params_from_jax(tree, "cpu")
    back = lm_params_to_numpy(params)
    want, got = _leaves(tree), _leaves(back)
    assert sorted(got) == sorted(want)
    for name, a in want.items():
        assert got[name].shape == a.shape and got[name].dtype == a.dtype, name
        np.testing.assert_array_equal(got[name].view(np.uint8),
                                      np.asarray(a).view(np.uint8))
    # The port's own init gives the same names, shapes and dtypes.
    port_cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    own = _leaves(init_params(port_cfg, torch.Generator().manual_seed(0),
                              "cpu"))
    assert sorted(own) == sorted(want)
    for name, a in want.items():
        assert tuple(own[name].shape) == a.shape, name
        assert str(own[name].dtype) == f"torch.{a.dtype}", name
    assert count_params(params) == sum(a.size for a in want.values())


def test_init_params_draws_the_reference_distributions():
    cfg = get_config("hymba-1.5b").reduced()
    p = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    w = p["segments"][1]["mlp"]["w1"]             # (1, 256, 512)
    # std * truncated_normal(-2, 2): sd 0.8796 * std, |w| <= 2 * std.
    std = 256 ** -0.5
    assert float(w.abs().max()) <= 2 * std
    assert abs(float(w.std()) / (0.87962566 * std) - 1) < 0.02
    assert abs(float(p["embed"].std()) / 0.02 - 1) < 0.02
    ssm_p = p["segments"][0]["ssm"]
    assert torch.equal(ssm_p["dt_b"], torch.full_like(ssm_p["dt_b"], -2.0))
    assert torch.equal(ssm_p["d_skip"], torch.ones_like(ssm_p["d_skip"]))
    # rwkv6: the time mix's LoRAs at std 0.01, its constant leaves.
    tm = init_params(get_config("rwkv6-1.6b").reduced(),
                     torch.Generator().manual_seed(0),
                     "cpu")["segments"][0]["tm"]
    assert float(tm["tm_w2"].abs().max()) <= 0.02
    assert abs(float(tm["tm_w2"].std()) / (0.87962566 * 0.01) - 1) < 0.02
    assert torch.equal(tm["mu"], torch.full_like(tm["mu"], 0.5))
    assert torch.equal(tm["u"], torch.full_like(tm["u"], 0.1))
    # grok-1: the router at std d_model^-1/2, the experts at fan-in.
    moe_p = init_params(get_config("grok-1-314b").reduced(),
                        torch.Generator().manual_seed(0),
                        "cpu")["segments"][0]["moe"]
    for name, fan_in in (("router", 256), ("w1", 256), ("w2", 256)):
        w, std = moe_p[name], fan_in ** -0.5
        assert float(w.abs().max()) <= 2 * std
        assert abs(float(w.std()) / (0.87962566 * std) - 1) < 0.02, name


# ----------------------------------------------------------- whole model
@functools.lru_cache(maxsize=None)
def _jax_steps(arch: str, max_seq: int):
    cfg = jax_get_config(arch).reduced()
    return (cfg, jax.jit(lambda p, t: jax_prefill(cfg, p, t, max_seq)),
            jax.jit(jax_make_serve_step(cfg)))


@pytest.mark.parametrize("arch", ["hymba-1.5b", "gemma-2b"])
@pytest.mark.parametrize("prompt_len", [4, 160])
def test_reduced_model_prefill_and_decode_match(arch, prompt_len):
    max_seq = 160 + 8 + 8
    jcfg, jprefill, jstep = _jax_steps(arch, max_seq)
    cfg = get_config(arch).reduced()
    tree = _jax_init(arch)
    params = lm_params_from_jax(tree, "cpu")
    prompts = np.random.default_rng(prompt_len).integers(
        0, cfg.vocab_size, (2, prompt_len), dtype=np.int32)

    jlogits, jcache = jprefill(tree, jnp.asarray(prompts))
    logits, cache = make_prefill_step(cfg, max_seq)(
        params, {"tokens": torch.as_tensor(prompts, dtype=torch.int64)})
    _close(logits, jlogits, 1e-4)
    assert cache["pos"] == prompt_len
    jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)[:, None]
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    step = make_serve_step(cfg)
    for _ in range(8):
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        jtok, jlogits, jcache = jstep(tree, jtok, jcache)
        tok, logits, cache = step(params, tok, cache)
        _close(logits, jlogits, 1e-4)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    # The caches agree too (ring slots, SSM state, conv tail).
    for got, want in zip(cache["segments"], jcache["segments"]):
        for name in want:
            _close(got[name], want[name], 1e-4)


def test_decode_step_updates_the_cache_in_place():
    cfg = get_config("gemma-2b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    logits, cache = init_decode_cache(cfg, params, 2, 16)
    assert logits.shape == (2, cfg.vocab_size) and cache["pos"] == 1
    k = cache["segments"][0]["k"]
    before = k.clone()
    _, cache2 = decode_step(cfg, params, torch.zeros((2, 1), dtype=torch.int64),
                            cache)
    assert cache2["pos"] == 2 and cache2["segments"][0]["k"] is k
    assert not torch.equal(k[:, :, 1], before[:, :, 1])


# -------------------------------------------------------------- serving
def test_serve_main_runs_on_cpu():
    ops.reset_launches()
    with obs.tracing():
        done, tokens, logits = serve.main([
            "--arch", "hymba-1.5b", "--device", "cpu", "--requests", "3",
            "--batch", "2", "--prompt-len", "20", "--max-new", "4"])
        summary = obs.metrics_summary()
    cfg = get_config("hymba-1.5b").reduced()
    assert done["event"] == "serve.done" and done["requests"] == 3
    assert tokens.shape == (3, 5) and tokens.dtype == torch.int32
    assert bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all())
    assert logits.shape == (3, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    assert summary["counters"] == {"launch.decode_tokens": 12,
                                   "launch.requests_served": 3}
    assert summary["spans"]["launch.prefill"]["count"] == 2
    assert summary["spans"]["launch.decode"]["count"] == 2
    assert "decode_p50_ms" in done and "decode_p99_ms" in done
    assert all(n == 0 for n in ops.LAUNCHES.values())   # plain versions


def test_serve_batch_returns_every_steps_logits():
    """serve_batch is the prefill step and then `max_new` serve steps: the
    same tokens, and the logits of each step stacked."""
    cfg = get_config("hymba-1.5b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prompts = torch.randint(0, cfg.vocab_size, (2, 12),
                            generator=torch.Generator().manual_seed(1))
    toks, lat_s, logits = serve.serve_batch(cfg, params, prompts, 3)
    assert toks.shape == (2, 4) and lat_s == []
    assert logits.shape == (4, 2, cfg.vocab_size)
    want, cache = make_prefill_step(cfg, 12 + 3 + 8)(params,
                                                     {"tokens": prompts})
    tok = torch.argmax(want, -1).to(torch.int32)[:, None]
    step = make_serve_step(cfg)
    for i in range(4):
        assert torch.equal(toks[:, i:i + 1], tok)
        assert torch.equal(logits[i], want)
        tok, want, cache = step(params, tok, cache)


def test_every_arch_resolves():
    asdict = dataclasses.asdict
    for arch in lm_arch_ids():
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        assert asdict(cfg) == asdict(jcfg), arch
        assert asdict(cfg.reduced()) == asdict(jcfg.reduced()), arch
    # The paper's CNN: the reference's config, naming the port's model.
    from repro_torch.models.femnist_cnn import femnist_cnn_apply, \
        femnist_cnn_init
    cnn, jcnn = get_config("femnist-47k"), jax_get_config("femnist-47k")
    assert {k: v for k, v in cnn.items() if k not in ("init", "apply")} \
        == {k: v for k, v in jcnn.items() if k not in ("init", "apply")}
    assert (cnn["init"], cnn["apply"]) == (femnist_cnn_init,
                                           femnist_cnn_apply)


@pytest.mark.parametrize("arch,what", [
    ("whisper-medium", "encoder"),
])
def test_unported_kinds_raise(arch, what):
    """The enc-dec kind runs (`tests/test_torch_encdec.py` holds it to the
    reference); without its frame embeddings prefill and the training
    forward raise by name, where the reference fails inside its encoder."""
    cfg = get_config(arch).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert what in params and "xattn" in params["segments"][0]
    toks = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="enc_embeds"):
        prefill(cfg, params, toks, 8)
    with pytest.raises(ValueError, match="enc_embeds"):
        forward_train(cfg, params, toks)
    frames = torch.zeros((1, cfg.encoder.n_frames, cfg.d_model))
    logits, cache = prefill(cfg, params, toks, 8, enc_embeds=frames)
    assert logits.shape == (1, cfg.vocab_size) and cache["pos"] == 4
    assert forward_train(cfg, params, toks, enc_embeds=frames)[0].shape \
        == (1, 4, cfg.vocab_size)


def test_prefix_embeds_raise():
    """Prefix embeddings run (`tests/test_torch_vlm.py` holds them to the
    reference): they go before the text and the decode position counts
    them; embeddings of another width than the model's raise."""
    cfg = get_config("llava-next-mistral-7b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="prefix"):
        prefill(cfg, params, toks, 30,
                prefix_embeds=torch.zeros((1, 16, cfg.d_model + 1)))
    logits, cache = prefill(cfg, params, toks, 30,
                            prefix_embeds=torch.zeros((1, 16, cfg.d_model)))
    assert logits.shape == (1, cfg.vocab_size) and cache["pos"] == 20
