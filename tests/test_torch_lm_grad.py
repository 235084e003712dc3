"""The LM kernels' plain backward versions vs autograd and `jax.grad`.

`repro_torch.kernels.ref.flash_attention_bwd_ref` and `wkv6_bwd_ref` are
the backward kernels' own formulas written out in PyTorch (the CPU path
of `ops.flash_attention_op` / `ops.wkv6_op`'s backward, and what
`chip_smoke.py` holds the CUDA backward kernels against). Here each is
held, on the same numpy inputs,
  * against torch autograd of the plain forward (`flash_attention_ref`,
    `wkv6_ref`): atol 1e-5 + rtol 1e-5;
  * against `jax.grad` of the reference's jnp functions (the Pallas
    kernels have no VJP): `attention_prefill` and `chunked_decay_scan`,
    at atol 1e-5 + rtol 1e-4 (the tolerance the LM gradients are held to).
dlogw is the one exception, with its reason: it is a suffix sum over the
whole sequence of q_t - p_t (q = r dr, p = k dk), terms that cancel, so
its rounding scales with those terms and not with the result; its
absolute part is 1e-5 of max |q| + max |p| (at least 1e-5).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.lm.attention import attention_prefill as jax_attention
from repro.models.lm.scan_core import chunked_decay_scan as jax_scan
from repro_torch.kernels import ops, ref


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32))


def _close(got, want, atol: float, rtol: float) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    assert np.isfinite(got).all()
    assert (err <= atol + rtol * np.abs(want)).all(), float(err.max())


FLASH_CASES = [
    # b, h, kv, s, d, causal, window, softcap
    (4, 2, 2, 33, 32, True, None, None),     # lm_tiny: S = 33, D = 32
    (2, 4, 4, 33, 64, True, 128, None),      # lm_hybrid_tiny's window
    (1, 4, 2, 64, 32, True, None, None),     # GQA, S a multiple of the tile
    (1, 4, 1, 70, 64, True, 16, None),       # MQA + window < S
    (1, 2, 2, 40, 32, True, None, 30.0),     # softcap
    (1, 2, 1, 33, 64, False, 8, 5.0),        # bidirectional window + cap
]


def _flash_inputs(b, h, kv, s, d):
    rng = np.random.default_rng(b * s + d)
    q, k, v, g = (rng.normal(size=shape).astype(np.float32) for shape in (
        (b, h, s, d), (b, kv, s, d), (b, kv, s, d), (b, h, s, d)))
    return q, k, v, g


@pytest.mark.parametrize("b,h,kv,s,d,causal,window,softcap", FLASH_CASES)
def test_flash_plain_backward_matches_autograd(b, h, kv, s, d, causal,
                                               window, softcap):
    q, k, v, g = (_t(a) for a in _flash_inputs(b, h, kv, s, d))
    kw = dict(causal=causal, window=window, softcap=softcap)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = ref.flash_attention_ref(*leaves, **kw)
    want = torch.autograd.grad(o, leaves, g)
    got = ref.flash_attention_bwd_ref(q, k, v, o.detach(), g, **kw)
    for a, w in zip(got, want):
        assert a.shape == w.shape and a.dtype == torch.float32
        _close(a, w, 1e-5, 1e-5)


@pytest.mark.parametrize("b,h,kv,s,d,causal,window,softcap", FLASH_CASES)
def test_flash_plain_backward_matches_jax_grad(b, h, kv, s, d, causal,
                                               window, softcap):
    """Against `jax.grad` of the reference's jnp attention (the model's
    (B, S, H, D) layout, positions 0..S-1)."""
    q, k, v, g = _flash_inputs(b, h, kv, s, d)
    pos = jnp.arange(s)

    def f(q, k, v):
        o = jax_attention(q, k, v, pos, pos, window=window, softcap=softcap,
                          causal=causal)
        return jnp.sum(o * jnp.asarray(g).transpose(0, 2, 1, 3))

    tr = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3)
    want = jax.grad(f, argnums=(0, 1, 2))(tr(q), tr(k), tr(v))
    o = ref.flash_attention_ref(_t(q), _t(k), _t(v), causal, window, softcap)
    got = ref.flash_attention_bwd_ref(_t(q), _t(k), _t(v), o, _t(g), causal,
                                      window, softcap)
    for a, w in zip(got, want):
        _close(a.numpy(), np.asarray(w).transpose(0, 2, 1, 3), 1e-5, 1e-4)


@pytest.mark.parametrize("b,h,kv,s,d,causal,window,softcap", FLASH_CASES)
def test_flash_plain_backward_with_saved_lse_matches_recomputing(
        b, h, kv, s, d, causal, window, softcap):
    """Fed the plain forward's lse (as the autograd forward saves it),
    the plain backward gives the bits of the one that recomputes lse, and
    stays within tolerance of `jax.grad`."""
    q, k, v, g = _flash_inputs(b, h, kv, s, d)
    kw = dict(causal=causal, window=window, softcap=softcap)
    o, lse = ref.flash_attention_ref(_t(q), _t(k), _t(v), return_lse=True,
                                     **kw)
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    saved = ref.flash_attention_bwd_ref(_t(q), _t(k), _t(v), o, _t(g),
                                        lse=lse, **kw)
    again = ref.flash_attention_bwd_ref(_t(q), _t(k), _t(v), o, _t(g), **kw)
    assert all(torch.equal(a, w) for a, w in zip(saved, again))
    pos = jnp.arange(s)
    tr = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3)
    want = jax.grad(lambda *x: jnp.sum(jax_attention(
        *x, pos, pos, window=window, softcap=softcap, causal=causal)
        * tr(g)), argnums=(0, 1, 2))(tr(q), tr(k), tr(v))
    for a, w in zip(saved, want):
        _close(a.numpy(), np.asarray(w).transpose(0, 2, 1, 3), 1e-5, 1e-4)


def test_backward_wrappers_raise_on_cpu_tensors():
    """The backward kernels' wrappers take CUDA tensors only (the op
    sends CPU tensors to the plain backward), and say so."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.kernels.wkv6 import wkv6_bwd
    q, k, v, g = (_t(a) for a in _flash_inputs(1, 2, 1, 33, 32))
    o, lse = ref.flash_attention_ref(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention_bwd(q, k, v, o, g, lse)
    r, kk, vv, lw, s0, g, _ = (_t(a) for a in _wkv6_inputs(1, 2, 70, 8, 8,
                                                            "mixed"))
    states = ref.wkv6_ref(r, kk, vv, lw, s0, 16, return_states=True)[2]
    with pytest.raises(ValueError, match="CUDA tensor"):
        wkv6_bwd(r, kk, vv, lw, s0, g, None, states, chunk=16)


def test_flash_op_backward_is_the_plain_backward_on_cpu():
    """On CPU tensors the op's backward is `flash_attention_bwd_ref`, and
    it counts no kernel launch."""
    q, k, v, g = (_t(a) for a in _flash_inputs(2, 4, 2, 33, 32))
    before = dict(ops.LAUNCHES)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = ops.flash_attention_op(*leaves, window=16)
    got = torch.autograd.grad(o, leaves, g)
    want = ref.flash_attention_bwd_ref(q, k, v, o.detach(), g, window=16)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ops.LAUNCHES == before


# ------------------------------------------------------------------ wkv6
WKV6_CASES = [
    # b, h, t, k, v, chunk, decay, end-state gradient
    (2, 3, 33, 16, 64, 64, "ssd", False),     # lm_hybrid_tiny: T < chunk
    (1, 2, 100, 8, 16, 16, "mixed", True),    # T not a multiple of chunk
    (1, 2, 70, 8, 8, 16, "strong", True),     # near-total decay each step
]


def _wkv6_inputs(b, h, t, k, v, decay):
    rng = np.random.default_rng(b * t + k)
    r = rng.normal(size=(b, h, t, k))
    kk = rng.normal(size=(b, h, t, k))
    vv = 0.3 * rng.normal(size=(b, h, t, v))
    if decay == "strong":
        lw = np.full((b, h, t, k), -5.0)
    else:
        lw = -0.3 * np.abs(rng.normal(size=(b, h, t, k)))
    s0 = rng.normal(size=(b, h, k, v))
    g = rng.normal(size=(b, h, t, v))
    gs = rng.normal(size=(b, h, k, v))
    return [a.astype(np.float32) for a in (r, kk, vv, lw, s0, g, gs)]


def _close_wkv6(got, want, r, k, atol: float, rtol: float) -> None:
    """dr, dk, dv, ds0 at atol + rtol; dlogw beside the scale of the terms
    its suffix sum adds (module docstring)."""
    for i, (a, w) in enumerate(zip(got, want)):
        if i == 3:
            terms = float(np.abs(r * np.asarray(want[0])).max()
                          + np.abs(k * np.asarray(want[1])).max())
            _close(a, w, atol * max(terms, 1.0), rtol)
        else:
            _close(a, w, atol, rtol)


@pytest.mark.parametrize("b,h,t,k,v,chunk,decay,end_grad", WKV6_CASES)
def test_wkv6_plain_backward_matches_autograd(b, h, t, k, v, chunk, decay,
                                              end_grad):
    r, kk, vv, lw, s0, g, gs = (_t(a) for a in _wkv6_inputs(b, h, t, k, v,
                                                            decay))
    leaves = [x.clone().requires_grad_(True) for x in (r, kk, vv, lw, s0)]
    o, s_final = ref.wkv6_ref(*leaves, chunk=chunk)
    outs, grads = ((o, s_final), (g, gs)) if end_grad else ((o,), (g,))
    want = torch.autograd.grad(outs, leaves, grads)
    got = ref.wkv6_bwd_ref(r, kk, vv, lw, s0, g, gs if end_grad else None,
                           chunk)
    for a, w in zip(got, want):
        assert a.shape == w.shape and a.dtype == torch.float32
    _close_wkv6([x.numpy() for x in got], [x.numpy() for x in want],
                r.numpy(), kk.numpy(), 1e-5, 1e-5)


@pytest.mark.parametrize("b,h,t,k,v,chunk,decay,end_grad", WKV6_CASES)
def test_wkv6_plain_backward_matches_jax_grad(b, h, t, k, v, chunk, decay,
                                              end_grad):
    """Against `jax.grad` of the reference's chunked scan. Its
    `jnp.minimum(d, 0)` clamps meet a tie where d = logb[t] - logc[i]
    is zero in exact arithmetic: always for i = t - 1 (an empty sum, whose
    derivative cancels, so these cases agree), and for longer gaps only
    where logw is exactly 0 between i and t, which
    `test_wkv6_plain_backward_at_decay_ties_is_exact` covers."""
    r, kk, vv, lw, s0, g, gs = _wkv6_inputs(b, h, t, k, v, decay)

    def f(*xs):
        o, s_final = jax_scan(*xs, chunk=chunk)
        out = jnp.sum(o * g)
        return out + jnp.sum(s_final * gs) if end_grad else out

    want = jax.grad(f, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in (r, kk, vv, lw, s0)))
    got = ref.wkv6_bwd_ref(*(_t(a) for a in (r, kk, vv, lw, s0, g)),
                           _t(gs) if end_grad else None, chunk)
    _close_wkv6([x.numpy() for x in got], [np.asarray(w) for w in want],
                r, kk, 1e-5, 1e-4)


@pytest.mark.parametrize("b,h,t,k,v,chunk,decay,end_grad", WKV6_CASES)
def test_wkv6_plain_backward_with_saved_states_matches_recomputing(
        b, h, t, k, v, chunk, decay, end_grad):
    """Fed the plain forward's chunk start states (as the autograd
    forward saves them), the plain backward gives the bits of the one
    that recomputes them, and stays within tolerance of `jax.grad`."""
    r, kk, vv, lw, s0, g, gs = _wkv6_inputs(b, h, t, k, v, decay)
    x = [_t(a) for a in (r, kk, vv, lw, s0)]
    o, s_final, states = ref.wkv6_ref(*x, chunk, return_states=True)
    n = -(-t // chunk)
    assert states.shape == (n - 1, b, h, k, v)
    ds = _t(gs) if end_grad else None
    saved = ref.wkv6_bwd_ref(*x, _t(g), ds, chunk, states)
    again = ref.wkv6_bwd_ref(*x, _t(g), ds, chunk)
    assert all(torch.equal(a, w) for a, w in zip(saved, again))

    def f(*xs):
        o, s_final = jax_scan(*xs, chunk=chunk)
        out = jnp.sum(o * g)
        return out + jnp.sum(s_final * gs) if end_grad else out

    want = jax.grad(f, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in (r, kk, vv, lw, s0)))
    _close_wkv6([a.numpy() for a in saved], [np.asarray(w) for w in want],
                r, kk, 1e-5, 1e-4)


def test_wkv6_bwd_block_fits_rwkv6_at_chunk_64():
    """rwkv6's time-mix (K = V = 64) trains through the backward kernel
    at the forward's chunk of 64: its block fits the card's shared
    memory (it did not before the chunk-parallel layout)."""
    from repro_torch.kernels.wkv6 import (
        BWD_MAX_DIM,
        MAX_SMEM_BYTES,
        bwd_smem_bytes,
    )
    assert bwd_smem_bytes(64, 64, 64) <= MAX_SMEM_BYTES
    assert bwd_smem_bytes(BWD_MAX_DIM, BWD_MAX_DIM, BWD_MAX_DIM) \
        <= MAX_SMEM_BYTES
    # The SSD heads' (16, 64, 64): two blocks an SM.
    assert 2 * bwd_smem_bytes(16, 64, 64) <= MAX_SMEM_BYTES


def _step_oracle(r, k, v, logw, s0):
    """The recurrence o_t = r_t S_{t-1}, S_t = w_t S_{t-1} + k_t v_t^T one
    step at a time (no chunks, no clamps)."""
    s, outs = s0, []
    for t in range(r.shape[2]):
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, :, t], s))
        s = torch.exp(logw[:, :, t])[..., None] * s \
            + k[:, :, t, :, None] * v[:, :, t, None, :]
    return torch.stack(outs, 2), s


def test_wkv6_plain_backward_at_decay_ties_is_exact():
    """logw exactly 0 on every third step: the chunked forward's
    differences d = logb[t] - logc[i] over such runs are 0 in exact
    arithmetic but round to +-1 ulp, and differentiating through
    `clamp(d, max=0)` (torch) or `jnp.minimum(d, 0)` (the reference)
    drops the pair's decay gradient wherever d rounds above 0: jax.grad
    of the reference's scan is off by 1.37 in dlogw here (max |dlogw|
    17.3). The explicit backward never differentiates a clamp, and
    matches the exact gradient (a float64 step-by-step recurrence)."""
    r, kk, vv, lw, s0, g, _ = _wkv6_inputs(1, 1, 48, 4, 8, "ties")
    lw[..., ::3, :] = 0.0
    x64 = [torch.as_tensor(a, dtype=torch.float64).requires_grad_(True)
           for a in (r, kk, vv, lw, s0)]
    o, _ = _step_oracle(*x64)
    want = torch.autograd.grad(o, x64, torch.as_tensor(g, dtype=torch.float64))
    got = ref.wkv6_bwd_ref(*(_t(a) for a in (r, kk, vv, lw, s0, g)), None, 16)
    _close_wkv6([x.numpy() for x in got], [x.numpy() for x in want],
                r, kk, 1e-5, 1e-5)


def test_wkv6_op_backward_sums_broadcast_views():
    """The SSD heads pass k broadcast over heads and logw over the state
    dim (stride-0 views): the op's backward (the plain backward on the
    CPU) returns dense gradients and autograd sums them back to the
    views' bases, as autograd of the plain forward does."""
    b, h, t, k, v = 2, 4, 33, 16, 32
    rng = np.random.default_rng(7)
    r = _t(rng.normal(size=(b, h, t, k)))
    kb = _t(rng.normal(size=(b, 1, t, k)))
    vv = _t(0.3 * rng.normal(size=(b, t, h, v)))
    lwb = _t(-0.3 * np.abs(rng.normal(size=(b, h, t, 1))))
    s0 = torch.zeros((b, h, k, v))
    g = _t(rng.normal(size=(b, h, t, v)))
    grads = {}
    for name, fn in (("op", lambda *a: ops.wkv6_op(*a, chunk=64)),
                     ("autograd", lambda *a: ref.wkv6_ref(*a, chunk=64))):
        leaves = [x.clone().requires_grad_(True) for x in (r, kb, vv, lwb)]
        o, _ = fn(leaves[0], leaves[1].expand(b, h, t, k),
                  leaves[2].transpose(1, 2), leaves[3].expand(b, h, t, k),
                  s0)
        grads[name] = torch.autograd.grad(o, leaves, g)
    for a, w in zip(grads["op"], grads["autograd"]):
        assert a.shape == w.shape
        _close(a, w, 1e-5 * max(1.0, float(w.abs().max())), 1e-5)
