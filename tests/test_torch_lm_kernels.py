"""The LM kernels' plain versions vs the reference Pallas kernels.

On the CPU, `repro_torch.kernels.ops.flash_attention_op` and `wkv6_op`
take their plain PyTorch versions (`repro_torch.kernels.ref`). They are
held against the reference's Pallas kernels in interpret mode and its
oracles (`attention_ref`, `wkv6_ref`), over the parameter sets of
`tests/test_kernels.py`, with its tolerances: 3e-5 for flash in f32,
3e-2 in bf16, 2e-4 for wkv6. The CUDA kernels are held against the same
plain versions on the card (`tests/test_torch_cuda.py`, `chip_smoke.py`).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.ref import attention_ref as jax_attention_ref
from repro.kernels.ref import wkv6_ref as jax_wkv6_ref
from repro.kernels.wkv6 import wkv6 as jax_wkv6
from repro.models.lm.scan_core import chunked_decay_scan as jax_scan
from repro_torch.kernels import ops

JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a: np.ndarray, dtype: str = "float32"):
    """The same values in both frameworks (bf16 rounded once, RNE)."""
    return (jnp.asarray(a, jnp.float32).astype(JAX[dtype]),
            torch.as_tensor(np.asarray(a, np.float32)).to(TORCH[dtype]))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t, np.float32)


@pytest.mark.parametrize(
    "b,h,kv,s,d,causal,window,softcap",
    [
        (1, 2, 2, 128, 64, True, None, None),     # MHA causal
        (2, 4, 2, 128, 32, True, None, None),     # GQA
        (1, 4, 1, 256, 64, True, 64, None),       # MQA + sliding window
        (1, 2, 2, 128, 64, False, None, None),    # bidirectional (encoder)
        (1, 2, 2, 128, 64, True, None, 30.0),     # grok softcap
        (1, 2, 1, 64, 128, True, 16, None),       # window < block
    ])
def test_flash_plain_matches_pallas_interpret(b, h, kv, s, d, causal,
                                              window, softcap):
    rng = np.random.default_rng(s + d)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng.normal(size=shape))
        for shape in ((b, h, s, d), (b, kv, s, d), (b, kv, s, d)))
    out = ops.flash_attention_op(qt, kt, vt, causal=causal, window=window,
                                 softcap=softcap)
    assert out.dtype == torch.float32 and out.shape == (b, h, s, d)
    kw = dict(causal=causal, window=window, softcap=softcap)
    # Default blocks (the sweep's own use 32): the function is the same,
    # and interpreting fewer grid steps keeps the test quick.
    pallas = jax_flash(qj, kj, vj, interpret=True, **kw)
    np.testing.assert_allclose(_np(out), _np(pallas), rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(_np(out), _np(jax_attention_ref(qj, kj, vj,
                                                               **kw)),
                               rtol=3e-5, atol=3e-5)


def test_flash_plain_bf16_matches_pallas_interpret():
    rng = np.random.default_rng(0)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng.normal(size=(1, 2, 128, 64)), "bfloat16") for _ in range(3))
    out = ops.flash_attention_op(qt, kt, vt)
    assert out.dtype == torch.bfloat16
    pallas = jax_flash(qj, kj, vj, interpret=True)
    np.testing.assert_allclose(_np(out), _np(pallas), rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(_np(out), _np(jax_attention_ref(qj, kj, vj)),
                               rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("s,window", [(100, None), (77, 20)])
def test_flash_plain_takes_any_length(s, window):
    """S need not be a multiple of a block (the Pallas kernel asserts it
    is); the oracle is the reference's attention_ref."""
    rng = np.random.default_rng(s)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng.normal(size=shape))
        for shape in ((2, 4, s, 64), (2, 2, s, 64), (2, 2, s, 64)))
    out = ops.flash_attention_op(qt, kt, vt, window=window)
    np.testing.assert_allclose(
        _np(out), _np(jax_attention_ref(qj, kj, vj, window=window)),
        rtol=3e-5, atol=3e-5)


def _wkv6_inputs(rng, B, H, T, K, V, decay=0.3):
    r = rng.normal(size=(B, H, T, K))
    k = rng.normal(size=(B, H, T, K))
    v = rng.normal(size=(B, H, T, V))
    lw = -np.abs(rng.normal(size=(B, H, T, K))) * decay
    s0 = rng.normal(size=(B, H, K, V))
    return [_pair(a) for a in (r, k, v, lw, s0)]


@pytest.mark.parametrize("t,chunk", [(64, 16), (128, 64), (96, 32)])
@pytest.mark.parametrize("kdim,vdim", [(16, 32), (64, 64)])
def test_wkv6_plain_matches_pallas_interpret(t, chunk, kdim, vdim):
    rng = np.random.default_rng(t + kdim)
    pairs = _wkv6_inputs(rng, 2, 3, t, kdim, vdim)
    jx, tx = [p[0] for p in pairs], [p[1] for p in pairs]
    o, sT = ops.wkv6_op(*tx, chunk=chunk)
    assert o.shape == (2, 3, t, vdim) and sT.shape == (2, 3, kdim, vdim)
    po, ps = jax_wkv6(*jx, chunk=chunk, interpret=True)
    ro, rs = jax_wkv6_ref(*jx)
    for got, want in ((o, po), (sT, ps), (o, ro), (sT, rs)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)


def test_wkv6_plain_strong_decay_stability():
    """Long chunks with near-total per-step decay stay finite (log-space)
    and agree with the step-by-step oracle."""
    rng = np.random.default_rng(1)
    pairs = _wkv6_inputs(rng, 1, 1, 256, 32, 32)
    pairs[3] = _pair(np.full((1, 1, 256, 32), -5.0))
    pairs[4] = _pair(np.zeros((1, 1, 32, 32)))
    jx, tx = [p[0] for p in pairs], [p[1] for p in pairs]
    o, sT = ops.wkv6_op(*tx, chunk=128)
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(sT).all())
    po, ps = jax_wkv6(*jx, chunk=128, interpret=True)
    ro, rs = jax_wkv6_ref(*jx)
    for got, want in ((o, po), (sT, ps), (o, ro), (sT, rs)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("t,chunk", [(100, 32), (20, 64)])
def test_wkv6_plain_takes_any_length(t, chunk):
    """T need not be a multiple of the chunk: the op's zero tail is the
    reference `chunked_decay_scan`'s zero padding."""
    rng = np.random.default_rng(t)
    pairs = _wkv6_inputs(rng, 2, 2, t, 16, 64)
    jx, tx = [p[0] for p in pairs], [p[1] for p in pairs]
    o, sT = ops.wkv6_op(*tx, chunk=chunk)
    want_o, want_s = jax_scan(*jx, chunk=chunk)
    np.testing.assert_allclose(_np(o), _np(want_o), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_np(sT), _np(want_s), rtol=2e-4, atol=2e-4)
    ro, rs = jax_wkv6_ref(*jx)
    np.testing.assert_allclose(_np(o), _np(ro), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_np(sT), _np(rs), rtol=2e-4, atol=2e-4)


def test_cpu_ops_never_count_launches():
    """CPU tensors take the plain versions; only kernel launches count."""
    before = dict(ops.LAUNCHES)
    x = torch.zeros((1, 2, 8, 64))
    ops.flash_attention_op(x, x, x)
    z = torch.zeros((1, 1, 8, 16))
    ops.wkv6_op(z, z, torch.zeros((1, 1, 8, 64)), z, torch.zeros((1, 1, 16,
                                                                  64)))
    assert ops.LAUNCHES == before
