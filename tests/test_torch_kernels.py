"""Port kernels' plain versions vs the reference Pallas kernels.

On the CPU the port's `ops` take the plain PyTorch versions
(`repro_torch.kernels.ref`); the reference kernels run in interpret mode,
as `tests/test_kernels.py` runs them, with its shapes and tolerances. The
CUDA kernels themselves are held against the same plain versions on the
card by `chip_smoke.py`.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fedagg import fedagg as jax_fedagg
from repro.kernels.prox_sgd import prox_sgd as jax_prox_sgd
from repro.kernels.ref import fedagg_ref as jax_fedagg_ref
from repro.kernels.ref import prox_sgd_ref as jax_prox_sgd_ref
from repro_torch.kernels import build, ops, ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _pair(a: np.ndarray, dtype: str):
    """The same values in both frameworks (bf16 rounded once, RNE)."""
    return (jnp.asarray(a, jnp.float32).astype(JAX[dtype]),
            torch.as_tensor(a, dtype=torch.float32).to(TORCH[dtype]))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,p", [(2, 100), (10, 47887), (64, 4096),
                                 (7, 12345)])
def test_fedagg_plain_matches_reference(k, p, dtype):
    rng = np.random.default_rng(k * p)
    xj, xt = _pair(rng.normal(size=(k, p)), dtype)
    w = rng.random(k).astype(np.float32)
    out = ops.fedagg_op(xt, torch.as_tensor(w))
    assert out.dtype == TORCH[dtype] and out.shape == (p,)
    tol = TOL[dtype]
    want = jax_fedagg(xj, jnp.asarray(w), interpret=True)
    np.testing.assert_allclose(_np(out), _np(want), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(out), _np(jax_fedagg_ref(xj, jnp.asarray(w))),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,p", [(2, 100), (10, 47887), (7, 12345)])
@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_fedagg_delta_form_matches_reference(k, p, scale, dtype):
    """base + scale * sum_k w_k (x_k - base), the reference computed as
    its fedagg kernel over the deltas."""
    rng = np.random.default_rng(k + p)
    x = rng.normal(size=(k, p)).astype(np.float32)
    base = rng.normal(size=(p,)).astype(np.float32)
    w = rng.random(k).astype(np.float32)
    _, xt = _pair(x, dtype)
    bj, bt = _pair(base, dtype)
    out = ops.fedagg_op(xt, torch.as_tensor(w), base=bt, scale=scale)
    delta = jax_fedagg(jnp.asarray(x - _np(bt)[None]), jnp.asarray(w),
                       interpret=True)
    want = (bj.astype(jnp.float32) + scale * delta).astype(JAX[dtype])
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(out), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p", [47887, 8192, 130])
def test_prox_sgd_plain_matches_reference(p, dtype):
    rng = np.random.default_rng(p)
    (wj, wt), (gj, gt), (aj, at) = (_pair(rng.normal(size=(p,)), dtype)
                                    for _ in range(3))
    want = jax_prox_sgd(wj, gj, aj, 0.05, 0.1, interpret=True)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(ref.prox_sgd_ref(wt, gt, at, 0.05, 0.1)),
                               _np(want), rtol=tol, atol=tol)
    # The stacked, masked op on a one-client buffer is the same step.
    w1 = wt[None].clone()
    ops.prox_sgd_op(w1, gt[None], at, torch.tensor([1], dtype=torch.int32),
                    0, 0.05, 0.1)
    np.testing.assert_allclose(_np(w1[0]), _np(want), rtol=tol, atol=tol)
    np.testing.assert_allclose(
        _np(w1[0]), _np(jax_prox_sgd_ref(wj, gj, aj, 0.05, 0.1)),
        rtol=tol, atol=tol)


@pytest.mark.parametrize("mu", [0.0, 0.1])
@pytest.mark.parametrize("shared_anchor", [True, False])
def test_prox_sgd_step_mask(mu, shared_anchor):
    """Rows with step >= steps[c] are bitwise untouched; live rows take
    the reference step."""
    rng = np.random.default_rng(7)
    C, P, step = 5, 4099, 3
    w = rng.normal(size=(C, P)).astype(np.float32)
    g = rng.normal(size=(C, P)).astype(np.float32)
    a = rng.normal(size=(P,) if shared_anchor else (C, P)).astype(np.float32)
    steps = np.array([0, 3, 4, 8, 2], np.int32)
    wt = torch.as_tensor(w.copy())
    out = ops.prox_sgd_op(wt, torch.as_tensor(g), torch.as_tensor(a),
                          torch.as_tensor(steps), step, 0.05, mu)
    assert out is wt                                   # in place
    for c in range(C):
        if step < steps[c]:
            anchor = a if shared_anchor else a[c]
            want = jax_prox_sgd(jnp.asarray(w[c]), jnp.asarray(g[c]),
                                jnp.asarray(anchor), 0.05, mu,
                                interpret=True)
            np.testing.assert_allclose(wt[c].numpy(), np.asarray(want),
                                       rtol=2e-5, atol=2e-5)
        else:
            assert np.array_equal(wt[c].numpy().view(np.uint32),
                                  w[c].view(np.uint32))


# The batched sweep's forms: S scenarios of C client rows each.
@pytest.mark.parametrize("S,C,P", [(3, 4, 4099), (1, 7, 130), (5, 3, 3)])
@pytest.mark.parametrize("group", ["scenario", "client", "shared"])
def test_prox_sgd_rows_form_is_the_loop_over_scenarios(S, C, P, group):
    """Per-row mu and grouped anchors on CPU tensors equal a loop of the
    unextended plain version over the scenarios (each scenario's scalar mu
    and its own anchor), bitwise; the scenarios' mu mixes 0 and 0.1."""
    rng = np.random.default_rng(S * C + P)
    R = S * C
    w = rng.normal(size=(R, P)).astype(np.float32)
    g = rng.normal(size=(R, P)).astype(np.float32)
    rows = {"scenario": S, "client": R, "shared": 1}[group]
    a = rng.normal(size=(rows, P)).astype(np.float32)
    steps = rng.integers(0, 6, size=R).astype(np.int32)
    mus = np.array([0.1 if s % 2 else 0.0 for s in range(S)], np.float32)
    got = torch.as_tensor(w.copy())
    out = ops.prox_sgd_op(got, torch.as_tensor(g), torch.as_tensor(a),
                          torch.as_tensor(steps), 3, 0.05,
                          torch.as_tensor(np.repeat(mus, C)))
    assert out is got
    want = torch.as_tensor(w.copy())
    for s in range(S):
        sl = slice(s * C, (s + 1) * C)
        anchor = (a[s] if group == "scenario" else a[sl]
                  if group == "client" else a[0])
        ref.prox_sgd_masked_ref_(want[sl], torch.as_tensor(g[sl]),
                                 torch.as_tensor(anchor),
                                 torch.as_tensor(steps[sl]), 3, 0.05,
                                 float(mus[s]))
    assert torch.equal(got, want)


@pytest.mark.parametrize("delta", [False, True])
@pytest.mark.parametrize("S,K,P", [(4, 10, 4099), (1, 3, 47887), (3, 1, 5)])
def test_fedagg_batched_form_is_the_loop_over_scenarios(S, K, P, delta):
    """The scenario axis on CPU tensors equals a loop of the unextended
    plain version, bitwise, with per-scenario scales; one scenario's
    weights all zero keeps its base bit for bit; and each scenario is the
    reference kernel's (interpret mode) within its tolerance."""
    rng = np.random.default_rng(S * K + P)
    x = rng.normal(size=(S, K, P)).astype(np.float32)
    w = rng.random((S, K)).astype(np.float32)
    w[S // 2] = 0.0
    base = rng.normal(size=(S, P)).astype(np.float32) if delta else None
    scale = (rng.random(S) + 0.5).astype(np.float32)
    bt = None if base is None else torch.as_tensor(base)
    got = ops.fedagg_op(torch.as_tensor(x), torch.as_tensor(w), bt,
                        torch.as_tensor(scale))
    assert got.shape == (S, P)
    for s in range(S):
        want = ref.fedagg_ref(torch.as_tensor(x[s]), torch.as_tensor(w[s]),
                              None if bt is None else bt[s], float(scale[s]))
        assert torch.equal(got[s], want)
        if delta:
            jw = jax_fedagg(jnp.asarray(x[s] - base[s][None]),
                            jnp.asarray(w[s]), interpret=True)
            jwant = base[s] + scale[s] * np.asarray(jw)
        else:
            jwant = np.asarray(jax_fedagg(jnp.asarray(x[s]),
                                          jnp.asarray(w[s]), interpret=True))
        np.testing.assert_allclose(got[s].numpy(), jwant, rtol=2e-5,
                                   atol=2e-5)
    if delta:
        assert torch.equal(got[S // 2], bt[S // 2])


def test_cuda_path_never_falls_back_to_plain(monkeypatch):
    """A tensor on no plain device goes to the kernel wrapper, which
    raises for anything but a CUDA tensor; the launch counters only move
    on a real launch. `meta` is a plain device (the dry run's), so it is
    taken off the plain devices here to stand for any other device."""
    monkeypatch.setattr(ops, "PLAIN_DEVICES", ("cpu",))
    before = dict(ops.LAUNCHES)
    x = torch.empty((3, 8), device="meta")
    w = torch.empty((3,), device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.fedagg_op(x, w)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.prox_sgd_op(x, x, x, torch.empty((3,), dtype=torch.int32,
                                             device="meta"), 0, 0.05, 0.1)
    assert ops.LAUNCHES == before


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build, "DEFAULT_NVCC", tmp_path / "no-nvcc")
    monkeypatch.setattr(build, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.library()


def test_build_sources_exist_and_hash_changes_with_source(tmp_path,
                                                          monkeypatch):
    files = build.SOURCES + build.HEADERS
    for name in files:
        assert (build.CSRC / name).is_file()
    before = build._digest("nvcc")
    for name in files:
        (tmp_path / name).write_bytes((build.CSRC / name).read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert build._digest("nvcc") == before
    # An edit to a source or to a header the sources include rebuilds.
    for name in (build.SOURCES[0], build.HEADERS[0]):
        kept = (tmp_path / name).read_bytes()
        (tmp_path / name).write_text("// edited\n")
        assert build._digest("nvcc") != before
        (tmp_path / name).write_bytes(kept)
    assert build._digest("nvcc") == before


_PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z12flash_kernelIfLi128EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z12flash_kernelIfLi128EEvv
    16 bytes stack frame, 16 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 488 bytes cmem[0]
ptxas info    : Compiling entry function '_Z11wkv6_kernelv' for 'sm_90a'
ptxas info    : Function properties for _Z11wkv6_kernelv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 480 bytes cmem[0]
"""


def test_resource_usage_reads_the_ptxas_report(monkeypatch, tmp_path):
    lib = tmp_path / "libreprokernels-0.so"
    lib.with_suffix(".ptxas.txt").write_text(_PTXAS_LOG)
    monkeypatch.setattr(build, "build", lambda: lib)
    monkeypatch.setattr(build, "_demangle", lambda names: names)
    assert build.resource_usage() == [
        dict(kernel="_Z12flash_kernelIfLi128EEvv", stack_bytes=16,
             spill_store_bytes=16, spill_load_bytes=16, registers=128),
        dict(kernel="_Z11wkv6_kernelv", stack_bytes=0, spill_store_bytes=0,
             spill_load_bytes=0, registers=40)]


_SASS = """\
\t\tFunction : _Z17flash_bf16_kernelILi64EEvv
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0080*/              @!P0 LDGSTS.E.BYPASS.LTC128B.128 [R5], desc[UR6][R2.64] ;
        /*0090*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT, gsb0 ;
        /*00a0*/                   HGMMA.64x64x16.F32.BF16 R24, R88, gdesc[UR8], R24, gsb0 ;
        /*00b0*/                   WARPGROUP.ARRIVE ;
\t\tFunction : _Z11wkv6_kernelv
        /*0000*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0010*/                   UTMALDG.2D [UR8], [UR4] ;
        /*0020*/                   FFMA R4, R8, R12, R4 ;
"""


def test_parse_sass_counts_tensor_core_and_async_copy_instructions():
    assert build.parse_sass(_SASS) == [
        dict(kernel="_Z17flash_bf16_kernelILi64EEvv", tensor_core_ops=2,
             async_copy_ops=1),
        dict(kernel="_Z11wkv6_kernelv", tensor_core_ops=1, async_copy_ops=1)]
