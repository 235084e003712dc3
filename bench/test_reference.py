"""Each configuration's plain reference against the program's round, at a
tiny size on the CPU, in float32 (where the two must agree to rounding)
and in the configuration's bfloat16."""
from __future__ import annotations

import ast

import pytest
import torch

from bench import check, harness
from bench.conftest import cell_names, config_names, traffic_names
from bench.reference import _round


def _program(cell, seed):
    out = cell.driver.run(cell, seed, 0.0, False, torch.device("cpu"), 0.0)
    return out["program"]


@pytest.mark.parametrize("name,traffic", [
    *((n, None) for n in cell_names() + config_names()),
    *((cell_names()[0], t) for t in traffic_names())])
def test_reference_follows_the_float32_round(name, traffic, tiny):
    cell = tiny(name, "float32", traffic)
    seed = 2 ** 33 + 5
    ref = cell.driver.reference_rounds(cell, seed, torch.device("cpu"))
    r = check.readings(_program(cell, seed), ref)
    assert len(ref["losses"]) == cell.traffic["local_steps"] \
        * cell.traffic["check_rounds"]
    assert r["leaves_counted"] >= 0.9 * r["leaves"]
    assert r["loss_gap"] < 1e-5
    assert r["delta_gap"] < 1e-3 and r["change_gap"] < 1e-3


@pytest.mark.parametrize("name", config_names())
def test_reference_loss_and_gradient_match_the_program(name, tiny):
    cell = tiny(name, "float32")
    harness.program_path()
    from repro_torch.models.lm.transformer import init_params
    from repro_torch.train.step import lm_loss
    cfg = harness.port_config(cell.config)
    params = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 70),
                           generator=torch.Generator().manual_seed(4))
    leaves = [t.requires_grad_(True) for _, t in harness.tree_items(params)]
    loss = lm_loss(cfg, params, {"tokens": tokens})[0]
    grads = torch.autograd.grad(loss, leaves)
    want, want_grads = _round.loss_and_grads(
        cell.reference.loss_sum, cell.config["model"],
        [t.detach() for t in leaves], params, tokens,
        harness.load_module(harness.BENCH / "reference" / "_plain.py")
        .plain_mm)
    assert abs(float(loss.detach()) - want) < 1e-5 * abs(want)
    for g, w in zip(grads, want_grads):
        assert float((g - w).norm()) <= 1e-4 * float(w.norm()) + 1e-9


@pytest.mark.parametrize("path", sorted(
    (harness.BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tree = ast.parse(path.read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    assert all(n.split(".")[0] in ("__future__", "importlib", "pathlib",
                                   "torch") for n in names), names


def _recurrence(r, k, v, logw, u):
    """o_t = r_t.(S_{t-1} + diag(u) k_t v_t^T), S_t = diag(w_t) S_{t-1}
    + k_t v_t^T, one step at a time."""
    B, T, H, K = r.shape
    s = r.new_zeros((B, H, K, v.shape[-1]))
    out = []
    for t in range(T):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        out.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                                s + u[..., None] * kv))
        s = torch.exp(logw[:, t])[..., None] * s + kv
    return torch.stack(out, dim=1)


def test_scans_match_the_step_by_step_recurrence():
    plain = harness.load_module(harness.BENCH / "reference" / "_plain.py")
    g = torch.Generator().manual_seed(0)
    B, T, H, K, V, N = 2, 150, 3, 8, 5, 4
    rnd = lambda *s: torch.randn(s, generator=g, dtype=torch.float64)
    r, k, v = rnd(B, T, H, K), rnd(B, T, H, K), rnd(B, T, H, V)
    logw = -torch.rand((B, T, H, K), generator=g, dtype=torch.float64) * 2
    u = rnd(H, K)
    want = _recurrence(r, k, v, logw, u)
    got = plain.wkv_scan(r, k, v, logw, u, chunk=32)
    assert torch.allclose(got, want, rtol=1e-9, atol=1e-9)
    # SSD: one decay per head, B and C shared by the heads, the current
    # step included: c_t w_t . S_{t-1} (the RWKV form, r = c w, u = 0)
    # plus (c_t . b_t) x_t.
    x, b, c = rnd(B, T, H, V), rnd(B, T, N), rnd(B, T, N)
    lw = -torch.rand((B, T, H), generator=g, dtype=torch.float64)
    expand = lambda t: t[:, :, None].expand(B, T, H, N)
    w = lw[..., None].expand(B, T, H, N)
    want = _recurrence(expand(c) * torch.exp(w), expand(b), x, w,
                       torch.zeros(H, N, dtype=torch.float64)) \
        + (c * b).sum(-1)[..., None, None] * x
    got = plain.ssd_scan(x, lw, b, c, chunk=32)
    assert torch.allclose(got, want, rtol=1e-9, atol=1e-9)
