"""Expert-parallel MoE (`apply_moe_ep`) vs the reference.

The reference's own `apply_moe_ep` fails under jax 0.9 (ROADMAP section
3, reference caveats), so its oracle is composed from its row-local
`apply_moe`: EP's capacity is per source shard, so rank r's exact oracle
is `apply_moe` on that shard's tokens as one row, x_r.reshape(1, b_loc *
S, d), drops included, and the aux losses are the mean of the shards'.
At capacity factor 1.5 tokens drop, so the dispatch's drop rule is
exercised. Held at one rank (the port's one-rank default group) with
gradients against autograd of the port's `apply_moe` on the same view,
and at 2 and 4 gloo ranks in one spawn (outputs, aux, and the gradients
in x, the router and each rank's own experts against `jax.grad` of the
oracle). Each rank's loss is sum(y ** 2) plus the group-mean aux terms,
as `_apply_layer_train` adds them; the gradients are those of the sum of
the ranks' losses, in which shard s's aux enters with weight 1 (the
all-reduce mean's backward sums the ranks' cotangents and divides by the
group size), so shard s's oracle is sum(y_s ** 2) + aux_s. A reduced grok-1 under `expert_parallel` takes the EP
dispatch in prefill and stays row-local in decode.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.lm.config import MoEConfig as JaxMoEConfig
from repro.models.lm.moe import apply_moe as jax_apply_moe
from repro.models.lm.moe import init_moe as jax_init_moe
from repro_torch.configs import get_config
from repro_torch.models.lm.config import MoEConfig
from repro_torch.models.lm.moe import apply_moe, apply_moe_ep
from repro_torch.models.lm.params import lm_params_from_jax, map_tree
from repro_torch.models.lm.transformer import (
    decode_step,
    forward_train_stacked,
    init_params,
    prefill,
)
from repro_torch.sharding import COLLECTIVES, default_group, \
    expert_parallel, ep_axis, reset_collectives
from torch_mesh_ranks import moe_ep_rank, spawn

# One torch thread a worker, as `torch_parity` sets it for the other
# parity files: the suite runs several workers (and these files' spawned
# ranks) at once.
torch.set_num_threads(1)

MOE = dict(n_experts=8, top_k=2, d_ff_expert=64, n_shared=1,
           capacity_factor=1.5)
D = 32


def _inputs(B: int, S: int, seed: int = 0):
    """Expert params and tokens; the tokens share a common offset, so the
    router favours some experts and, at capacity factor 1.5, drops."""
    p = jax.device_get(jax_init_moe(jax.random.PRNGKey(seed), D,
                                    JaxMoEConfig(**MOE), "swiglu"))
    x = (np.random.default_rng(seed).normal(size=(B, S, D)) * 0.5
         + 0.5).astype(np.float32)
    return p, x


def _one_row(pp, xx):
    b, S, d = xx.shape
    y, aux = jax_apply_moe(pp, xx.reshape(1, b * S, d),
                           JaxMoEConfig(**MOE), "swiglu")
    return y.reshape(b, S, d), aux


def _one_row_loss(pp, xx):
    y, aux = _one_row(pp, xx)
    return jnp.sum(y ** 2) + aux["load_balance"] + aux["router_z"]


_one_row_grads = jax.jit(jax.grad(_one_row_loss, argnums=(0, 1)))


def _shard_oracle(p, x_r: np.ndarray):
    """The reference's apply_moe on one shard as one row; the gradients of
    sum(y ** 2) + load_balance + router_z in x_r and in w1, w2, w3 and
    the router."""
    y, aux = jax.jit(_one_row)(p, jnp.asarray(x_r))
    gp, gx = _one_row_grads(p, jnp.asarray(x_r))
    return (np.asarray(y), {k: float(v) for k, v in aux.items()},
            np.asarray(gx),
            [np.asarray(gp[k]) for k in ("w1", "w2", "w3", "router")])


def _dropped(p, x) -> int:
    """Assignments over capacity when the whole of x is one row."""
    cfg = MoEConfig(**MOE)
    from repro_torch.models.lm.moe import _route
    pt = lm_params_from_jax(p, device="cpu")
    T = x.shape[0] * x.shape[1]
    _, ids, _ = _route(pt, torch.as_tensor(x).reshape(1, T, D), cfg)
    C = round(T * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    counts = torch.bincount(ids.reshape(-1), minlength=cfg.n_experts)
    return int(torch.clamp(counts - C, min=0).sum())


def test_one_rank_matches_one_row_view():
    p, x = _inputs(2, 96)
    assert _dropped(p, x) > 0            # cf 1.5: some tokens drop
    y_ref, aux_ref, _, _ = _shard_oracle(p, x)
    cfg = MoEConfig(**MOE)
    pt = lm_params_from_jax(p, device="cpu")
    group = default_group("cpu")
    leaves = [pt["w1"], pt["w2"], pt["w3"], pt["router"]]
    xt = torch.as_tensor(x).requires_grad_(True)
    for t in leaves:
        t.requires_grad_(True)
    reset_collectives()
    y, aux = apply_moe_ep(pt, xt, cfg, "swiglu", group)
    assert COLLECTIVES["all_to_all"] == 2
    np.testing.assert_allclose(y.detach().numpy(), y_ref, rtol=1e-5,
                               atol=1e-6)
    for k in aux:
        assert abs(float(aux[k].detach()) - aux_ref[k]) <= 1e-6
    # Gradients against autograd of the port's row-local apply_moe on the
    # one-row view (both paths' backward through the same dispatch).
    loss = (y ** 2).sum() + aux["load_balance"] + aux["router_z"]
    got = torch.autograd.grad(loss, [xt] + leaves)
    y1, aux1 = apply_moe(pt, xt.reshape(1, -1, D), cfg, "swiglu")
    loss1 = (y1 ** 2).sum() + aux1["load_balance"] + aux1["router_z"]
    want = torch.autograd.grad(loss1, [xt] + leaves)
    assert COLLECTIVES["all_to_all"] == 4    # the backward's two
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        assert float(a.abs().sum()) > 0


def test_two_and_four_ranks_match_per_shard_oracle(tmp_path):
    p, x = _inputs(8, 40, seed=1)
    assert _dropped(p, x[:2]) > 0
    ranks = spawn(moe_ep_rank, 4, str(tmp_path), MoEConfig(**MOE), p, x,
                  "swiglu", (4, 2))
    for size in (4, 2):
        b_loc = x.shape[0] // size
        E_loc = MOE["n_experts"] // size
        for g0 in range(0, 4, size):
            shards = [_shard_oracle(p, x[r * b_loc:(r + 1) * b_loc])
                      for r in range(size)]
            aux_mean = {k: float(np.mean([s[1][k] for s in shards]))
                        for k in shards[0][1]}
            gw_sum = [sum(s[3][i] for s in shards) for i in range(3)]
            for r in range(size):
                out = ranks[g0 + r][size]
                assert out["rank"] == r
                y_ref, _, gx_ref, gw_ref = shards[r]
                np.testing.assert_allclose(out["y"], y_ref, rtol=1e-5,
                                           atol=1e-6)
                for k, v in aux_mean.items():
                    assert abs(out["aux"][k] - v) <= 1e-6
                np.testing.assert_allclose(out["gx"], gx_ref, rtol=1e-5,
                                           atol=1e-5)
                # The router runs locally: its gradient is this shard's.
                np.testing.assert_allclose(out["gr"], gw_ref[3], rtol=1e-5,
                                           atol=1e-6)
                assert np.abs(out["gr"]).sum() > 0
                mine = slice(r * E_loc, (r + 1) * E_loc)
                for got, want in zip(out["gw"], gw_sum):
                    np.testing.assert_allclose(got[mine], want[mine],
                                               rtol=1e-5, atol=1e-5)
                    assert not got[:r * E_loc].any()
                    assert not got[(r + 1) * E_loc:].any()


def test_expert_parallel_context_routes_prefill_not_decode():
    """Reduced grok-1 under `expert_parallel` at one rank: each MoE layer
    of a prefill takes the all-to-all dispatch (two exchanges a layer),
    decode (S = 1) none; with one prompt row EP's capacity equals the
    row-local one, so the logits agree. The training forward refuses a
    client stack under the context."""
    cfg = get_config("grok-1-314b").reduced()
    n_moe = sum(s.n_layers for s in cfg.resolved_segments
                if s.kind == "moe")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (1, 70),
                           generator=torch.Generator().manual_seed(1))
    group = default_group("cpu")
    assert ep_axis() is None
    want, cache = prefill(cfg, params, tokens, 80)
    want_dec, _ = decode_step(cfg, params, tokens[:, -1:], cache)
    with expert_parallel(group):
        assert ep_axis() is group
        reset_collectives()
        got, cache = prefill(cfg, params, tokens, 80)
        assert COLLECTIVES["all_to_all"] == 2 * n_moe
        got_dec, _ = decode_step(cfg, params, tokens[:, -1:], cache)
        assert COLLECTIVES["all_to_all"] == 2 * n_moe
        with pytest.raises(ValueError, match="stack"):
            forward_train_stacked(
                cfg, map_tree(lambda t: torch.stack([t, t]), params),
                torch.stack([tokens, tokens]))
    assert ep_axis() is None
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got_dec, want_dec, rtol=1e-5, atol=1e-5)
