"""The dry run's expert-parallel MoE (`--ep`): `apply_moe_ep_mesh`, the
reference's `shard_map` in DTensor form, on small meshes of a fake
process group, each test in a spawned process (the dry run owns its
process). The reference's own `apply_moe_ep` fails under jax 0.9
(ROADMAP section 3), so the oracle of the count is the port's real
`apply_moe_ep` on 2 gloo ranks, counted by the same `CostMode`: one
routed layer's forward and backward on a (2, 1) mesh costs rank 0 the
same FLOPs and the same all-to-all bytes. On (2, 2) the model axis
halves the expert products and reduces their partial sums; on (2, 2, 2)
the aux mean spans pod x data and the experts' reshard from ("pod",
"data") to "data" is counted. Whole steps keep the probe identity under
`--ep`, and the pairs the reference keeps row-local count exactly as
without it. `CostMode` refuses a collective it has no kind for.
"""
from __future__ import annotations

import dataclasses
import json

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models.lm.config import MoEConfig, Segment
from test_torch_dryrun import SHAPES
from test_torch_dryrun_mesh import _spawned
from torch_mesh_ranks import moe_ep_count_rank, spawn

MOE = dict(n_experts=8, top_k=2, d_ff_expert=64, n_shared=1,
           capacity_factor=1.5)
D = 32
# The layer's batch: 4 rows of 16 tokens; on 2 data shards T_loc = 32
# and C = round(32 * 2 * 1.5 / 8) = 12.
B, S = 4, 16


def _capacity(T_loc: int, moe: dict) -> int:
    return round(T_loc * moe["top_k"] * moe["capacity_factor"]
                 / moe["n_experts"])


def _ep_layer(sizes, names) -> dict:
    """One routed layer (`apply_moe_ep_mesh`) forward and backward on an
    abstract mesh of `sizes` x `names`: the params laid out by their
    train specs (FSDP, no TP-only fallback), x's batch over every axis
    but "model", all counted as the dry run counts a step. Also each
    functional collective's group size and output shapes."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.launch import dryrun
    from repro_torch.models.lm.moe import apply_moe_ep_mesh, init_moe
    from repro_torch.models.lm.params import tree_leaves
    from repro_torch.sharding import COLLECTIVES, reset_collectives
    from repro_torch.sharding.compat import abstract_mesh, device_mesh
    from repro_torch.sharding.ctx import MeshEP
    from repro_torch.sharding.specs import P, param_pspecs

    class Groups(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.namespace == "_c10d_functional" and isinstance(
                    args[-1], str):
                self.seen.append((func._schema.name, _resolve_process_group(
                    args[-1]).size(), tuple(out.shape)))
            return out

    torch.set_num_threads(1)
    mesh = abstract_mesh(sizes, names)
    dmesh = device_mesh(mesh)
    cfg = MoEConfig(**MOE)
    p = init_moe(torch.Generator().manual_seed(0), D, cfg, "swiglu",
                 device="meta")
    params = dryrun._layout(p, param_pspecs(p, mesh, allow_tp_only=False),
                            dmesh)
    dp = tuple(n for n in names if n != "model")
    x = dryrun._shard(torch.empty(B, S, D, device="meta"), P(dp, None, None),
                      dmesh)
    leaves = [x] + tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    cm, groups = dryrun.CostMode(), Groups()
    reset_collectives()
    with implicit_replication(), cm, dryrun.LayoutMode(), groups:
        y, aux = apply_moe_ep_mesh(params, x, cfg, "swiglu",
                                   MeshEP(dp, "data", dmesh))
        loss = (y ** 2).sum() + aux["load_balance"] + aux["router_z"]
        torch.autograd.grad(loss, leaves)
    m = cm.metrics()
    return dict(flops=m.flops, coll=m.coll, collectives=dict(COLLECTIVES),
                groups=groups.seen, y=(tuple(y.shape), y.placements))


def _expert_flops(T_loc: int, moe: dict) -> int:
    """The swiglu expert products of one rank, forward and backward: 3
    matmuls of (E_loc, n_shards * C, D) x (D, ff), each 3 times; E_loc *
    n_shards = E."""
    rows = _capacity(T_loc, moe) * moe["n_experts"]
    return 9 * 2 * rows * D * moe["d_ff_expert"]


def test_layer_count_equals_gloo_ranks(tmp_path):
    """(a) On a (2, 1) mesh the dry run's count of the routed layer is
    rank 0's count of the real `apply_moe_ep` on 2 gloo ranks: FLOPs
    exactly, all-to-all bytes those its `COLLECTIVES` counts (4
    exchanges of E * C * D f32)."""
    ranks = spawn(moe_ep_count_rank, 2, str(tmp_path), MoEConfig(**MOE),
                  "swiglu", B, S, D)
    dry = _spawned(_ep_layer, (2, 1), ("data", "model"))
    real = ranks[0]
    C = _capacity(B * S // 2, MOE)
    a2a = MOE["n_experts"] * C * D * 4
    assert real["collectives"]["all_to_all"] == 4
    assert real["collectives"]["all_to_all_bytes"] == 4 * a2a
    assert real["coll"]["all-to-all"] == 4 * a2a
    assert dry["collectives"]["all_to_all"] == 4
    assert dry["flops"] == real["flops"] > _expert_flops(B * S // 2, MOE)
    assert dry["coll"]["all-to-all"] == real["coll"]["all-to-all"]
    assert dry["y"][0] == (B, S, D)


def test_model_axis_halves_the_expert_products():
    """(b) On (2, 2) each expert's d_ff is split over "model": the expert
    (and shared) products cost half, the partial sums of the expert
    output (forward) and of its input's gradient (backward) are reduced
    over "model", and no expert weight is gathered: only the router and
    the shared experts, replicated over "data" as the reference's
    in_specs ask, the shared ones keeping their "model" shards."""
    one = _spawned(_ep_layer, (2, 1), ("data", "model"))
    two = _spawned(_ep_layer, (2, 2), ("data", "model"))
    T_loc = B * S // 2
    C = _capacity(T_loc, MOE)
    ff, E = MOE["d_ff_expert"], MOE["n_experts"]
    shared = 9 * 2 * T_loc * D * ff             # n_shared = 1, swiglu
    assert one["flops"] - two["flops"] == (
        _expert_flops(T_loc, MOE) + shared) // 2
    reduced = {(s, n) for op, n, s in two["groups"]
               if op == "_c10d_functional::all_reduce"}
    assert ((4, 2 * C, D), 2) in reduced         # E_loc x (2 C) x D
    assert two["coll"]["all-reduce"] - one["coll"]["all-reduce"] >= \
        2 * 4 * 2 * C * D * 4
    gathered = [s for op, n, s in two["groups"]
                if op == "_c10d_functional::all_gather_into_tensor"]
    assert gathered and all(len(s) == 2 for s in gathered)
    assert two["coll"]["all-gather"] == (D * E + 3 * D * ff // 2) * 4
    assert one["coll"]["all-gather"] == (D * E + 3 * D * ff) * 4
    assert two["coll"]["all-to-all"] == one["coll"]["all-to-all"]


def test_multi_pod_aux_mean_and_expert_reshard():
    """(e) On (2, 2, 2) ("pod", "data", "model"): the all-to-alls run over
    "data" (2 ranks), the aux losses' mean over pod x data (4 ranks, one
    all-reduce each way per term), and each expert weight, E over
    ("pod", "data") in the params, is resharded to E over "data" (E_loc
    = 4 experts) before the block: at least the experts a rank lacks are
    gathered, each gather counted."""
    out = _spawned(_ep_layer, (2, 2, 2), ("pod", "data", "model"))
    a2a = [(n, s) for op, n, s in out["groups"]
           if op == "_c10d_functional::all_to_all_single"]
    C = _capacity(B * S // 4, MOE)
    assert a2a == [(2, (2, 4, C, D))] * 4
    aux = [n for op, n, s in out["groups"]
           if op == "_c10d_functional::all_reduce_"]
    assert aux == [4] * 4
    ff_loc = MOE["d_ff_expert"] // 2
    experts = [s for op, n, s in out["groups"]
               if op == "_c10d_functional::all_gather_into_tensor"
               and len(s) == 3]
    assert experts and all(s[1:] in ((D, ff_loc), (ff_loc, D))
                           for s in experts)
    assert sum(s[0] for s in experts) >= 3 * 4
    assert out["collectives"]["all_to_all_bytes"] == 4 * 8 * C * D * 4


# ------------------------------------------------------- whole dry-run steps
def _ep_cfg(n_experts: int):
    """Reduced deepseek-v3 (MLA) with one dense and two routed layers."""
    base = get_config("deepseek-v3-671b").reduced()
    return dataclasses.replace(
        base, segments=(Segment("attn", 1), Segment("moe", 2)), n_layers=3,
        moe=dataclasses.replace(base.moe, n_experts=n_experts,
                                capacity_factor=1.5))


def _steps(kind: str, n_experts: int, with_probes: bool) -> dict:
    """On a (2, 2) mesh in the FSDP + TP regime (deepseek-v3's at full
    width): the step's count with and without `ep`, the EP block's
    exchanges, and (with_probes) the probe identity under `ep`."""
    from repro_torch.analysis.calibration import probe_configs, \
        probe_identity
    from repro_torch.launch import dryrun
    from repro_torch.sharding import COLLECTIVES, reset_collectives
    from repro_torch.sharding.compat import abstract_mesh, device_mesh

    torch.set_num_threads(1)
    mesh = abstract_mesh((2, 2), ("data", "model"))
    dmesh = device_mesh(mesh)
    cfg, shape = _ep_cfg(n_experts), SHAPES[kind]
    out = {}
    for ep in (False, True):
        reset_collectives()
        m, _ = dryrun.run_step(cfg, shape, mesh, dmesh, ep=ep,
                               force_small=False)
        out[ep] = dict(flops=m.flops, bytes=m.bytes, coll=m.coll,
                       a2a=COLLECTIVES["all_to_all"],
                       a2a_bytes=COLLECTIVES["all_to_all_bytes"])
        if ep and with_probes:
            count = lambda c: dryrun.run_step(c, shape, mesh, dmesh,
                                              ep=True, force_small=False)[0]
            probes = [(count(c1), count(c2), n)
                      for _, c1, c2, n in probe_configs(cfg)]
            out["identity"] = probe_identity(m, probes)
    return out


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_ep_step_keeps_the_probe_identity(kind):
    """(c) A train and a prefill pair under `ep`: every routed layer
    exchanges its E * C * d tokens twice (and twice more in the backward
    and again in remat's recompute), and the count is the 1-layer probe
    plus the other layers' bodies."""
    out = _spawned(_steps, kind, 8, True)
    ep = out[True]
    shape = SHAPES[kind]
    C = _capacity(shape.global_batch // 2 * shape.seq_len, MOE)
    each = 8 * C * _ep_cfg(8).d_model * 4
    per_layer = 6 if kind == "train" else 2
    assert ep["a2a"] == 2 * per_layer
    assert ep["a2a_bytes"] == 2 * per_layer * each
    assert out[False]["a2a"] == 0
    assert out["identity"]["ok"], out["identity"]
    assert ep["coll"]["all-to-all"] >= ep["a2a_bytes"]


@pytest.mark.parametrize("kind,n_experts", [("train", 3), ("prefill", 3),
                                            ("decode", 8)])
def test_row_local_pairs_count_as_without_ep(kind, n_experts):
    """(d) Where the reference declares no EP context (experts that do
    not divide "data", and every decode pair) `ep` changes nothing."""
    out = _spawned(_steps, kind, n_experts, False)
    assert out[True] == out[False]
    assert out[True]["a2a"] == 0


# --------------------------------------------------------------- the seams
def _unkinded_collectives() -> dict:
    """On a (2, 2) fake-group mesh: the port's collectives take `meta`
    tensors, and `CostMode` refuses a c10d collective and a functional
    one it has no kind for."""
    import torch.distributed as dist

    from repro_torch.launch.dryrun import CostMode
    from repro_torch.sharding.compat import (
        abstract_mesh,
        all_reduce_mean,
        all_to_all,
        backend_for,
        device_mesh,
    )

    dmesh = device_mesh(abstract_mesh((2, 2), ("data", "model")))
    group = dmesh["data"].get_group()
    t = torch.empty(4, 3, device="meta")
    out = {"backend": backend_for(t, group)}
    cm = CostMode()
    with cm:
        out["a2a"] = tuple(all_to_all(t, group).shape)
        out["mean"] = tuple(all_reduce_mean(t, group).shape)
    out["coll"] = cm.metrics().coll
    for name, call in (
            ("c10d", lambda: dist.all_reduce(t, group=group)),
            ("functional", lambda: torch.ops._c10d_functional.broadcast(
                t, 0, group.group_name))):
        try:
            with CostMode():
                call()
            out[name] = None
        except KeyError as e:
            out[name] = str(e)
    return out


def test_cost_mode_refuses_a_collective_without_a_kind():
    """(f) A collective op that `analysis.collectives` has no kind for
    raises where `CostMode` meets it (a c10d op would otherwise count as
    an ordinary op's bytes and no collective bytes)."""
    out = _spawned(_unkinded_collectives)
    assert out["backend"] == "fake"
    assert out["a2a"] == out["mean"] == (4, 3)
    assert out["coll"] == {"all-to-all": 48.0, "all-reduce": 48.0}
    assert "c10d::allreduce_" in out["c10d"]
    assert "_c10d_functional::broadcast" in out["functional"]


def _cli_reduced(argv):
    """`dryrun.main(argv)` with deepseek-v3's config reduced (16 experts,
    one dense and two routed layers): the production meshes at a size a
    test can run."""
    from repro_torch.launch import dryrun

    base = _ep_cfg(16)
    dryrun.get_config = lambda arch: base
    return dryrun.main(argv)


def test_cli_ep_pair_is_ok(tmp_path):
    path = str(tmp_path / "dryrun.json")
    rc = _spawned(_cli_reduced, ["--arch", "deepseek-v3-671b", "--shape",
                                 "train_4k", "--ep", "--out", path])
    assert rc == 0
    (r,) = json.load(open(path))
    assert (r["status"], r["mesh"]) == ("ok", "16x16")
    assert r["calibration"].startswith("probe-checked")
    # The reduced model trains in the pure-DP regime: 256 rows of 4096
    # over all 256 devices, T_loc = 4,096.
    C = round(4096 * 2 * 1.5 / 16)
    assert r["ep_all_to_all"] == 6 * 2
    assert r["ep_all_to_all_bytes"] == 12 * 16 * C * _ep_cfg(16).d_model * 4
    assert r["collective_bytes"]["all-to-all"] >= r["ep_all_to_all_bytes"]
