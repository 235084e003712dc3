"""The dry run (`repro_torch.launch.dryrun`) at a small size, on one
device (no process group): the count is `FlopCounterMode`'s over the
same plain step and the 1-layer probe plus (L - 1) bodies, and a full-
width pair carries the reference's keys. Also the `meta` seams: the
kernels' plain versions (no launch counted, the scans' chunk-batched
forms FLOP for FLOP the loops') and the hints, which leave plain tensors
alone. The meshes of DTensors are `test_torch_dryrun_mesh.py`'s.
"""
from __future__ import annotations

import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis.calibration import probe_configs, probe_identity
from repro_torch.configs import get_config
from repro_torch.configs.shapes import InputShape
from repro_torch.kernels import ops, ref
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.lm.params import tree_leaves
from repro_torch.models.lm.transformer import init_params
from repro_torch.optim.adam import adam_init
from repro_torch.sharding import ctx
from repro_torch.sharding.specs import small_model_mode
from repro_torch.train.step import (
    make_prefill_step,
    make_serve_step,
    make_train_step,
)

SHAPES = {"train": InputShape("t", 64, 8, "train"),
          "prefill": InputShape("p", 64, 8, "prefill"),
          "decode": InputShape("d", 96, 8, "decode")}


def _cfg(arch: str = "hymba-1.5b", n_layers: int = 3):
    """A narrow config of `arch`'s family, `n_layers` deep (hymba's: a
    full-attention layer, then windowed ones: two segments)."""
    return get_config(arch).reduced(n_layers=n_layers)


def _plain_flops(cfg, shape) -> int:
    """`FlopCounterMode`'s count of the plain step on `meta` tensors."""
    params = init_params(cfg, torch.Generator().manual_seed(0), "meta")
    batch = dryrun.input_specs(cfg, shape)
    if shape.kind == "train":
        opt = adam_init(params)
        small = small_model_mode(params, make_host_mesh())
        step = make_train_step(cfg, replicate_weights=small)
        args = (params, opt, batch)
    elif shape.kind == "prefill":
        step = make_prefill_step(cfg, max_seq=shape.seq_len)
        args = (params, batch)
    else:
        cache = dryrun._decode_cache(cfg, params, shape.global_batch,
                                     shape.seq_len)
        step = make_serve_step(cfg)
        args = (params, batch["tokens"], cache)
    with FlopCounterMode(display=False) as fc:
        step(*args)
    return fc.get_total_flops()


@pytest.mark.parametrize("kind", list(SHAPES))
def test_host_mesh_count_equals_flop_counter(kind):
    cfg = _cfg()
    m, mem = dryrun.run_step(cfg, SHAPES[kind], make_host_mesh(), None)
    assert m.flops == _plain_flops(cfg, SHAPES[kind]) > 0
    assert m.coll == {} and m.bytes > 0
    assert mem["argument_size_in_bytes"] > 0


def test_host_mesh_probe_identity_and_full_width_pair():
    cfg, shape, mesh = _cfg(), SHAPES["train"], make_host_mesh()
    full = dryrun.run_step(cfg, shape, mesh, None)[0]
    probes = [(dryrun.run_step(c1, shape, mesh, None, force_small=True)[0],
               dryrun.run_step(c2, shape, mesh, None, force_small=True)[0],
               n) for _, c1, c2, n in probe_configs(cfg)]
    assert probes and probe_identity(full, probes)["ok"]
    r = dryrun.lower_pair("gemma-2b", "decode_32k", mesh)
    assert r["status"] == "ok" and r["chips"] == 1 and r["mesh"] == "1x1"
    assert {"status", "note", "mesh", "chips", "compile_s", "memory",
            "cost_flops", "cost_bytes", "collective_bytes", "raw_cost_flops",
            "calibration", "model_flops", "roofline"} <= set(r)
    assert r["calibration"].startswith("probe-checked")
    assert r["roofline"]["compute_s"] > 0


# ----------------------------------------------------------------- seams
def test_meta_tensors_take_the_plain_versions():
    ops.reset_launches()
    m = lambda *shape: torch.empty(shape, device="meta")
    o = ops.flash_attention_op(m(2, 4, 8, 16), m(2, 2, 8, 16), m(2, 2, 8, 16))
    assert o.shape == (2, 4, 8, 16) and o.device.type == "meta"
    o, s = ops.wkv6_op(m(2, 3, 70, 8), m(2, 3, 70, 8), m(2, 3, 70, 4),
                       m(2, 3, 70, 8), m(2, 3, 8, 4), chunk=16)
    assert o.shape == (2, 3, 70, 4) and s.shape == (2, 3, 8, 4)
    assert ops.fedagg_op(m(3, 5), m(3)).shape == (5,)
    ops.prox_sgd_op(m(3, 5), m(3, 5), m(5),
                    torch.empty(3, dtype=torch.int32, device="meta"), 0,
                    0.1, 0.0)
    assert all(n == 0 for n in ops.LAUNCHES.values())


@pytest.mark.parametrize("T", [70, 64, 10])
def test_meta_scans_count_the_loops_flops(T):
    g = torch.Generator().manual_seed(0)
    B, H, K, V, chunk = 2, 3, 8, 4, 16
    r, k, lw = (torch.randn(B, H, T, K, generator=g) for _ in range(3))
    lw = -lw.abs()
    v, do = (torch.randn(B, H, T, V, generator=g) for _ in range(2))
    s0, ds = (torch.randn(B, H, K, V, generator=g) for _ in range(2))

    def count(fn):
        with FlopCounterMode(display=False) as fc:
            out = fn()
        return fc.get_total_flops(), [tuple(t.shape) for t in out]

    meta = lambda *ts: [t.to("meta") for t in ts]
    assert count(lambda: ref.wkv6_ref(r, k, v, lw, s0, chunk, True)) == \
        count(lambda: ref.wkv6_ref(*meta(r, k, v, lw, s0), chunk, True))
    states = ref.wkv6_ref(r, k, v, lw, s0, chunk, True)[2]
    for st in (states, None):
        want = count(lambda: ref.wkv6_bwd_ref(r, k, v, lw, s0, do, ds, chunk,
                                              st))
        got = count(lambda: ref.wkv6_bwd_ref(
            *meta(r, k, v, lw, s0, do, ds), chunk,
            None if st is None else st.to("meta")))
        assert got == want
    with pytest.raises(ValueError, match="meta"):
        ref._wkv6_shapes(r, k, v, lw, s0, chunk, False)


def test_hints_leave_plain_tensors_alone():
    x = torch.randn(4, 6, 8)
    kv = torch.randn(4, 1, 2, 8)
    for scope in (lambda: ctx.activation_sharding(("data", "model")),
                  lambda: ctx.activation_sharding(None)):
        with scope(), ctx.model_axis("model"):
            assert ctx.constrain_batch(x) is x
            assert ctx.constrain_batch(x, dim=1) is x
            assert ctx.constrain_kv(kv) is kv
    z = ctx.batch_zeros((3, 4, 5), x, batch_dim=1)
    assert z.dtype == x.dtype and torch.equal(z, torch.zeros(3, 4, 5))


def test_replicate_weights_is_a_no_op_on_plain_tensors():
    cfg = dataclasses.replace(_cfg("qwen1.5-4b", 2), dtype="float32")
    tokens = torch.randint(0, cfg.vocab_size, (2, 17),
                           generator=torch.Generator().manual_seed(1))
    outs = []
    for replicate in (False, True):
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        step = make_train_step(cfg, lr=1e-2, replicate_weights=replicate)
        params, opt, metrics = step(params, adam_init(params),
                                    {"tokens": tokens})
        outs.append((params, metrics))
    for a, b in zip(tree_leaves(outs[0][0]), tree_leaves(outs[1][0])):
        assert torch.equal(a, b)
    assert torch.equal(outs[0][1]["loss"], outs[1][1]["loss"])
