"""The port's partition specs against the reference's, leaf for leaf.

Every LM architecture at full width, on both production meshes and on
(4, 4): the reference's trees come from `jax.eval_shape` on
`repro.sharding.abstract_mesh`, the port's from its own init and prefill
on the `meta` device (no memory, no compute). `placements` is held to
what DTensor makes of a spec.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_config as ref_get_config
from repro.configs import lm_arch_ids
from repro.models.lm.transformer import init_params as ref_init_params
from repro.models.lm.transformer import prefill as ref_prefill
from repro.sharding import abstract_mesh as ref_abstract_mesh
from repro.sharding import specs as ref_specs
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models.lm.transformer import init_params, prefill
from repro_torch.sharding import specs
from repro_torch.sharding.compat import abstract_mesh

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x4": ((4, 4), ("data", "model"))}
# Decode shapes' (batch, cache length); 1 x 524,288 is long_500k's.
DECODE = ((128, 32768), (1, 524288))


def _ref_flat(tree) -> dict:
    """Reference spec tree -> {path: tuple of entries}."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(spec) for path, spec in flat}


def _port_flat(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_port_flat(v, f"{prefix}{i}/"))
        return out
    assert isinstance(tree, specs.P), tree
    return {prefix[:-1]: tuple(tree)}


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    cfg = ref_get_config(arch)
    return jax.eval_shape(functools.partial(ref_init_params, cfg),
                          jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return init_params(get_config(arch), torch.Generator().manual_seed(0),
                       "meta")


@functools.lru_cache(maxsize=None)
def _ref_cache(arch, B, S):
    cfg = ref_get_config(arch)
    enc = None
    if cfg.encoder is not None:
        enc = jnp.zeros((B, cfg.encoder.n_frames, cfg.d_model),
                        jnp.dtype(cfg.dtype))
    return jax.eval_shape(
        lambda p: ref_prefill(cfg, p, jnp.zeros((B, 1), jnp.int32), S,
                              enc_embeds=enc)[1], _ref_params(arch))


@functools.lru_cache(maxsize=None)
def _port_cache(arch, B, S):
    cfg = get_config(arch)
    kw = {}
    if cfg.encoder is not None:
        kw["enc_embeds"] = torch.empty(
            (B, cfg.encoder.n_frames, cfg.d_model),
            dtype=getattr(torch, cfg.dtype), device="meta")
    return prefill(cfg, _port_params(arch),
                   torch.zeros((B, 1), dtype=torch.int64, device="meta"), S,
                   **kw)[1]


def _meshes(name):
    sizes, names = MESHES[name]
    return ref_abstract_mesh(sizes, names), abstract_mesh(sizes, names)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", lm_arch_ids())
def test_param_pspecs_equal_reference(arch, mesh_name):
    ref_mesh, mesh = _meshes(mesh_name)
    rp, pp = _ref_params(arch), _port_params(arch)
    assert specs.small_model_mode(pp, mesh) == \
        ref_specs.small_model_mode(rp, ref_mesh)
    for mode in ("train", "serve"):
        for allow in (True, False):
            want = _ref_flat(ref_specs.param_pspecs(
                rp, ref_mesh, mode=mode, allow_tp_only=allow))
            got = _port_flat(specs.param_pspecs(pp, mesh, mode=mode,
                                                allow_tp_only=allow))
            assert got == want, (mode, allow)
    # Some leaf is sharded on every mesh (the rules are not vacuous).
    got = _port_flat(specs.param_pspecs(pp, mesh, allow_tp_only=False))
    assert any(any(e is not None for e in s) for s in got.values())


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", lm_arch_ids())
def test_cache_pspecs_equal_reference(arch, mesh_name):
    ref_mesh, mesh = _meshes(mesh_name)
    for B, S in DECODE:
        if B == 1 and arch == "whisper-medium":
            continue             # long_500k skips the enc-dec model
        want = _ref_flat(ref_specs.cache_pspecs(_ref_cache(arch, B, S),
                                                ref_mesh, B))
        cache = _port_cache(arch, B, S)
        got = _port_flat(specs.cache_pspecs(cache, mesh, B))
        assert got == want, (B, S)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_pspec_equal_reference(mesh_name):
    ref_mesh, mesh = _meshes(mesh_name)
    for B in (1, 2, 4, 16, 32, 128, 256, 512, 48):
        assert specs.batch_pspec(mesh, B) == ref_specs.batch_pspec(
            ref_mesh, B), B


def test_mesh_axes_and_meshes():
    single, multi = make_production_mesh(), make_production_mesh(
        multi_pod=True)
    assert (single.axis_sizes, single.axis_names) == ((16, 16),
                                                      ("data", "model"))
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert (single.size, multi.size, make_host_mesh().size) == (256, 512, 1)
    assert specs.MeshAxes.from_mesh(multi) == specs.MeshAxes(
        ("pod", "data"), "model")
    assert specs.AUTO_TP_ONLY_BYTES == ref_specs.AUTO_TP_ONLY_BYTES


def test_partition_spec_compares_as_jax():
    P = jax.sharding.PartitionSpec
    assert specs.P(("pod", "data"), None, "model") == tuple(
        P(("pod", "data"), None, "model"))
    assert specs.P() == ()
    assert specs.P(("data",), ()) == tuple(P(("data",), ())) == ("data", None)


def test_placements():
    mesh = make_production_mesh(multi_pod=True)
    assert specs.placements(specs.P(("pod", "data"), "model"), mesh) == (
        Shard(0), Shard(0), Shard(1))
    assert specs.placements(specs.P(None, None, "model"), mesh) == (
        Replicate(), Replicate(), Shard(2))
    assert specs.placements(specs.P(), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh's order"):
        specs.placements(specs.P(("data", "pod")), mesh)
    with pytest.raises(ValueError, match="twice"):
        specs.placements(specs.P("model", "model"), mesh)
