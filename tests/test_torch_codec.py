"""Port uplink codecs (`repro_torch.comms.codec`) vs the reference.

The lossy transforms run on identical deltas and identical uniforms: the
reference draws its stochastic-rounding uniforms from per-client keys
inside `TransferCodec.apply`; the port takes them as a tensor, replayed
from the same keys by `torch_parity.replay_codec_uniforms`. On that input
`identity`, `quant_int8` and `topk_sparse` must match bitwise: every
operation (abs, max, one f32 division, floor, compare, one f32 product,
top-k selection) is exactly rounded in both libraries. `quant_fp8` also
takes `floor(log2(.))`, which may differ in its last bit between XLA and
torch; a differing element is allowed only where `log2` lands within one
ulp of an integer, and only by one quantization step. Wire pricing and
the `HardwareModel` codec pricing are plain float arithmetic: bitwise.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comms import codec as jcodec
from repro.core.timing import HardwareModel as JaxHardwareModel
from repro_torch.comms import codec
from repro_torch.core.timing import HardwareModel
from repro_torch.params import FEMNIST_MLP, ParamLayout
from repro_torch.sim import TorchSampler
from torch_parity import replay_codec_uniforms

# An odd layout: leaves of 3, 20 and 7 elements, nested like a model.
SMALL = ParamLayout((("a/b", (3,)), ("a/w", (4, 5)), ("z", (7,))))
NAMES = ("identity", "quant_int8", "quant_fp8", "topk_sparse")


def _tree(layout: ParamLayout, C: int, seed: int, scale: float = 0.01
          ) -> dict:
    """Seeded per-client delta tree with the layout's leaves."""
    rs = np.random.default_rng(seed)
    out: dict = {}
    for path, shape in layout.leaves:
        *parents, name = path.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = (rs.standard_normal((C,) + shape) * scale).astype(
            np.float32)
    return out


def _ref_apply(name: str, tree: dict, rngs) -> torch.Tensor:
    """The reference codec jitted and vmapped over clients, as the engine
    runs it."""
    out = jax.jit(jax.vmap(jcodec.CODECS[name].apply))(
        jax.tree.map(jnp.asarray, tree), rngs)
    return jax.device_get(out)


def _port_apply(name: str, tree: dict, rngs, layout: ParamLayout):
    flat = layout.from_tree(tree, device="cpu")
    c = codec.CODECS[name]
    u = (torch.as_tensor(replay_codec_uniforms(rngs, layout))
         if c.stochastic else None)
    return c.apply(flat, layout, u), flat, u


def test_registry_matches_reference():
    assert codec.codec_names() == jcodec.codec_names()
    assert codec.CODEC_RNG_TAG == jcodec.CODEC_RNG_TAG
    for name in NAMES:
        mine, ref = codec.get_codec(name), jcodec.get_codec(name)
        assert type(mine).__name__ == type(ref).__name__
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.lossy == ref.lossy
    assert codec.get_codec(None) is codec.CODECS["identity"]
    with pytest.raises(KeyError, match="registered codecs"):
        codec.get_codec("gzip")
    with pytest.raises(ValueError, match="frac"):
        codec.TopKSparseCodec(frac=0.0)
    with pytest.raises(ValueError, match="already registered"):
        codec.register_codec(codec.QuantInt8Codec())


@pytest.mark.parametrize("name", NAMES)
def test_wire_pricing_bitwise(name):
    mine, ref = codec.CODECS[name], jcodec.CODECS[name]
    tree = _tree(SMALL, 1, 0)
    for bpp in (1, 2, 4):
        assert mine.wire_ratio(bpp) == ref.wire_ratio(bpp)
        for mb in (186_000, 186_556.0, 3):
            assert mine.wire_bytes(mb, bpp) == ref.wire_bytes(mb, bpp)
        assert mine.encode_bytes(tree, bpp) == ref.encode_bytes(tree, bpp)
        flat = SMALL.from_tree(tree, device="cpu")
        assert mine.encode_bytes(flat, bpp) == ref.encode_bytes(tree, bpp)
    for hw in (HardwareModel(), HardwareModel(model_bytes=186_556,
                                              bytes_per_param=2)):
        jhw = JaxHardwareModel(model_bytes=hw.model_bytes,
                               bytes_per_param=hw.bytes_per_param)
        assert codec.round_trip_bytes(mine, hw) == \
            jcodec.round_trip_bytes(ref, jhw)
        assert codec.round_trip_bytes(None, hw) == \
            jcodec.round_trip_bytes(None, jhw)


@pytest.mark.parametrize("layout,C,seed", [(FEMNIST_MLP, 3, 0),
                                           (SMALL, 5, 1)],
                         ids=["femnist_mlp", "small"])
@pytest.mark.parametrize("name", ["identity", "quant_int8", "topk_sparse"])
def test_apply_bitwise_on_identical_deltas_and_uniforms(name, layout, C,
                                                        seed):
    tree = _tree(layout, C, seed)
    rngs = jax.random.split(jax.random.PRNGKey(seed + 7), C)
    mine, flat, _ = _port_apply(name, tree, rngs, layout)
    want = layout.from_tree(_ref_apply(name, tree, rngs), device="cpu")
    assert torch.equal(mine, want)
    if name == "identity":
        assert mine is flat
    else:
        assert not torch.equal(mine, flat)


def test_quant_fp8_differs_only_on_log2_ties():
    """Elements may differ by one quantization step only where the
    reference's log2 of the normalized magnitude is within one f32 ulp of
    an integer (where `floor` can land on either side)."""
    C = 4
    tree = _tree(FEMNIST_MLP, C, 2)
    rngs = jax.random.split(jax.random.PRNGKey(11), C)
    mine, flat, _ = _port_apply("quant_fp8", tree, rngs, FEMNIST_MLP)
    want = FEMNIST_MLP.from_tree(_ref_apply("quant_fp8", tree, rngs),
                                 device="cpu")
    diff = mine != want
    print(f"quant_fp8: {int(diff.sum())} of {diff.numel()} elements differ")
    if not diff.any():
        return
    # Recompute the normalized magnitude per leaf as the codec does.
    segs = torch.split(flat, FEMNIST_MLP.sizes, dim=-1)
    v = torch.cat([s / s.abs().amax(-1, keepdim=True) for s in segs], -1)
    lg = torch.log2(v.abs().clamp(min=2.0 ** -30))
    near = (lg - lg.round()).abs() <= torch.finfo(torch.float32).eps * \
        lg.abs().clamp(min=1.0)
    assert bool(near[diff].all())
    step = torch.exp2(torch.floor(lg) - 3) * torch.cat(
        [s.abs().amax(-1, keepdim=True).expand_as(s) for s in segs], -1)
    assert bool(((mine - want).abs()[diff] <= 2 * step[diff] * 1.0001).all())


def test_topk_keeps_every_tie_and_the_reference_count():
    """Ties at the threshold magnitude are all kept (mask |x| >= thr), on
    the whole row across leaves, like the reference."""
    tree = {"a": {"b": np.array([[0.5, -0.5, 0.1]], np.float32),
                  "w": np.zeros((1, 4, 5), np.float32)},
            "z": np.array([[0.5, 0.2, -0.3, 0.0, 0.0, 0.0, 0.0]],
                          np.float32)}
    tree["a"]["w"][0, 0, 0] = -0.5
    rngs = jax.random.split(jax.random.PRNGKey(0), 1)
    mine, _, _ = _port_apply("topk_sparse", tree, rngs, SMALL)
    want = SMALL.from_tree(_ref_apply("topk_sparse", tree, rngs),
                           device="cpu")
    assert torch.equal(mine, want)
    assert int((mine != 0).sum()) == 4      # k = 3, a 4-way tie at 0.5


def test_client_roundtrip_bitwise():
    """anchor + codec(params - anchor), per-client anchors and a shared
    broadcast anchor, against the reference's `client_roundtrip`: bitwise
    against it run op by op. Jitted (as the reference engine runs it),
    XLA contracts `anchor + q * scale` into one fused multiply-add, one
    rounding where the port's separate ops round twice (the product, then
    the sum): there the two differ by at most one f32 ulp of the result
    plus one of the product `q * scale`."""
    C = 3
    params = _tree(FEMNIST_MLP, C, 4, scale=0.1)
    anchors = _tree(FEMNIST_MLP, C, 5, scale=0.1)
    shared = jax.tree.map(lambda a: a[0], anchors)
    rngs = jax.random.split(jax.random.PRNGKey(2), C)
    u = torch.as_tensor(replay_codec_uniforms(rngs, FEMNIST_MLP))
    p = FEMNIST_MLP.from_tree(params, device="cpu")
    int8 = codec.CODECS["quant_int8"]
    one = jcodec.client_roundtrip(jcodec.CODECS["quant_int8"])
    for anc, axis in ((anchors, 0), (shared, None)):
        args = (jax.tree.map(jnp.asarray, params),
                jax.tree.map(jnp.asarray, anc), rngs)
        op_by_op = jax.device_get(jax.vmap(one, in_axes=(0, axis, 0))(*args))
        jitted = jax.device_get(
            jax.jit(jax.vmap(one, in_axes=(0, axis, 0)))(*args))
        a = FEMNIST_MLP.from_tree(anc, device="cpu")
        got = codec.client_roundtrip(int8, p, a, FEMNIST_MLP, u)
        assert torch.equal(got, FEMNIST_MLP.from_tree(op_by_op,
                                                      device="cpu"))
        fused = FEMNIST_MLP.from_tree(jitted, device="cpu")
        lossy = int8.apply(p - a, FEMNIST_MLP, u)
        ulps = torch.finfo(torch.float32).eps * (fused.abs() + lossy.abs())
        assert bool(((got - fused).abs() <= ulps).all())


def test_stochastic_codecs_need_uniforms_of_the_delta_shape():
    flat = torch.zeros((2, SMALL.size))
    for name in ("quant_int8", "quant_fp8"):
        with pytest.raises(ValueError, match="uniforms"):
            codec.CODECS[name].apply(flat, SMALL)
        with pytest.raises(ValueError, match="uniforms"):
            codec.CODECS[name].apply(flat, SMALL, torch.zeros((1, 30)))
        # An all-zero delta stays zero (scale 1, floor of 0).
        out = codec.CODECS[name].apply(flat, SMALL, torch.rand(flat.shape))
        assert torch.equal(out, flat)


def test_torch_sampler_codec_uniforms():
    s = TorchSampler(0, "cpu")
    u = s.codec_uniforms(3, FEMNIST_MLP)
    assert u.shape == (3, FEMNIST_MLP.size) and u.dtype == torch.float32
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert not torch.equal(u, s.codec_uniforms(3, FEMNIST_MLP))


@pytest.mark.parametrize("name", (None,) + NAMES)
def test_hardware_model_codec_pricing_bitwise(name):
    mine_c = None if name is None else codec.get_codec(name)
    ref_c = None if name is None else jcodec.get_codec(name)
    for kw in (dict(), dict(model_bytes=186_556, bytes_per_param=2,
                            link_mbps=123.0)):
        mine = HardwareModel(codec=mine_c, **kw)
        ref = JaxHardwareModel(codec=ref_c, **kw)
        for attr in ("tx_time_s", "uplink_bytes", "ul_time_s",
                     "round_trip_bytes", "epoch_time_s"):
            assert getattr(mine, attr) == getattr(ref, attr), attr
        for rate in (None, 1e6, 580e6, 0.25):
            assert mine.ul_time_for(rate) == ref.ul_time_for(rate)
            assert mine.tx_time_for(rate_bps=rate) == \
                ref.tx_time_for(rate_bps=rate)
            assert mine.tx_time_for(1234.5, rate) == \
                ref.tx_time_for(1234.5, rate)
    if name is None:
        assert HardwareModel() == HardwareModel.for_workload("femnist_mlp")
    mine = HardwareModel.for_workload("femnist_mlp", codec=name)
    ref = JaxHardwareModel.for_workload("femnist_mlp", codec=name)
    assert (mine.model_bytes, mine.bytes_per_param, mine.uplink_bytes,
            mine.round_trip_bytes, mine.ul_time_s) == \
        (ref.model_bytes, ref.bytes_per_param, ref.uplink_bytes,
         ref.round_trip_bytes, ref.ul_time_s)
    assert (mine.codec is None) == (ref.codec is None)
