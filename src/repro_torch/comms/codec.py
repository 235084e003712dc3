"""Transfer codecs — compressed uplinks as a first-class wire-pricing layer.

Port of `repro.comms.codec`. A `TransferCodec` owns both sides of the
uplink lever:

  * **wire pricing** — `wire_bytes(model_bytes, bytes_per_param)` is the
    bytes an encoded *uplink* (client delta return) puts on the wire;
    `encode_bytes(tree)` prices a concrete parameter/delta tree or flat
    tensor. The global-model *download* always ships full precision, so
    `round_trip_bytes(codec, hw)` — the one up+down expression shared by
    selection and the engine's async feed — is ``model_bytes +
    wire_bytes``. Pricing is plain float arithmetic, bitwise the
    reference's.
  * **the training-path effect** — `apply(delta, layout, uniforms)` runs
    the lossy encode/decode on the port's flat `(C, P)` client-delta stack
    (or one `(P,)` delta). Per-leaf codecs (int8, fp8) take each leaf's
    amax and rounding over that leaf's segment of the flat layout
    (`repro_torch.params.ParamLayout`, laid out in the reference's
    `jax.tree.flatten` order); top-k works on the whole row.

Stochastic rounding consumes one float32 uniform per parameter, passed in
as a `(C, P)` tensor: the engine draws it from its sampler once per codec
round-trip (`sampler.codec_uniforms`), so a sampler that replays the
reference's per-client keys — `fold_in(client_key, CODEC_RNG_TAG)`, split
per leaf — reproduces the reference's rounding, and the default
`TorchSampler` draws them from its own generator. On identical deltas and
uniforms the identity, int8 and top-k codecs are bitwise the reference's;
fp8 takes `floor(log2(.))`, whose last bit may differ between libraries
where `log2` lands within an ulp of an integer.

`CODECS` is an open registry: `get_codec()` resolves names with the
vocabulary on error, `register_codec()` adds entries.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.orbits import constants as C

# Domain tag the reference folds into each client's training key to derive
# its codec (stochastic-rounding) key; a replaying sampler uses it.
CODEC_RNG_TAG = 0x5EC0DE


def _tree_params(tree) -> int:
    """Parameter count of a nested dict of arrays or of one flat tensor."""
    if isinstance(tree, dict):
        return sum(_tree_params(v) for v in tree.values())
    return int(math.prod(tree.shape))


def _stochastic_round(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Unbiased round-to-integer: floor + Bernoulli(frac) carry, with the
    Bernoulli draw `u < frac` on the given uniforms."""
    lo = torch.floor(x)
    return lo + (u < (x - lo)).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class TransferCodec:
    """Identity codec — the bitwise back-compat default.

    Subclasses override `wire_ratio` (uplink bytes per full-precision
    byte) and `_apply_leaf` (the lossy transform of one leaf's segment);
    `apply` walks the layout's leaves for all of them.
    """

    name = "identity"
    lossy = False        # whether `apply` changes the delta
    stochastic = False   # whether `apply` consumes uniforms (rounding)

    # --- wire pricing ---------------------------------------------------
    def wire_ratio(self, bytes_per_param: int = C.BYTES_PER_PARAM) -> float:
        """Encoded uplink bytes per full-precision wire byte."""
        return 1.0

    def wire_bytes(self, model_bytes: float,
                   bytes_per_param: int = C.BYTES_PER_PARAM) -> float:
        """Bytes one encoded uplink (client delta return) puts on the
        wire, given the full-precision transfer size. Relay routing
        multiplies this per store-and-forward leg."""
        return float(model_bytes) * self.wire_ratio(bytes_per_param)

    def encode_bytes(self, tree,
                     bytes_per_param: int = C.BYTES_PER_PARAM) -> float:
        """Wire bytes for a concrete parameter/delta tree or flat tensor."""
        return self.wire_bytes(_tree_params(tree) * bytes_per_param,
                               bytes_per_param)

    # --- the training-path effect ---------------------------------------
    def _apply_leaf(self, x: torch.Tensor, u: torch.Tensor | None
                    ) -> torch.Tensor:
        return x

    def apply(self, delta: torch.Tensor, layout,
              uniforms: torch.Tensor | None = None) -> torch.Tensor:
        """Lossy encode/decode of a flat client-delta stack (..., P).

        `layout` splits the last axis into the model's leaves; `uniforms`
        (same shape as `delta`) drive stochastic rounding. The identity
        codec returns `delta` itself."""
        if not self.lossy:
            return delta
        if self.stochastic and (uniforms is None
                                or uniforms.shape != delta.shape):
            raise ValueError(
                f"codec {self.name!r} needs uniforms of shape "
                f"{tuple(delta.shape)}")
        xs = torch.split(delta, layout.sizes, dim=-1)
        us = (torch.split(uniforms, layout.sizes, dim=-1)
              if uniforms is not None else (None,) * len(xs))
        return torch.cat([self._apply_leaf(x, u) for x, u in zip(xs, us)],
                         dim=-1)


IdentityCodec = TransferCodec


@dataclasses.dataclass(frozen=True)
class QuantInt8Codec(TransferCodec):
    """Per-leaf symmetric int8 quantization with stochastic rounding.

    Each leaf ships one f32 scale (`max|x| / 127`) plus one signed byte
    per parameter; `apply` is the quantize -> dequantize round trip, so
    the absolute error per element is bounded by one quantization step
    (`max|x| / 127` of its leaf)."""

    name = "quant_int8"
    lossy = True
    stochastic = True
    levels: int = 127            # symmetric: values land in [-127, 127]

    def wire_ratio(self, bytes_per_param: int = C.BYTES_PER_PARAM) -> float:
        return 1.0 / bytes_per_param

    def _apply_leaf(self, x, u):
        amax = x.abs().amax(dim=-1, keepdim=True)
        # amax * f32(1 / levels), not amax / levels: the reference's jitted
        # round trip computes its division by the constant so (XLA rewrites
        # a division by a constant as a product with its reciprocal).
        scale = torch.where(amax > 0, amax * (1.0 / self.levels),
                            torch.ones_like(amax))
        q = torch.clamp(_stochastic_round(x / scale, u),
                        -self.levels, self.levels)
        return q * scale


@dataclasses.dataclass(frozen=True)
class QuantFP8Codec(TransferCodec):
    """E4M3-style fp8 quantization with stochastic rounding.

    Per-leaf normalization to `max|x|`, then each element rounds onto a
    3-mantissa-bit grid whose exponent is clipped to the e4m3 dynamic
    range; dequantization rescales. Relative error per element is bounded
    by one mantissa step (2^-3) inside the dynamic range; values below it
    flush toward zero like fp8 subnormals."""

    name = "quant_fp8"
    lossy = True
    stochastic = True
    mantissa_bits: int = 3
    exp_min: int = -6            # e4m3 subnormal floor (pre-normalized)
    exp_max: int = 8

    def wire_ratio(self, bytes_per_param: int = C.BYTES_PER_PARAM) -> float:
        return 1.0 / bytes_per_param

    def _apply_leaf(self, x, u):
        amax = x.abs().amax(dim=-1, keepdim=True)
        scale = torch.where(amax > 0, amax, torch.ones_like(amax))
        v = x / scale            # normalized to [-1, 1]
        mag = v.abs()
        e = torch.clamp(torch.floor(torch.log2(torch.clamp(
            mag, min=2.0 ** -30))), self.exp_min, self.exp_max)
        step = torch.exp2(e - self.mantissa_bits)
        q = _stochastic_round(v / step, u) * step
        return q * scale


@dataclasses.dataclass(frozen=True)
class TopKSparseCodec(TransferCodec):
    """Global top-k magnitude sparsification of each client's delta.

    Keeps the `frac` largest-|value| entries across the whole row (kept
    values ship exactly; the rest zero). The wire carries each survivor's
    full-precision value plus an `index_bytes` position, so the priced
    ratio is ``frac * (1 + index_bytes / bytes_per_param)``. Ties at the
    threshold magnitude are all kept (the mask is `|x| >= threshold`)."""

    name = "topk_sparse"
    lossy = True
    frac: float = 0.1
    index_bytes: int = 4

    def __post_init__(self):
        if not 0.0 < self.frac <= 1.0:
            raise ValueError(
                f"codec {self.name!r}: frac must be in (0, 1], "
                f"got {self.frac}")

    def wire_ratio(self, bytes_per_param: int = C.BYTES_PER_PARAM) -> float:
        return self.frac * (1.0 + self.index_bytes / bytes_per_param)

    def apply(self, delta, layout, uniforms=None):
        del layout, uniforms     # deterministic, over the whole row
        mag = delta.abs()
        k = max(1, int(round(self.frac * delta.shape[-1])))
        thr = torch.topk(mag, k, dim=-1).values[..., -1:]
        return torch.where(mag >= thr, delta, torch.zeros_like(delta))


# ======================================================================= #
# Registry + the shared pricing/training helpers
# ======================================================================= #
CODECS: dict[str, TransferCodec] = {
    "identity": IdentityCodec(),
    "quant_int8": QuantInt8Codec(),
    "quant_fp8": QuantFP8Codec(),
    "topk_sparse": TopKSparseCodec(),
}


def register_codec(codec: TransferCodec, *,
                   overwrite: bool = False) -> TransferCodec:
    """Add a codec to the open registry (duplicate names refused unless
    `overwrite=True`). Returns `codec` so registration can inline."""
    if codec.name in CODECS and not overwrite:
        raise ValueError(
            f"codec {codec.name!r} is already registered; pass "
            "overwrite=True to replace it")
    CODECS[codec.name] = codec
    return codec


def get_codec(codec: str | TransferCodec | None) -> TransferCodec:
    """Resolve a registry name (or pass a TransferCodec through; None is
    the identity). Unknown names raise a KeyError listing the registered
    vocabulary."""
    if codec is None:
        return CODECS["identity"]
    if isinstance(codec, TransferCodec):
        return codec
    if codec not in CODECS:
        raise KeyError(
            f"unknown codec {codec!r}; registered codecs: {codec_names()}")
    return CODECS[codec]


def codec_names() -> list[str]:
    """Sorted names of every registered codec."""
    return sorted(CODECS)


def round_trip_bytes(codec: TransferCodec | None, hw) -> float:
    """The one up+down wire-cost expression for a direct (no-relay) round
    trip: full-precision download + codec-priced uplink. With no codec
    this is exactly the seed's ``2.0 * hw.model_bytes``."""
    if codec is None:
        return 2.0 * hw.model_bytes
    return float(hw.model_bytes) + codec.wire_bytes(
        hw.model_bytes, getattr(hw, "bytes_per_param", C.BYTES_PER_PARAM))


def client_roundtrip(codec: TransferCodec, params: torch.Tensor,
                     anchors: torch.Tensor, layout,
                     uniforms: torch.Tensor | None = None) -> torch.Tensor:
    """The client returns as the server reconstructs them after decode:
    delta against each client's anchor ((C, P) stack, or one (P,) anchor
    broadcast), `codec.apply` on the delta, anchor + lossy delta."""
    lossy = codec.apply(params - anchors, layout, uniforms)
    return anchors + lossy
