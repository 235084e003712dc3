"""Inter-satellite communications subsystem (port of `repro.comms`).

Turns the seed's free, instantaneous relay hand-off into a physical
communications layer, in four pieces:

  * `links`        — link-rate models: `ConstantRate` (seed back-compat)
                     and `LinkBudget` (FSPL + Shannon rate vs slant range);
  * `isl`          — ISL topology for Walker-Star (intra-plane ring +
                     optional cross-plane) and chunked per-edge
                     contact-window extraction on the device;
  * `contact_plan` — ground passes + ISL windows compiled into one
                     rate-annotated, queryable `ContactPlan`;
  * `routing`      — store-and-forward earliest-arrival (contact-graph
                     style) routing with bounded hops;
  * `codec`        — uplink transfer codecs (identity / quant_int8 /
                     quant_fp8 / topk_sparse): wire pricing AND the
                     lossy delta transform on the real training path.

`repro_torch.core.selection` plans relayed uploads against a
`ContactPlan`, and `repro_torch.core.spaceify(..., isl=True)` exposes the
ISL-enabled algorithm variants (`*_isl`) that `repro_torch.sim.engine`
executes.
"""
from repro_torch.comms.contact_plan import (
    ContactOutlook,
    ContactPlan,
    ContactWindow,
    build_contact_plan,
)
from repro_torch.comms.isl import (
    DEFAULT_ISL_MAX_RANGE_KM,
    ISLTopology,
    ISLWindows,
    compute_isl_windows,
    isl_visibility_grid,
)
from repro_torch.comms.codec import (
    CODECS,
    IdentityCodec,
    QuantFP8Codec,
    QuantInt8Codec,
    TopKSparseCodec,
    TransferCodec,
    codec_names,
    get_codec,
    register_codec,
    round_trip_bytes,
)
from repro_torch.comms.links import ConstantRate, LinkBudget, LinkModel
from repro_torch.comms.routing import Route, earliest_arrival

__all__ = [
    "CODECS",
    "TransferCodec",
    "IdentityCodec",
    "QuantInt8Codec",
    "QuantFP8Codec",
    "TopKSparseCodec",
    "codec_names",
    "get_codec",
    "register_codec",
    "round_trip_bytes",
    "ConstantRate",
    "LinkBudget",
    "LinkModel",
    "ISLTopology",
    "ISLWindows",
    "DEFAULT_ISL_MAX_RANGE_KM",
    "compute_isl_windows",
    "isl_visibility_grid",
    "ContactOutlook",
    "ContactPlan",
    "ContactWindow",
    "build_contact_plan",
    "Route",
    "earliest_arrival",
]
