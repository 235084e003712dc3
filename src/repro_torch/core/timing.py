"""Satellite hardware/cost model (paper section 5 numbers as defaults).

Port of `repro.core.timing`, bitwise the reference's pricing with and
without an uplink codec. The paper assumes a SpaceCloud iX5-106 class
onboard computer (40 GFLOP/s), a 47k-parameter (186 KB) model, 98 MFLOP
per local epoch, and Planet-Dove class telemetry at 580 Mbps.
"""
from __future__ import annotations

import dataclasses

from repro_torch.comms.codec import get_codec, round_trip_bytes
from repro_torch.comms.links import MIN_RATE_BPS
from repro_torch.orbits import constants as C


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    gflops: float = C.CLIENT_GFLOPS          # onboard compute
    epoch_mflops: float = C.EPOCH_MFLOPS     # FLOPs per local epoch
    link_mbps: float = C.LINK_MBPS           # telemetry rate
    model_bytes: int = C.MODEL_BYTES         # parameters on the wire
    # Energy/duty-cycle cap on continuous training (UNTIL_CONTACT regime).
    max_local_epochs: int = 100
    # Full-precision wire width, bytes/parameter (only the codec's wire
    # pricing reads it: `model_bytes` already bakes the width in).
    bytes_per_param: int = C.BYTES_PER_PARAM
    # Uplink transfer codec (`repro_torch.comms.codec.TransferCodec`):
    # prices the client's *return* transfer (the model download always
    # ships full precision). None keeps the seed's symmetric pricing,
    # bitwise identical to the identity codec.
    codec: object | None = None

    @property
    def epoch_time_s(self) -> float:
        return (self.epoch_mflops * 1e6) / (self.gflops * 1e9)

    @property
    def tx_time_s(self) -> float:
        """One full-precision model transfer (the download direction)
        over the telemetry link."""
        return (self.model_bytes * 8) / (self.link_mbps * 1e6)

    @property
    def uplink_bytes(self) -> float:
        """Bytes one client return (uplink) puts on the wire, after the
        codec: == `model_bytes` with no codec."""
        if self.codec is None:
            return float(self.model_bytes)
        return self.codec.wire_bytes(self.model_bytes, self.bytes_per_param)

    @property
    def ul_time_s(self) -> float:
        """One codec-priced uplink at the constant telemetry rate —
        == `tx_time_s` bit for bit with no codec."""
        if self.codec is None:
            return self.tx_time_s
        return self.tx_time_for(n_bytes=self.uplink_bytes)

    def ul_time_for(self, rate_bps: float | None = None) -> float:
        """Codec-priced uplink time at a window's achievable rate."""
        return self.tx_time_for(
            n_bytes=None if self.codec is None else self.uplink_bytes,
            rate_bps=rate_bps)

    @property
    def round_trip_bytes(self) -> float:
        """Direct (no-relay) round-trip wire cost: full-precision
        download + codec-priced uplink
        (`repro_torch.comms.codec.round_trip_bytes`)."""
        return round_trip_bytes(self.codec, self)

    def tx_time_for(self, n_bytes: float | None = None,
                    rate_bps: float | None = None) -> float:
        """Transfer time for `n_bytes` at `rate_bps` (both default to the
        model's constants, so `tx_time_for()` == `tx_time_s` bit for bit),
        with the rate floored at `MIN_RATE_BPS`."""
        if n_bytes is None:
            n_bytes = self.model_bytes
        if rate_bps is None:
            rate_bps = self.link_mbps * 1e6
        return (n_bytes * 8) / max(rate_bps, MIN_RATE_BPS)

    def epochs_between(self, t0: float, t1: float, *, cap: bool = True) -> int:
        """How many whole local epochs fit in [t0, t1)."""
        n = int(max(0.0, t1 - t0) / self.epoch_time_s)
        return min(n, self.max_local_epochs) if cap else n

    @classmethod
    def for_workload(cls, workload, *, gflops: float | None = None,
                     link_mbps: float | None = None,
                     max_local_epochs: int | None = None,
                     codec=None) -> "HardwareModel":
        """Price a `repro_torch.core.workload.Workload` on the paper's
        satellite, with `codec` (a registry name or codec) pricing the
        uplink. For `femnist_mlp` — whose cost is pinned to the paper
        constants — this returns exactly `HardwareModel()`."""
        from repro_torch.core.workload import get_workload
        wl = get_workload(workload)
        kwargs = dict(epoch_mflops=float(wl.epoch_mflops),
                      model_bytes=int(wl.model_bytes),
                      bytes_per_param=int(wl.bytes_per_param))
        if gflops is None:
            gflops = wl.gflops
        if link_mbps is None:
            link_mbps = wl.link_mbps
        if gflops is not None:
            kwargs["gflops"] = gflops
        if link_mbps is not None:
            kwargs["link_mbps"] = link_mbps
        if max_local_epochs is not None:
            kwargs["max_local_epochs"] = max_local_epochs
        if codec is not None:
            kwargs["codec"] = get_codec(codec)
        return cls(**kwargs)


def lm_hardware_model(n_params: int, flops_per_step: float,
                      steps_per_epoch: int = 1,
                      gflops: float = 275e3,       # one v5e pod-slice client
                      link_mbps: float = 580.0,
                      bytes_per_param: int = C.BYTES_PER_PARAM
                      ) -> HardwareModel:
    """Price an assigned LM architecture as a constellation client (the
    reference's `lm_hardware_model`, with its default client's 275
    TFLOP/s). `bytes_per_param` defaults to the shared full-precision
    width (`constants.BYTES_PER_PARAM`, f32); `lm_workload` derives the
    actual width from the architecture's dtype (pass 2 for bf16)."""
    return HardwareModel(
        gflops=gflops,
        epoch_mflops=flops_per_step * steps_per_epoch / 1e6,
        link_mbps=link_mbps,
        model_bytes=n_params * bytes_per_param,
        bytes_per_param=bytes_per_param,
    )
