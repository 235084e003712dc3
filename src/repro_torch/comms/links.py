"""Link-rate models: constant telemetry vs geometry-dependent link budgets.

The seed priced every transfer at the constant `LINK_MBPS` (580 Mbps Planet
Dove telemetry). This module keeps that as `ConstantRate` — the back-compat
default whose transfer times are bitwise-identical to
`HardwareModel.tx_time_s` — and adds `LinkBudget`, a free-space-path-loss /
Shannon model where the achievable rate falls off with slant range, so
contact-plan windows can be priced by geometry instead of a constant.

All rate functions accept scalar or ndarray ranges and return bits/second.
Port of `repro.comms.links`: a verbatim numpy copy, so rates and transfer
times match the reference bitwise.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.orbits import constants as C

SPEED_OF_LIGHT = 299_792_458.0          # [m/s]
BOLTZMANN_DBW = -228.6                  # 10*log10(k_B), [dBW/K/Hz]

# Deep-fade floor: a link budget can quote a rate arbitrarily close to
# zero; every transfer-time division floors the rate here so a faded
# window yields a uselessly-long-but-finite transfer instead of
# inf/ZeroDivisionError. Shared by `LinkBudget.tx_time_s`, the
# contact-plan transfer math, and `HardwareModel.tx_time_for`.
MIN_RATE_BPS = 1.0


def slant_range_m(a_pos: np.ndarray, b_pos: np.ndarray) -> np.ndarray:
    """Euclidean range between two position sets (..., 3) [m]."""
    return np.linalg.norm(np.asarray(a_pos) - np.asarray(b_pos), axis=-1)


@dataclasses.dataclass(frozen=True)
class ConstantRate:
    """Geometry-independent rate — reproduces the seed's constant link.

    `tx_time_s(n_bytes)` uses the exact expression of
    `HardwareModel.tx_time_s` so default-model transfer times match the
    seed bit for bit.
    """

    rate_mbps: float = C.LINK_MBPS

    @property
    def geometry_free(self) -> bool:
        return True

    def rate_bps(self, range_m=0.0):
        return np.broadcast_to(self.rate_mbps * 1e6,
                               np.shape(range_m)).astype(float) \
            if np.ndim(range_m) else self.rate_mbps * 1e6

    def tx_time_s(self, n_bytes: float, range_m: float = 0.0) -> float:
        return (n_bytes * 8) / (self.rate_mbps * 1e6)


@dataclasses.dataclass(frozen=True)
class LinkBudget:
    """Free-space-path-loss link budget with a Shannon-capacity rate curve.

    rate(d) = min(max_rate, bandwidth * log2(1 + SNR(d))), with
    SNR from  EIRP + G/T - FSPL(d) - k_B - 10 log10(B).

    Defaults model an X-band LEO downlink calibrated so the rate at
    `ref_range_m` (1000 km slant range) is the paper's 580 Mbps
    telemetry figure — `ref_rate_bps` exposes the anchor, and
    `tests/test_torch_comms.py` holds it to the reference's.
    """

    frequency_hz: float = 8.2e9          # X-band
    bandwidth_hz: float = 375e6
    tx_power_dbw: float = 10.0           # 10 W
    tx_gain_dbi: float = 15.7            # sized so rate(ref_range_m) ~ 580 Mbps
    rx_gain_dbi: float = 35.0
    system_noise_k: float = 500.0
    losses_db: float = 3.0               # pointing + atmosphere + margin
    max_rate_bps: float = 1.2e9          # modem ceiling
    ref_range_m: float = 1_000e3         # calibration anchor (see ref_rate_bps)

    @property
    def geometry_free(self) -> bool:
        return False

    def fspl_db(self, range_m):
        d = np.maximum(np.asarray(range_m, dtype=float), 1.0)
        return 20.0 * np.log10(4.0 * np.pi * d * self.frequency_hz
                               / SPEED_OF_LIGHT)

    def snr_db(self, range_m):
        noise_db = (BOLTZMANN_DBW + 10.0 * np.log10(self.system_noise_k)
                    + 10.0 * np.log10(self.bandwidth_hz))
        rx_power_dbw = (self.tx_power_dbw + self.tx_gain_dbi
                        + self.rx_gain_dbi - self.losses_db
                        - self.fspl_db(range_m))
        return rx_power_dbw - noise_db

    def rate_bps(self, range_m):
        snr = 10.0 ** (self.snr_db(range_m) / 10.0)
        shannon = self.bandwidth_hz * np.log2(1.0 + snr)
        return np.minimum(shannon, self.max_rate_bps)

    @property
    def ref_rate_bps(self) -> float:
        """Achievable rate at the calibration anchor `ref_range_m` —
        ~`LINK_MBPS` for the default budget, so constant-rate and
        budget-priced plans agree at the reference geometry."""
        return float(self.rate_bps(self.ref_range_m))

    def tx_time_s(self, n_bytes: float, range_m: float) -> float:
        return float(n_bytes * 8
                     / max(float(self.rate_bps(range_m)), MIN_RATE_BPS))


LinkModel = ConstantRate | LinkBudget
