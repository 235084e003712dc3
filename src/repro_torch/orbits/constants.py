"""Physical constants (SI units unless noted)."""

# Earth gravitational parameter [m^3 / s^2]
MU_EARTH = 3.986004418e14
# Mean Earth radius [m]
R_EARTH = 6.371e6
# Earth rotation rate [rad/s] (sidereal)
OMEGA_EARTH = 7.2921150e-5

# Paper defaults (Table 2): circular polar Walker-Star at 500 km.
DEFAULT_ALTITUDE_KM = 500.0
DEFAULT_INCLINATION_DEG = 90.0
DEFAULT_ELEVATION_MASK_DEG = 10.0

# Simulation horizon: the paper runs April 14 - July 13 2024 = 90 days.
DEFAULT_HORIZON_S = 90 * 86400.0
# Access-window sampling resolution [s]. Contact windows are 5-15 min so 30 s
# resolution resolves them with <4% duration error.
DEFAULT_DT_S = 30.0

# Hardware model from paper section 5.
MODEL_PARAMS = 47_000
MODEL_BYTES = 186_000           # 186 KB over telemetry
EPOCH_MFLOPS = 98.0             # per local epoch
CLIENT_GFLOPS = 40.0            # SpaceCloud iX5-106
LINK_MBPS = 580.0               # Planet Dove telemetry
# Full-precision wire width [bytes/parameter] — THE default everywhere a
# transfer is priced per parameter (f32; the paper's 186 KB / 47k params
# ~ 4 B/param). `Workload.bytes_per_param` derives a workload's actual
# width from its dtype (LM configs may ship f16/bf16 = 2), and
# `Workload.model_bytes_override` wins over both; `repro.comms.codec`
# prices compressed uplinks as ratios against this width.
BYTES_PER_PARAM = 4
