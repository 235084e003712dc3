"""rwkv6-1.6b's share of the profiled round's host wall in which no
operation ran on the device (%): the reading of `device_idle_share.py`."""
from bench.metrics.device_idle_share import read  # noqa: F401
