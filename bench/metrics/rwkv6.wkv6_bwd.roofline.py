"""`wkv6_bwd`'s share of its roofline in rwkv6-1.6b's profiled round (%):
the least time its launched shapes allow (`bench.counts.kernels`, 24 a
local step by `kinds/rwkv.py`) over its kernels' device time in the
trace."""
from bench.counts import kernels


def read(obs: dict) -> float | None:
    return kernels.roofline_pct(obs, "wkv6_bwd")
