"""`flash_attention`'s share of its roofline in the profiled round (%): the least
time its launched shapes allow (`bench.counts.kernels`) over its
kernels' device time in the trace."""
from bench.counts import kernels


def read(obs: dict) -> float | None:
    return kernels.roofline_pct(obs, "flash_attention")
