"""rwkv6-1.6b's round MFU (%): the reading of `round_mfu.py`, its model
FLOPs counted by `bench.counts.model` from `kinds/rwkv.py` (a recomputed
layer's forward is not counted again)."""
from bench.metrics.round_mfu import read  # noqa: F401
