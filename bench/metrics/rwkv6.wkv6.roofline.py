"""`wkv6`'s share of its roofline in rwkv6-1.6b's profiled round (%): the
least time of one launch at the model's dense view (`bench.counts.kernels`,
24 a local step by `kinds/rwkv.py`, all of one shape) times the launches
that the program's counter saw, over its kernels' device time in the
trace. The launches are counted as made: where the program recomputes a
layer's forward for its backward, it launches `wkv6` again on the same
shape, and that launch's work is in the device time too."""
from bench.counts import kernels


def read(obs: dict) -> float | None:
    per_step = obs["launch_bounds"].get("wkv6")
    counted = obs["launches"].get("wkv6", 0)
    tr = obs.get("trace")
    if not per_step or len(set(per_step)) != 1 or not counted or not tr:
        return None
    device_s = sum(s for name, s in tr["kernel_s"].items()
                   if kernels.family(name) == "wkv6")
    if device_s <= 0 or counted < len(per_step) * obs["local_steps"]:
        return None
    return 100.0 * per_step[0] * counted / device_s
