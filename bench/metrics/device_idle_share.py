"""The share of the profiled round's host wall in which no operation ran
on the device (%): 1 - (union of kernel, copy and set intervals) / wall."""


def read(obs: dict) -> float | None:
    tr = obs.get("trace")
    if not tr or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
