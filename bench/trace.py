"""Rounds under `torch.profiler`, reduced to what the per-layer readers
and the result's `breakdown` need.

Two rounds are profiled. The first traces the device alone, which costs
the host little, and gives the numbers:

  kernel_s     device seconds summed by kernel name
  busy_s       the union of the device's operation intervals (kernels,
               copies, sets)
  window_s     the host's wall over the round, from the batch's draw to
               the synchronise after the round
  device_ops   the 10 kernel names with the most device time

The second also records the host's operations, whose cost stretches the
device's gaps, and only names them: `idle_gaps` are its 10 longest
stretches with no device operation, each named by the benchmark's span
around it (`bench.batch` for the batch's draw, `bench.round` for the
program's call) and the innermost host operation running when it began.
Each Chrome trace is written to a temporary directory (under TMPDIR) and
read back.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def profile_round(call, make_batch, device, counts) -> dict:
    """`call(make_batch())` twice under the profiler, reduced; `counts()`
    read after the first gives its `launches`."""
    from torch.profiler import ProfilerActivity

    cuda = [ProfilerActivity.CUDA] if device.type == "cuda" else []
    out = _profiled(call, make_batch, device, cuda or [ProfilerActivity.CPU])
    out["launches"] = counts()
    named = _profiled(call, make_batch, device,
                      [ProfilerActivity.CPU] + cuda)
    out["idle_gaps"] = named["idle_gaps"]
    return out


def _profiled(call, make_batch, device, activities) -> dict:
    from torch.profiler import profile, record_function

    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        with record_function("bench.batch"):
            batch = make_batch()
        with record_function("bench.round"):
            call(batch)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "round.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return reduce_trace(events, wall)


def _union(intervals: list) -> list:
    merged: list = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce_trace(events: list, wall: float) -> dict:
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append(e)
        elif cat in ("cpu_op", "user_annotation"):
            host.append(e)
    kernel_s: dict = {}
    for e in dev:
        kernel_s[e["name"]] = kernel_s.get(e["name"], 0.0) + e["dur"] * 1e-6
    merged = _union([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    busy = sum(e - s for s, e in merged) * 1e-6
    gaps = [(merged[i + 1][0] - merged[i][1], merged[i][1])
            for i in range(len(merged) - 1)]
    gaps.sort(reverse=True)
    host.sort(key=lambda e: e["ts"])
    starts = [e["ts"] for e in host]

    def doing(t: float) -> str:
        """The outermost bench span and the innermost host op at t."""
        span, inner, depth = "host", None, -1.0
        for e in host[:bisect.bisect_right(starts, t)]:
            if e["ts"] + e["dur"] < t:
                continue
            if e["name"].startswith("bench."):
                span = e["name"]
            elif e["ts"] > depth:
                inner, depth = e["name"], e["ts"]
        return span if inner is None else f"{span}/{inner}"

    top = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:TOP]
    return {"kernel_s": kernel_s, "busy_s": busy, "window_s": wall,
            "device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[doing(at), length * 1e-6]
                          for length, at in gaps[:TOP]]}
