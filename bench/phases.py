"""The profiled round's device time and idle, attributed to the program's
spans.

While a `torch.profiler` records and `repro_torch.obs` tracing is on,
each of the program's spans is also a `record_function` range, so the
profiler's Chrome trace holds it as a `user_annotation` event on the
device trace's clock. `reduce_phases` attributes that trace to the
spans:

  device seconds  each device operation (kernel, copy, set) goes to the
                  innermost span of the main thread (the one holding
                  `bench.round`) whose interval holds its launching call,
                  found by `correlation` among the CUDA runtime and driver
                  API events of any thread (cuBLASLt launches through the
                  driver API; backward launches from autograd's device
                  thread while the main thread waits in its span); an
                  operation with no launching call is `unattributed`, one
                  launched in no span `outside`
  idle seconds    each stretch of the window with no device operation,
                  split among the innermost spans the main thread was in
                  over it (`outside` where it was in none); the window
                  runs from the main thread's first span to the last
                  host or device event
  host seconds    each span's summed host wall, with its count

`layer_split` reads the round driver's and the model step's share from
that: the driver's spans are `fl_round.round` (its own time) and its
`shard`, `copy`, `update`, `delta`, `aggregate` and `apply`; the model's
are `fl_round.forward` and `fl_round.backward`. Idle comes from a profile
that records host operations, whose cost stretches the device's gaps:
compare it between commits, not with `device_idle_share`.

    python3 -m bench.phases --workload <cell> --seed <n> [--out <file>]

runs the cell's set-up as its driver does, profiles two rounds (each
first with the device alone, then named with tracing on, as the
benchmark's traced run profiles its round) and prints each one's
phases, split and checks (the share of device time under the round's
spans, the split against the summed device time, the idle split against
the host window's), then measures what tracing costs when on and no
profiler records: the window's rate with it off and on, three windows
of 20 s each, in turns (off, on, on, off, off, on). One JSON object a
line on standard output, and all of them in `--out`. It needs a CUDA
device (else it exits 2).
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import os
import sys
import tempfile
import time

import torch

from bench import harness, traffic, weights
from bench import trace as bench_trace

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
DRIVER_SPANS = ("fl_round.round", "fl_round.shard", "fl_round.copy",
                "fl_round.update", "fl_round.delta", "fl_round.aggregate",
                "fl_round.apply")
MODEL_SPANS = ("fl_round.forward", "fl_round.backward")
OUTSIDE, UNATTRIBUTED = "outside", "unattributed"
TOP = 10


def _main_thread(events: list) -> tuple | None:
    """(pid, tid) of the thread holding `bench.round`."""
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"] == "bench.round":
            return e.get("pid"), e.get("tid")
    return None


def reduce_phases(events: list) -> dict:
    """{"phases": {span name: {"count", "host_s", "device_s", "idle_s"}},
    "kernels", "device_s", "busy_s", "idle_s", "window_s", "clock_lead_s"}
    of one profile's Chrome trace events (see the module's docstring),
    where "kernels" lists the 10 operation names with the most device time
    as [name, seconds, {span name: seconds}], and "clock_lead_s" is the
    last device operation's end less the end of the main thread's last
    event (the synchronise after the round): above zero the device's
    timestamps ran ahead of the host's, and idle is split against host
    spans that many seconds off by the end. Seconds throughout."""
    events = [e for e in events if e.get("ph") == "X" and "dur" in e]
    main = _main_thread(events)
    spans = sorted((e for e in events if e.get("cat") == "user_annotation"
                    and (e.get("pid"), e.get("tid")) == main),
                   key=lambda e: (e["ts"], -e["dur"]))
    starts = [e["ts"] for e in spans]

    def innermost(t: float) -> str:
        """The span that started last of those holding t."""
        for e in reversed(spans[:bisect.bisect_right(starts, t)]):
            if e["ts"] + e["dur"] >= t:
                return e["name"]
        return OUTSIDE

    phases: dict = {}

    def phase(name: str) -> dict:
        return phases.setdefault(name, {"count": 0, "host_s": 0.0,
                                        "device_s": 0.0, "idle_s": 0.0})

    for e in spans:
        p = phase(e["name"])
        p["count"] += 1
        p["host_s"] += e["dur"] * 1e-6
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in LAUNCH_CATS
                 and "correlation" in e.get("args", {})}
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    by_kernel: dict = {}
    for e in dev:
        at = launch_ts.get(e.get("args", {}).get("correlation"))
        name = UNATTRIBUTED if at is None else innermost(at)
        phase(name)["device_s"] += e["dur"] * 1e-6
        where = by_kernel.setdefault(e["name"], {})
        where[name] = where.get(name, 0.0) + e["dur"] * 1e-6

    merged: list = []
    for s, t in sorted((e["ts"], e["ts"] + e["dur"]) for e in dev):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    host_end = [e["ts"] + e["dur"] for e in events
                if (e.get("pid"), e.get("tid")) == main]
    if not spans:
        t0 = t1 = 0.0
    else:
        t0 = spans[0]["ts"]
        t1 = max(host_end + [m[1] for m in merged])
    idle, cursor = [], t0
    for s, t in merged + [[t1, t1]]:
        if s > cursor:
            idle.append((cursor, min(s, t1)))
        cursor = max(cursor, t)
    edges = sorted({x for e in spans for x in (e["ts"], e["ts"] + e["dur"])})
    for s, t in idle:
        cuts = [s] + edges[bisect.bisect_right(edges, s):
                           bisect.bisect_left(edges, t)] + [t]
        for a, b in zip(cuts, cuts[1:]):
            phase(innermost((a + b) / 2))["idle_s"] += (b - a) * 1e-6
    busy = sum(min(t, t1) - max(s, t0) for s, t in merged
               if t > t0 and s < t1)
    top = sorted(by_kernel.items(), key=lambda kv: -sum(kv[1].values()))
    return {"phases": phases,
            "kernels": [[n, sum(w.values()), w] for n, w in top[:TOP]],
            "device_s": sum(e["dur"] for e in dev) * 1e-6,
            "busy_s": busy * 1e-6,
            "idle_s": sum(t - s for s, t in idle) * 1e-6,
            "window_s": (t1 - t0) * 1e-6,
            "clock_lead_s": (merged[-1][1] - max(host_end)) * 1e-6
            if merged and host_end else None}


def layer_split(reduced: dict | None) -> dict | None:
    """The round driver's and the model step's device time and idle (ms):
    the driver's a round, the model's a local step (over the count of
    `fl_round.forward` spans). None without a profiled round or without
    device operations (a run on the CPU)."""
    if not reduced or reduced["device_s"] <= 0:
        return None
    ph = reduced["phases"]
    rounds = ph.get("fl_round.round", {}).get("count", 0)
    steps = ph.get("fl_round.forward", {}).get("count", 0)
    if not rounds or not steps:
        return None

    def total(names, key):
        return sum(ph[n][key] for n in names if n in ph)

    return {"round_driver.device_ms":
            1e3 * total(DRIVER_SPANS, "device_s") / rounds,
            "round_driver.idle_ms": 1e3 * total(DRIVER_SPANS, "idle_s")
            / rounds,
            "model_step.device_ms": 1e3 * total(MODEL_SPANS, "device_s")
            / steps,
            "model_step.idle_ms": 1e3 * total(MODEL_SPANS, "idle_s") / steps}


def checks(reduced: dict, host_window_s: float) -> dict:
    """The reduction held to itself and to the host's window: the share
    of device time under `fl_round.*` spans, the split's device time (a
    round's driver plus local steps times a step's model) over the summed
    device time, and the split's idle (driver, model and the rest) over
    the host window's idle (window less the busy union)."""
    ph = reduced["phases"]
    rounds = ph["fl_round.round"]["count"]
    steps = ph["fl_round.forward"]["count"]
    split = layer_split(reduced)
    under = sum(p["device_s"] for n, p in ph.items()
                if n.startswith("fl_round."))
    split_device = 1e-3 * (rounds * split["round_driver.device_ms"]
                           + steps * split["model_step.device_ms"])
    split_idle = 1e-3 * (rounds * split["round_driver.idle_ms"]
                         + steps * split["model_step.idle_ms"])
    rest_idle = sum(p["idle_s"] for n, p in ph.items()
                    if n not in DRIVER_SPANS + MODEL_SPANS)
    return {"under_fl_round_share": under / reduced["device_s"],
            "split_over_device_s": split_device / reduced["device_s"],
            "idle_split_s": [split_idle, rest_idle],
            "idle_split_over_host_idle": (split_idle + rest_idle)
            / (host_window_s - reduced["busy_s"])}


def profile_traced(call, make_batch, device) -> tuple[list, float]:
    """`call(make_batch())` under the profiler (host operations and the
    device) with the program's tracing on, as the benchmark's named
    profile runs it: (the Chrome trace's events, the host's wall from the
    batch's draw to the synchronise after the round)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch import obs

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with obs.tracing(), profile(activities=acts) as prof:
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
            return json.load(f)["traceEvents"], wall


def _window(rnd, params, feed, device, seconds: float, mix: dict):
    """Rounds back to back for `seconds`, each ending in a synchronise, as
    the driver's window runs them: (the params after, samples a second)."""
    done, t0 = 0, time.perf_counter()
    while True:
        params = rnd(params, feed.next())
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        done += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window = time.perf_counter() - t0
    rnd.take_losses()
    return params, done * mix["local_steps"] * mix["rows"] * mix["seq"] \
        / window


def measure(cell: harness.Cell, seed: int, device, rounds: int = 2,
            cost_seconds: float = 20.0, cost_runs: int = 3):
    """The cell's set-up, then `rounds` profiled rounds and `cost_runs`
    windows each with tracing off and on (off, on, on, off, ...); yields
    one dict a profiled round and one for the windows. Each profiled
    round is profiled twice, as the benchmark's traced run does: the
    device alone (its busy and window give "device_only"), then the named
    profile with tracing on. Every batch is drawn ahead, as the driver
    draws the window's."""
    harness.program_path()
    from repro_torch import obs

    mix = cell.traffic
    if device.type == "cuda":
        from repro_torch.kernels import build
        build.library()
    from repro_torch.sharding.compat import default_group
    default_group(device)
    rnd = cell.driver.Round(cell)
    params = weights.make(rnd.layout, cell.config["init"], seed, device,
                          getattr(torch, cell.config["param_dtype"]))
    feed = traffic.TokenFeed(mix, rnd.cfg.vocab_size, seed, device)
    feed.fill(mix["check_rounds"])
    for _ in range(mix["check_rounds"]):
        t0 = time.perf_counter()
        params = rnd(params, feed.next())
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        pace = time.perf_counter() - t0
    rnd.take_losses()
    feed.fill(2 * rounds + cost_runs * 2 * (int(1.5 * cost_seconds / pace)
                                            + 4))

    def call(tokens):
        return rnd(params, tokens)

    acts = torch.profiler.ProfilerActivity
    for i in range(rounds):
        alone = bench_trace._profiled(
            call, feed.next, device,
            [acts.CUDA if device.type == "cuda" else acts.CPU])
        events, wall = profile_traced(call, feed.next, device)
        rnd.take_losses()
        reduced = reduce_phases(events)
        out = {"round": i, "host_window_s": wall,
               "device_only": {k: alone[k] for k in ("busy_s", "window_s")},
               **reduced, "split": layer_split(reduced)}
        if out["split"]:
            out["checks"] = checks(reduced, wall)
        yield out
    rates: dict = {"off": [], "on": []}
    for i in range(cost_runs):
        for side in ("off", "on") if i % 2 == 0 else ("on", "off"):
            with obs.tracing() if side == "on" else contextlib.nullcontext():
                params, rate = _window(rnd, params, feed, device,
                                       cost_seconds, mix)
            rates[side].append(rate)
    yield {"tracing_cost": rates, "cost_seconds": cost_seconds}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print(f"{cell.name} needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    lines = [{"workload": cell.name, "seed": args.seed,
              "device": torch.cuda.get_device_name(device)}]
    print(json.dumps(lines[0]), flush=True)
    for out in measure(cell, args.seed, device):
        lines.append(out)
        print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(x) + "\n" for x in lines)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
