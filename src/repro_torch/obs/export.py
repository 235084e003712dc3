"""Trace exporters: Chrome/Perfetto `trace.json` and flat JSONL.

Port of `repro.obs.export` onto the port's own `Tracer`
(`repro_torch.obs.trace`): the same events, fields and rounding. Both
exporters serialize a `Tracer`'s finished spans + counters; neither
touches the tracer's live state (snapshot under its lock via
`Tracer.summary` / list copies), so exporting mid-run is safe.

Chrome trace event format (the subset Perfetto's JSON importer accepts):
one complete event (``"ph": "X"``, microsecond ``ts``/``dur``) per span,
``"M"`` metadata naming the process, and one ``"C"`` counter event per
named counter (final value, stamped at export time). Open the file at
https://ui.perfetto.dev or chrome://tracing.
"""
from __future__ import annotations

import json
import time

from repro_torch.obs.trace import Tracer, get_tracer


def _require_tracer(tracer: Tracer | None) -> Tracer:
    t = tracer if tracer is not None else get_tracer()
    if t is None:
        raise RuntimeError("tracing is not enabled: call "
                           "repro_torch.obs.enable() (or pass a Tracer) "
                           "before exporting")
    return t


def chrome_trace(tracer: Tracer | None = None) -> dict:
    """The trace as a Chrome/Perfetto-compatible JSON object."""
    t = _require_tracer(tracer)
    with t._lock:
        events = [dict(ev) for ev in t.events]
        counters = dict(t.counters)
    out = [{"name": "process_name", "ph": "M", "pid": t.pid, "tid": 0,
            "args": {"name": "repro"}}]
    last_ts = 0.0
    for ev in events:
        out.append({
            "name": ev["name"], "ph": "X", "pid": t.pid, "tid": ev["tid"],
            "ts": round(ev["ts_us"], 3), "dur": round(ev["dur_us"], 3),
            "args": {**ev["args"], "depth": ev["depth"],
                     "t_wall": round(ev["t_wall"], 6)},
        })
        last_ts = max(last_ts, ev["ts_us"] + ev["dur_us"])
    for name, value in sorted(counters.items()):
        out.append({"name": name, "ph": "C", "pid": t.pid, "tid": 0,
                    "ts": round(last_ts, 3), "args": {name: value}})
    return {
        "traceEvents": out,
        "displayTimeUnit": "ms",
        "metadata": {
            "t0_wall_unix": round(t.t0_wall, 6),
            "summary": t.summary(),
        },
    }


def write_chrome_trace(path: str, tracer: Tracer | None = None) -> str:
    with open(path, "w") as f:
        json.dump(chrome_trace(tracer), f, indent=1)
    return path


def write_jsonl(path: str, tracer: Tracer | None = None) -> str:
    """Flat event log: one JSON object per line — every finished span
    (monotonic offsets + wall timestamps) then every counter's final
    value. Grep-able where the Chrome trace is click-able."""
    t = _require_tracer(tracer)
    with t._lock:
        events = [dict(ev) for ev in t.events]
        counters = dict(t.counters)
    with open(path, "w") as f:
        for ev in events:
            f.write(json.dumps({
                "type": "span", "name": ev["name"],
                "t_wall": round(ev["t_wall"], 6),
                "ts_s": round(ev["ts_us"] / 1e6, 6),
                "dur_s": round(ev["dur_us"] / 1e6, 6),
                "tid": ev["tid"], "depth": ev["depth"],
                "args": ev["args"],
            }) + "\n")
        wall = time.time()
        for name, value in sorted(counters.items()):
            f.write(json.dumps({"type": "counter", "name": name,
                                "value": value,
                                "t_wall": round(wall, 6)}) + "\n")
    return path
