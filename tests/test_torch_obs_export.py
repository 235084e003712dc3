"""The port's trace exporters vs the reference's (`repro.obs.export`).

One fixed sequence of nested spans (with arguments, one set after entry)
and counters goes into a reference `Tracer` and a port `Tracer`; the
Chrome/Perfetto trace and the JSONL log of each, written to and read back
from files, agree field for field once the clock readings (timestamps,
durations, walls) and the process and thread ids are masked.
"""
from __future__ import annotations

import json

import pytest

from repro.obs import export as jexport
from repro.obs.trace import Tracer as JaxTracer
from repro_torch import obs
from repro_torch.obs import export
from repro_torch.obs.trace import Tracer

CLOCKS = {"ts", "dur", "t_wall", "ts_s", "dur_s", "tid", "pid",
          "t0_wall_unix"}


def _drive(tracer) -> None:
    with tracer.span("launch.serve_batch", batch=4):
        with tracer.span("launch.prefill", batch=4, prompt_len=224):
            tracer.count("launch.prefill_tokens", 896)
        with tracer.span("launch.decode", batch=4) as sp:
            sp.set(max_new=32)
            for _ in range(3):
                with tracer.span("launch.decode_step"):
                    tracer.count("launch.decode_tokens", 4)
    tracer.count("launch.requests_served", 4)


def _masked(obj):
    """obj with every clock reading and id replaced by its type name; the
    span summary's timing aggregates likewise."""
    if isinstance(obj, dict):
        return {k: type(v).__name__ if k in CLOCKS
                or (k.endswith("_s") and isinstance(v, float))
                else _masked(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_masked(v) for v in obj]
    return obj


@pytest.fixture
def tracers():
    ref, port = JaxTracer(), Tracer()
    _drive(ref)
    _drive(port)
    return ref, port


def test_chrome_trace_matches_reference(tracers, tmp_path):
    ref, port = tracers
    want = json.loads(open(jexport.write_chrome_trace(
        str(tmp_path / "ref.json"), ref)).read())
    got = json.loads(open(export.write_chrome_trace(
        str(tmp_path / "port.json"), port)).read())
    assert _masked(got) == _masked(want)
    again = json.loads(json.dumps(export.chrome_trace(port)))
    assert got["traceEvents"] == again["traceEvents"]
    names = [ev["name"] for ev in got["traceEvents"]]
    assert names.count("launch.decode_step") == 3
    assert [ev["ph"] for ev in got["traceEvents"]].count("C") == 3


def test_jsonl_matches_reference(tracers, tmp_path):
    ref, port = tracers
    read = lambda p: [json.loads(line) for line in open(p)]
    want = read(jexport.write_jsonl(str(tmp_path / "ref.jsonl"), ref))
    got = read(export.write_jsonl(str(tmp_path / "port.jsonl"), port))
    assert _masked(got) == _masked(want)
    assert [r["type"] for r in got] == ["span"] * 6 + ["counter"] * 3
    assert got[-2] == dict(got[-2], name="launch.prefill_tokens", value=896)


def test_exporters_need_a_tracer():
    obs.disable()
    with pytest.raises(RuntimeError, match="tracing is not enabled"):
        export.chrome_trace()
    with obs.tracing():
        with obs.span("x"):
            pass
        assert [ev["name"] for ev in obs.chrome_trace()["traceEvents"]] \
            == ["process_name", "x"]
