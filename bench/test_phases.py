"""`bench.phases`: a profile's device time and idle attributed to the
program's spans, on a hand-built Chrome trace and on the tiny cell."""
from __future__ import annotations

import pytest
import torch

from bench import phases
from bench.conftest import cell_names

MAIN, OTHER = {"pid": 1, "tid": 10}, {"pid": 1, "tid": 11}


def _x(cat, name, ts, dur, where=MAIN, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            **where, "args": args}


def _span(name, ts, end, where=MAIN):
    return _x("user_annotation", name, ts, end - ts, where)


def _op(cat, ts, end, corr, name="k"):
    return _x(cat, name, ts, end - ts, {"pid": 0, "tid": 7},
              correlation=corr)


# One round on the main thread (ts in microseconds): a forward and a
# backward step, an update and an aggregation. Device operations: one
# launched through the runtime API (forward), one through the driver API
# (backward), one launched from a second thread while the main thread
# waits in backward, a copy in update, one with no launching call, and
# one in aggregate; the idle stretch from 720 to 850 spans the round's
# own time and aggregate.
TRACE = [
    _span("bench.round", 0, 1000),
    _span("fl_round.round", 10, 990),
    _span("fl_round.forward", 100, 300),
    _span("fl_round.backward", 300, 600),
    _span("fl_round.update", 600, 700),
    _span("fl_round.aggregate", 800, 900),
    _span("gloo:all_reduce", 810, 890, OTHER),           # not the main thread
    _x("cuda_runtime", "cudaLaunchKernel", 150, 5, correlation=1),
    _x("cuda_driver", "cuLaunchKernelEx", 320, 5, correlation=2),
    _x("cuda_runtime", "cudaLaunchKernel", 450, 4, OTHER, correlation=3),
    _x("cuda_runtime", "cudaMemcpyAsync", 610, 5, correlation=4),
    _x("cuda_runtime", "cudaLaunchKernel", 850, 2, correlation=5),
    _op("kernel", 160, 260, 1),
    _op("kernel", 330, 430, 2, "nvjet_tst"),
    _op("kernel", 450, 560, 3),
    _op("gpu_memcpy", 620, 680, 4, "Memcpy HtoD"),
    _op("kernel", 700, 720, 99),                          # no launch
    _op("kernel", 850, 880, 5),
    _op("gpu_user_annotation", 150, 900, None, "fl_round.round"),
    {"ph": "s", "cat": "ac2g", "name": "flow", "ts": 150, "id": 1},
]

# Expected (microseconds): device time and idle of each span.
DEVICE = {"fl_round.forward": 100, "fl_round.backward": 210,
          "fl_round.update": 60, "fl_round.aggregate": 30,
          "unattributed": 20}
IDLE = {"bench.round": 10 + 10, "fl_round.round": 90 + 80 + 90,
        "fl_round.forward": 60 + 40, "fl_round.backward": 30 + 20 + 40,
        "fl_round.update": 20 + 20, "fl_round.aggregate": 50 + 20}


def test_device_time_and_idle_land_where_the_rules_say():
    red = phases.reduce_phases(TRACE)
    ph = red["phases"]
    for name, us in DEVICE.items():
        assert ph[name]["device_s"] == pytest.approx(us * 1e-6)
    for name, us in IDLE.items():
        assert ph[name]["idle_s"] == pytest.approx(us * 1e-6)
    assert "gloo:all_reduce" not in ph
    assert ph["fl_round.backward"]["count"] == 1
    assert ph["fl_round.backward"]["host_s"] == pytest.approx(300e-6)
    assert red["device_s"] == pytest.approx(420e-6)
    assert red["busy_s"] == pytest.approx(420e-6)
    assert red["window_s"] == pytest.approx(1000e-6)
    assert red["idle_s"] == pytest.approx(580e-6)
    assert red["clock_lead_s"] == pytest.approx(-120e-6)
    assert sum(p["device_s"] for p in ph.values()) == \
        pytest.approx(red["device_s"])
    assert sum(p["idle_s"] for p in ph.values()) == \
        pytest.approx(red["idle_s"])
    kernels = {n: (s, w) for n, s, w in red["kernels"]}
    assert kernels["k"][0] == pytest.approx(260e-6)
    assert kernels["k"][1] == pytest.approx({
        "fl_round.forward": 100e-6, "fl_round.backward": 110e-6,
        "unattributed": 20e-6, "fl_round.aggregate": 30e-6})
    assert kernels["nvjet_tst"][1] == \
        pytest.approx({"fl_round.backward": 100e-6})


def test_layer_split_and_its_checks():
    red = phases.reduce_phases(TRACE)
    split = phases.layer_split(red)
    assert split == pytest.approx({
        "round_driver.device_ms": 0.090, "round_driver.idle_ms": 0.370,
        "model_step.device_ms": 0.310, "model_step.idle_ms": 0.190})
    got = phases.checks(red, host_window_s=1000e-6)
    assert got["under_fl_round_share"] == pytest.approx(400 / 420)
    assert got["split_over_device_s"] == pytest.approx(400 / 420)
    assert got["idle_split_s"] == pytest.approx([560e-6, 20e-6])
    assert got["idle_split_over_host_idle"] == pytest.approx(1.0)


@pytest.mark.parametrize("reduced", [
    None, {},
    {"phases": {"fl_round.round": {"count": 1}}, "device_s": 0.0},
    {"phases": {}, "device_s": 1.0}])
def test_a_split_with_nothing_to_read_returns_nothing(reduced):
    assert phases.layer_split(reduced) is None


def test_the_tiny_cell_names_its_spans_and_splits_nothing_on_the_cpu(tiny):
    cell = tiny(cell_names()[0], "float32")
    steps = cell.traffic["local_steps"]
    outs = list(phases.measure(cell, 2 ** 40 + 29, torch.device("cpu"),
                               rounds=1, cost_seconds=0.0, cost_runs=1))
    first, cost = outs
    ph = first["phases"]
    assert ph["fl_round.round"]["count"] == 1
    assert ph["bench.round"]["count"] == 1
    for name in ("fl_round.forward", "fl_round.backward",
                 "fl_round.update"):
        assert ph[name]["count"] == steps
    assert first["device_s"] == 0 and first["split"] is None
    assert len(cost["tracing_cost"]["off"]) == 1
    assert all(r > 0 for r in cost["tracing_cost"]["on"])
