"""The federated round's spans (`make_fl_round_step`) and the tracer's
`record_function` ranges.

With `repro_torch.obs` tracing on, the round records one `fl_round.round`
span and, inside it, `shard`, `copy`, a `forward`, `backward` and
`update` a local step, `delta`, `aggregate` and `apply`; under a
`torch.profiler` each is also a `user_annotation` range of the profile.
Tracing changes no value: the round's output is bitwise the same with it
on or off, with or without a profiler. With tracing off a span is the
shared no-op object and the profile holds none of the round's ranges.
"""
from __future__ import annotations

import json
import os
import tempfile

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.launch.fl_round import make_fl_round_step
from repro_torch.models.lm.params import tree_leaves
from repro_torch.models.lm.transformer import init_params
from repro_torch.obs import trace

LOCAL_STEPS = 2
STEP_SPANS = ("fl_round.forward", "fl_round.backward", "fl_round.update")


@pytest.fixture(scope="module")
def tiny_round():
    """The tiny hymba copy's params and batch, and a FedProx round step
    of two local steps."""
    torch.set_num_threads(1)
    cfg = get_config("hymba-1.5b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 32),
                           generator=torch.Generator().manual_seed(1))
    step = make_fl_round_step(cfg, lr=1e-2, local_steps=LOCAL_STEPS,
                              prox_mu=0.1)
    return step, params, {"tokens": tokens}


def _profiled(fn) -> tuple[object, list]:
    """fn() under a CPU profiler: its result and the Chrome trace's
    `user_annotation` events of the calling thread."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("cat") == "user_annotation"]
    main = {e["tid"] for e in spans if e["name"] == "fl_round.round"}
    return out, [e for e in spans if e["tid"] in main or not main]


def test_a_span_with_tracing_off_is_the_shared_no_op():
    assert not obs.enabled()
    assert obs.span("fl_round.round", round=0) is trace._NULL_SPAN
    with profile(activities=[ProfilerActivity.CPU]):
        assert obs.span("fl_round.round", round=0) is trace._NULL_SPAN


def test_round_is_bitwise_equal_with_tracing_on_and_off(tiny_round):
    step, params, batch = tiny_round
    off = step(params, batch, [64.0])
    with obs.tracing() as tr:
        on = step(params, batch, [64.0])
    assert tr.events
    with obs.tracing():
        profiled, _ = _profiled(lambda: step(params, batch, [64.0]))
    for a, b, c in zip(*map(tree_leaves, (off, on, profiled))):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_round_spans_are_profiler_annotations_nested_as_designed(
        tiny_round):
    step, params, batch = tiny_round
    with obs.tracing() as tr:
        _, spans = _profiled(lambda: step(params, batch, [64.0]))
    spans = sorted((e for e in spans if e["name"].startswith("fl_round.")),
                   key=lambda e: (e["ts"], -e["dur"]))
    names = [e["name"] for e in spans]
    assert names == (["fl_round.round", "fl_round.shard", "fl_round.copy"]
                     + list(STEP_SPANS) * LOCAL_STEPS
                     + ["fl_round.delta", "fl_round.aggregate",
                        "fl_round.apply"])
    outer = spans[0]
    for e in spans[1:]:
        assert outer["ts"] <= e["ts"]
        assert e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]
    for a, b in zip(spans[1:], spans[2:]):       # siblings, in turn
        assert a["ts"] + a["dur"] <= b["ts"]
    # The tracer's own events: one round id on every span, each local
    # step's index on its three spans.
    events = {(ev["name"], ev["args"].get("step")): ev["args"]
              for ev in tr.events}
    assert len(events) == len(tr.events) == len(spans)
    assert {a["round"] for a in events.values()} == \
        {events[("fl_round.round", None)]["round"]}
    assert events[("fl_round.round", None)]["steps"] == LOCAL_STEPS
    assert events[("fl_round.round", None)]["rank"] == 0
    for name in STEP_SPANS:
        assert {s for n, s in events if n == name} == set(range(LOCAL_STEPS))


def test_no_round_annotation_with_tracing_off(tiny_round):
    step, params, batch = tiny_round
    _, spans = _profiled(lambda: step(params, batch, [64.0]))
    assert not [e for e in spans if e["name"].startswith("fl_round.")]


def test_a_span_event_is_the_same_under_a_profiler():
    def one_span():
        with obs.span("fl_round.round", round=3) as sp:
            sp.set(rank=0)

    with obs.tracing() as tr:
        one_span()
        _, spans = _profiled(one_span)
    plain, profiled = tr.events
    assert plain.keys() == profiled.keys()
    for key in ("name", "depth", "args"):
        assert plain[key] == profiled[key]
    assert [e["name"] for e in spans] == ["fl_round.round"]
