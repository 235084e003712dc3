"""Near-zero-overhead phase tracing and named counters.

The paper's headline claims (9x speedup via orbital scheduling, 768-config
sweep feasibility) are statements about *where time goes*; the sim stack
reports simulation-time metrics (`RoundRecord`) but historically had no
visibility into real wall-clock cost — plan builds, jit compiles, routing,
cache hits. This module is the registry those phases report into.

Design constraints, in order:

1. **Default-off, bitwise-safe.** The global tracer starts disabled; a
   disabled `span(...)` is one module-global load plus a shared no-op
   context manager (no allocation, no clock read), and a disabled
   `count(...)` is one load + one branch. Untraced runs execute the exact
   same numeric code — tracing never touches values, only observes walls.
2. **Thread-safe.** Spans nest per-thread (a `threading.local` stack);
   finished events and counters are appended/merged under one lock.
3. **Two clocks.** Every span records `time.perf_counter()` (monotonic,
   for durations — immune to NTP steps) *and* `time.time()` (wall, for
   correlating with external logs).
4. **The profiler's clock too.** While a `torch.profiler` is recording,
   an enabled span also opens a `record_function` range of its name, so
   the span appears in the profiler's trace (a `user_annotation` event)
   on the device trace's clock, with the kernels it launched under it.
   The span's own event is the same either way, and no span synchronises
   the device.

Usage::

    from repro_torch.obs import span, count, enable, metrics_summary

    enable()
    with span("sim.round", idx=3):
        with span("sim.select"):
            ...
        count("comms.routes")
    metrics_summary()  # {"counters": ..., "spans": ..., ...}

Exporters (Chrome/Perfetto trace.json, flat JSONL) live in
`repro_torch.obs.export`.
"""
from __future__ import annotations

import contextlib
import os
import sys
import threading
import time


class _NullSpan:
    """Shared no-op span: what `span()` returns while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args):  # attribute attach is a no-op when disabled
        pass


_NULL_SPAN = _NullSpan()


class _Span:
    """One live span. Created only while tracing is enabled."""

    __slots__ = ("_tracer", "name", "args", "_t0", "_wall0", "_depth",
                 "_range")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.args = args

    def set(self, **args) -> None:
        """Attach/override span attributes after entry."""
        self.args.update(args)

    def __enter__(self):
        stack = self._tracer._stack()
        self._depth = len(stack)
        stack.append(self)
        self._range = _profiler_range(self.name)
        self._wall0 = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        if exc_type is not None:
            self.args.setdefault("error", exc_type.__name__)
        self._tracer._record(self, t1)
        return False


def _profiler_range(name: str):
    """An entered `torch.profiler.record_function(name)` while a torch
    profiler is recording, else None. Read from `sys.modules`: where torch
    is not loaded no profiler can be recording, and the tracer loads
    nothing."""
    prof = sys.modules.get("torch.autograd.profiler")
    if prof is None or not prof._is_profiler_enabled:
        return None
    rng = prof.record_function(name)
    rng.__enter__()
    return rng


class Tracer:
    """Event + counter registry for one tracing session."""

    def __init__(self, max_events: int = 1_000_000):
        self._lock = threading.Lock()
        self._tls = threading.local()
        self.max_events = int(max_events)
        self.events: list[dict] = []   # finished spans, completion order
        self.counters: dict[str, float] = {}
        self.dropped_events = 0
        self.pid = os.getpid()
        # Session origin on both clocks: span timestamps are offsets from
        # t0_mono; t0_wall anchors them to the wall clock.
        self.t0_wall = time.time()
        self.t0_mono = time.perf_counter()

    # ----------------------------------------------------------- spans --
    def _stack(self) -> list:
        try:
            return self._tls.stack
        except AttributeError:
            self._tls.stack = []
            return self._tls.stack

    def span(self, name: str, **args) -> _Span:
        return _Span(self, name, args)

    def _record(self, sp: _Span, t1: float) -> None:
        ev = {
            "name": sp.name,
            "ts_us": (sp._t0 - self.t0_mono) * 1e6,
            "dur_us": (t1 - sp._t0) * 1e6,
            "t_wall": sp._wall0,
            "tid": threading.get_ident(),
            "depth": sp._depth,
            "args": sp.args,
        }
        with self._lock:
            if len(self.events) < self.max_events:
                self.events.append(ev)
            else:
                self.dropped_events += 1

    # -------------------------------------------------------- counters --
    def count(self, name: str, n: float = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    # --------------------------------------------------------- summary --
    def summary(self) -> dict:
        """Counters + per-phase wall-clock aggregates (+ hit rates derived
        from every `X.hit`/`X.miss` counter pair)."""
        with self._lock:
            events = list(self.events)
            counters = dict(self.counters)
            dropped = self.dropped_events
        spans: dict[str, dict] = {}
        for ev in events:
            s = spans.setdefault(ev["name"],
                                 {"count": 0, "total_s": 0.0, "max_s": 0.0})
            d = ev["dur_us"] / 1e6
            s["count"] += 1
            s["total_s"] += d
            s["max_s"] = max(s["max_s"], d)
        for s in spans.values():
            s["total_s"] = round(s["total_s"], 6)
            s["max_s"] = round(s["max_s"], 6)
        rates = {}
        for name in list(counters):
            if name.endswith(".hit"):
                stem = name[: -len(".hit")]
                total = counters[name] + counters.get(stem + ".miss", 0)
                if total:
                    rates[stem + ".hit_rate"] = round(counters[name] / total,
                                                      4)
        out = {
            "counters": counters,
            "rates": rates,
            "spans": spans,
            "wall_s": round(time.perf_counter() - self.t0_mono, 3),
        }
        if dropped:
            out["dropped_events"] = dropped
        return out


# ------------------------------------------------------ global registry --
# One module-global tracer; `None` means disabled. The hot-path helpers
# (`span`, `count`) read it exactly once so a disabled call costs one
# global load + one branch.
_tracer: Tracer | None = None


def enable(max_events: int = 1_000_000) -> Tracer:
    """Install (and return) a fresh global tracer."""
    global _tracer
    _tracer = Tracer(max_events=max_events)
    return _tracer


def disable() -> None:
    global _tracer
    _tracer = None


def enabled() -> bool:
    return _tracer is not None


def get_tracer() -> Tracer | None:
    return _tracer


def span(name: str, **args):
    """Context manager timing one phase (no-op while tracing is off)."""
    t = _tracer
    if t is None:
        return _NULL_SPAN
    return t.span(name, **args)


def count(name: str, n: float = 1) -> None:
    """Bump a named counter (no-op while tracing is off)."""
    t = _tracer
    if t is not None:
        t.count(name, n)


def metrics_summary() -> dict:
    """Summary of the global tracer ({} while tracing is off)."""
    t = _tracer
    return t.summary() if t is not None else {}


@contextlib.contextmanager
def tracing(max_events: int = 1_000_000):
    """Scoped tracing session (tests): enable, yield the tracer, restore
    whatever tracer — usually None — was installed before."""
    global _tracer
    prev = _tracer
    t = Tracer(max_events=max_events)
    _tracer = t
    try:
        yield t
    finally:
        _tracer = prev
