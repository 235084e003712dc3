"""repro_torch.obs — phase tracing and counters (own copy of `repro.obs`).

  span(name, **args)    nestable timing context manager (no-op when off)
  count(name, n=1)      named counter (no-op when off)
  enable() / disable()  install / remove the global tracer (default: off)
  enabled()             is a tracer installed?
  tracing()             scoped enable (tests)
  metrics_summary()     counters + per-phase aggregates + hit rates
  chrome_trace()        the trace as a Chrome/Perfetto JSON object
  write_chrome_trace()  Perfetto/chrome://tracing-compatible trace.json
  write_jsonl()         flat one-object-per-line event log
  log_record()          structured launcher progress (REPRO_LOG=1 toggle)
"""
from repro_torch.obs.export import chrome_trace, write_chrome_trace, \
    write_jsonl
from repro_torch.obs.logging import log_enabled, log_record, set_logging
from repro_torch.obs.trace import (
    Tracer,
    count,
    disable,
    enable,
    enabled,
    get_tracer,
    metrics_summary,
    span,
    tracing,
)

__all__ = ["Tracer", "chrome_trace", "count", "disable", "enable",
           "enabled", "get_tracer", "log_enabled", "log_record",
           "metrics_summary", "set_logging", "span", "tracing",
           "write_chrome_trace", "write_jsonl"]
