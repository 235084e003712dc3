"""Structured one-line-JSON progress records for the launchers.

The port's own copy of `repro.obs.logging`: every record is a flat JSON
object on stderr (machine-parseable, never interleaved with a
benchmark's output on stdout), and emission is **quiet by default** —
set ``REPRO_LOG=1`` (or call `set_logging(True)`) to see them.

`log_record` always *returns* the record dict, so callers can aggregate
(e.g. serve.py's tokens/s + p99 summary) whether or not anything was
printed.
"""
from __future__ import annotations

import json
import os
import sys
import time

# Tri-state programmatic override: None defers to the REPRO_LOG env var.
_override: bool | None = None


def set_logging(enabled: bool | None) -> None:
    """Force logging on/off; None restores the REPRO_LOG env toggle."""
    global _override
    _override = enabled


def log_enabled() -> bool:
    if _override is not None:
        return _override
    return os.environ.get("REPRO_LOG", "0").lower() not in ("", "0", "false")


def log_record(event: str, _stream=None, **fields) -> dict:
    """Build (and, when enabled, emit) one structured progress record."""
    rec = {"event": event, "t_wall": round(time.time(), 6), **fields}
    if log_enabled():
        stream = _stream if _stream is not None else sys.stderr
        stream.write(json.dumps(rec, default=str) + "\n")
        stream.flush()
    return rec
