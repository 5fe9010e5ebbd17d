"""Structured tracer: span/event records on one process-local timeline
(a copy of ``pydcop_tpu/telemetry/tracer.py``).

Records are buffered in memory (bounded by ``max_records``) and written
at :meth:`Tracer.close` as either JSONL (one record per line) or Chrome
``trace_event`` JSON (chrome://tracing, https://ui.perfetto.dev), in the
JAX package's record schema, so its trace reader
(``telemetry/summary.py``) reads the port's files:

- ``{"kind": "meta", "version": 1, "unix_t0": ..., "pid": ...}`` —
  first line; ``t`` fields below are seconds since ``unix_t0`` on the
  monotonic clock.
- ``{"kind": "span", "name", "cat", "t", "dur", "tid", "args"}`` — a
  timed phase (a chunk of rounds, a UTIL pass, a contraction sweep).
- ``{"kind": "event", "name", "cat", "t", "tid", "args"}`` — an
  instant.
- ``{"kind": "metrics", ...MetricsRegistry.snapshot()}`` — appended by
  the session on close, so counters ride in the same file.

The disabled path is :data:`NULL_TRACER` (``enabled`` False): ``span``
returns a shared no-op context manager and ``event`` returns at once.

A session with a flight recorder (``telemetry/flightrec.py``) attaches it
as ``flight``: every span, event and raw record also lands on its bounded
ring, past the ``max_records`` cap.  Spans and events recorded inside a
:func:`~pydcop_tpu_torch.telemetry.context.trace_scope` carry the scope's
request trace id(s) as ``args["trace"]``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from pydcop_tpu_torch.telemetry.context import current_trace_ids


class _Span:
    """Context manager recording one span on exit."""

    __slots__ = ("_tracer", "_name", "_cat", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t0 = self._t0
        self._tracer.add_span(
            self._name, self._cat, t0, time.perf_counter() - t0,
            **self._args,
        )
        return False


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class Tracer:
    """Process-local span/event recorder (thread-safe appends)."""

    enabled = True

    def __init__(
        self,
        path: Optional[str] = None,
        fmt: str = "jsonl",
        max_records: int = 1_000_000,
    ):
        if fmt not in ("jsonl", "chrome"):
            raise ValueError(
                f"trace format must be 'jsonl' or 'chrome', got {fmt!r}"
            )
        self.path = path
        self.fmt = fmt
        # per-message events (the host runtime's deliveries) are high
        # volume: recorded only when the run writes a trace file
        self.detailed = path is not None
        self.max_records = max_records
        self.dropped = 0
        self._epoch = time.perf_counter()
        self._unix_t0 = time.time()
        self._records: List[Dict[str, Any]] = []
        self._closed = False
        self.flight = None

    # -- recording ------------------------------------------------------

    def _append(self, rec: Dict[str, Any]) -> None:
        # ambient request trace ids: spans and events recorded inside a
        # service dispatch's trace_scope get tagged without every
        # producer threading the id through
        if rec.get("kind") in ("span", "event"):
            ids = current_trace_ids()
            if ids is not None:
                args = rec.get("args")
                if args is None:
                    args = rec["args"] = {}
                args.setdefault(
                    "trace", ids[0] if len(ids) == 1 else list(ids)
                )
        # the flight ring overwrites instead of dropping: it stays live
        # past the max_records cap
        flight = self.flight
        if flight is not None:
            flight.record(rec)
        # list.append is GIL-atomic; the cap check may overshoot by a
        # few records under heavy concurrency, which is harmless
        if len(self._records) >= self.max_records:
            self.dropped += 1
            from pydcop_tpu_torch.telemetry import get_metrics

            met = get_metrics()
            if met.enabled:
                met.inc("telemetry.dropped_records")
            return
        self._records.append(rec)

    def span(self, name: str, cat: str = "", **args) -> _Span:
        """Context manager: ``with tracer.span("cycle", ...):``."""
        return _Span(self, name, cat, args)

    def add_span(
        self, name: str, cat: str, start_perf: float, dur: float, **args
    ) -> None:
        """Record an externally-timed span (``start_perf`` is a
        ``time.perf_counter()`` reading)."""
        self._append(
            {
                "kind": "span",
                "name": name,
                "cat": cat,
                "t": start_perf - self._epoch,
                "dur": dur,
                "tid": threading.get_ident(),
                "args": args,
            }
        )

    def event(self, name: str, cat: str = "", **args) -> None:
        """Record an instant event."""
        self._append(
            {
                "kind": "event",
                "name": name,
                "cat": cat,
                "t": time.perf_counter() - self._epoch,
                "tid": threading.get_ident(),
                "args": args,
            }
        )

    def add_record(self, rec: Dict[str, Any]) -> None:
        """Append a raw record (the session's final metrics snapshot)."""
        self._append(rec)

    # -- aggregates -----------------------------------------------------

    def span_summary(self) -> Dict[str, Dict[str, float]]:
        """Per-name span aggregates: count / total / max seconds."""
        out: Dict[str, Dict[str, float]] = {}
        for r in self._records:
            if r.get("kind") != "span":
                continue
            s = out.setdefault(
                r["name"], {"count": 0, "total_s": 0.0, "max_s": 0.0}
            )
            s["count"] += 1
            s["total_s"] += r["dur"]
            s["max_s"] = max(s["max_s"], r["dur"])
        return out

    def event_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for r in self._records:
            if r.get("kind") == "event":
                out[r["name"]] = out.get(r["name"], 0) + 1
        return out

    # -- output ---------------------------------------------------------

    def _meta(self) -> Dict[str, Any]:
        meta: Dict[str, Any] = {
            "kind": "meta",
            "version": 1,
            "unix_t0": self._unix_t0,
            "pid": os.getpid(),
        }
        if self.dropped:
            meta["dropped_records"] = self.dropped
        return meta

    def save(self, path: Optional[str] = None) -> None:
        """Write the trace.  JSONL: meta line + one record per line.
        Chrome: a ``{"traceEvents": [...]}`` object (complete events
        for spans, instants for events; timestamps in microseconds)."""
        path = path or self.path
        if path is None:
            return
        if self.fmt == "jsonl":
            with open(path, "w", encoding="utf-8") as f:
                f.write(json.dumps(self._meta()) + "\n")
                for r in self._records:
                    f.write(json.dumps(r, default=str) + "\n")
            return
        pid = os.getpid()
        events: List[Dict[str, Any]] = []
        for r in self._records:
            kind = r.get("kind")
            if kind == "span":
                events.append(
                    {
                        "name": r["name"],
                        "cat": r["cat"] or "span",
                        "ph": "X",
                        "ts": r["t"] * 1e6,
                        "dur": r["dur"] * 1e6,
                        "pid": pid,
                        "tid": r["tid"],
                        "args": r["args"],
                    }
                )
            elif kind == "event":
                events.append(
                    {
                        "name": r["name"],
                        "cat": r["cat"] or "event",
                        "ph": "i",
                        "ts": r["t"] * 1e6,
                        "s": "p",  # process-scoped instant
                        "pid": pid,
                        "tid": r["tid"],
                        "args": r["args"],
                    }
                )
            elif kind == "metrics":
                events.append(
                    {
                        "name": "metrics",
                        "cat": "metrics",
                        "ph": "i",
                        "ts": (
                            time.perf_counter() - self._epoch
                        ) * 1e6,
                        "s": "p",
                        "pid": pid,
                        "tid": 0,
                        "args": {
                            k: v for k, v in r.items() if k != "kind"
                        },
                    }
                )
        with open(path, "w", encoding="utf-8") as f:
            json.dump(
                {
                    "traceEvents": events,
                    "displayTimeUnit": "ms",
                    "metadata": self._meta(),
                },
                f,
                default=str,
            )

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.save()


class _NullTracer:
    """Disabled tracer: ``enabled``/``detailed`` are the guards."""

    enabled = False
    detailed = False

    def span(self, name: str, cat: str = "", **args) -> _NullSpan:
        return _NULL_SPAN

    def add_span(self, name, cat, start_perf, dur, **args) -> None:
        pass

    def event(self, name: str, cat: str = "", **args) -> None:
        pass

    def add_record(self, rec) -> None:
        pass

    def span_summary(self):
        return {}

    def event_counts(self):
        return {}

    def close(self) -> None:
        pass


NULL_TRACER = _NullTracer()
