"""Telemetry: structured tracing and a metrics registry, one session
per run (a port of ``pydcop_tpu/telemetry/__init__.py``).

- :class:`~pydcop_tpu_torch.telemetry.tracer.Tracer` — span/event
  records on one process-local timeline, written as JSONL or Chrome
  ``trace_event``.
- :class:`~pydcop_tpu_torch.telemetry.metrics.MetricsRegistry` —
  counters, gauges and fixed-bucket histograms that the hot paths update
  behind a single attribute check.

Producers never hold a session: they call :func:`get_tracer` /
:func:`get_metrics`, which return no-op singletons (``enabled`` False)
unless a :func:`session` is active.  ``api.solve``, ``solve_many``,
``infer`` and ``infer_many`` open a session around every run (in memory
only, or writing a trace file when ``trace=``/``--trace`` is given) and
attach :meth:`TelemetrySession.summary` to ``result["telemetry"]``.

What the JAX package records and this package does not: its ``jit.*``
counters, ``jit-compile`` spans and ``backend-compile`` events time XLA
compiles, and its ``engine.runner_cache_*`` counters a jitted-runner
cache; the port compiles neither (its CUDA kernels are built once per
checkout).

Every session also carries the always-on flight recorder
(:class:`~pydcop_tpu_torch.telemetry.flightrec.FlightRecorder`, unless
``flight=False``): a bounded ring that every span, event and counter
delta lands on, which the solver service dumps on its failure triggers
(:func:`get_flight_recorder`).
"""

from __future__ import annotations

import contextlib
import threading as _threading
from typing import Iterator, Optional

from pydcop_tpu_torch.telemetry.flightrec import (  # noqa: F401 (re-exports)
    FlightRecorder,
    NULL_FLIGHT,
)
from pydcop_tpu_torch.telemetry.metrics import (  # noqa: F401 (re-exports)
    DEFAULT_BUCKETS,
    Histogram,
    MetricsRegistry,
    NULL_METRICS,
)
from pydcop_tpu_torch.telemetry.tracer import (  # noqa: F401 (re-exports)
    NULL_TRACER,
    Tracer,
)

_tracer = NULL_TRACER
_metrics = NULL_METRICS
_active: Optional["TelemetrySession"] = None
_install_lock = _threading.Lock()


def get_tracer():
    """The active session's tracer, or the no-op singleton."""
    return _tracer


def get_metrics():
    """The active session's metrics registry, or the no-op singleton."""
    return _metrics


def get_flight_recorder():
    """The active session's flight recorder, or the no-op singleton."""
    sess = _active
    if sess is not None and sess.flight is not None:
        return sess.flight
    return NULL_FLIGHT


def active_session() -> Optional["TelemetrySession"]:
    return _active


class TelemetrySession:
    """One run's tracer + metrics (+ flight recorder) set."""

    def __init__(
        self,
        tracer: Tracer,
        metrics: MetricsRegistry,
        flight: Optional[FlightRecorder] = None,
    ):
        self.tracer = tracer
        self.metrics = metrics
        self.flight = flight
        self.closed = False

    def summary(self) -> dict:
        """The ``result["telemetry"]`` payload: per-phase span totals,
        event counts, and the metrics snapshot (``{phases, events,
        counters, gauges, histograms}``, plus ``dropped_records`` when
        the tracer's record cap bit)."""
        snap = self.metrics.snapshot()
        out = {
            "phases": self.tracer.span_summary(),
            "events": self.tracer.event_counts(),
            **snap,
        }
        dropped = getattr(self.tracer, "dropped", 0)
        if dropped:
            out["dropped_records"] = dropped
        return out

    def close(self) -> None:
        """Append the metrics snapshot to the trace and write it."""
        self.closed = True
        snap = self.metrics.snapshot()
        if any(snap.values()):
            self.tracer.add_record({"kind": "metrics", **snap})
        self.tracer.close()


@contextlib.contextmanager
def session(
    trace_path: Optional[str] = None,
    trace_format: str = "jsonl",
    flight: bool = True,
) -> Iterator[TelemetrySession]:
    """Install a telemetry session for the duration of the block.

    With ``trace_path`` set, the tracer writes the trace file (in
    ``trace_format``: ``jsonl`` or ``chrome``) when the block exits.
    Without a path the session still collects spans and counters in
    memory for ``result["telemetry"]``.  ``flight`` (default on)
    attaches the bounded flight-recorder ring
    (``telemetry/flightrec.py``): every span, event and counter delta
    also lands there, dumpable on failure triggers with no trace file.

    Nesting: entering with no ``trace_path`` while a session is already
    active REUSES the active session (records flow to the outer run's
    timeline, so an embedding application can wrap several calls in one
    trace).  A ``trace_path`` always opens a fresh session; the outer
    one is restored on exit.  The install and restore are process-wide
    and guarded, so a newer session installed by another thread is never
    clobbered and a closed one is never reinstalled.
    """
    global _tracer, _metrics, _active
    with _install_lock:
        if trace_path is None and _active is not None:
            reuse = _active
        else:
            reuse = None
            tracer = Tracer(path=trace_path, fmt=trace_format)
            metrics = MetricsRegistry()
            rec = None
            if flight:
                # shares the tracer's timebase, so a dump sorts on one
                # timeline
                rec = FlightRecorder(
                    epoch=tracer._epoch, unix_t0=tracer._unix_t0
                )
                tracer.flight = rec
                metrics.flight = rec
            sess = TelemetrySession(tracer, metrics, flight=rec)
            prev = (_tracer, _metrics, _active)
            _tracer, _metrics, _active = tracer, metrics, sess
    if reuse is not None:
        yield reuse
        return
    try:
        yield sess
    finally:
        with _install_lock:
            if _active is sess:
                if prev[2] is not None and prev[2].closed:
                    _tracer, _metrics, _active = (
                        NULL_TRACER, NULL_METRICS, None
                    )
                else:
                    _tracer, _metrics, _active = prev
        sess.close()
