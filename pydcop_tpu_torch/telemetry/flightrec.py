"""Always-on flight recorder: a fixed-size ring of recent telemetry
records, dumped atomically when something goes wrong (a copy of
``pydcop_tpu/telemetry/flightrec.py``; the dump document is the JAX
package's, so either package's ``flight-dump`` renders it).

The tracer's 1M-record buffer is a *post-mortem* artifact: it only
becomes a file when a ``--trace`` path was configured up front, and on
a resident service that is almost never the case when a request comes
back ``status="degraded"`` or ``"shed"``.  The flight recorder is the
memory-bounded answer — the same discipline the capacity model applies
to device memory, applied to the telemetry plane: a ``deque(maxlen=N)``
that EVERY session feeds (spans, events, counter/gauge deltas) whether
or not a trace file exists.  Appending is one bounded-deque push; the
ring overwrites its oldest record and **never drops silently** — in
particular it is immune to the tracer's ``max_records`` cap
(``tests/test_torch_service_wire.py`` pins both properties).

On a trigger (a quarantined lane, a shed, an unrecoverable dispatch, a
drain, SIGTERM) the owner calls :meth:`FlightRecorder.dump`: the ring
is written atomically (tmp + rename, like the session checkpoint) with
the TRIGGERING REQUEST's trace id front and center, and
``flight-dump FILE`` renders it.  Dumps count on
``telemetry.flight_dumps``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

#: default ring capacity: enough for several ticks of a busy service
#: (spans + counters per request) while staying a few hundred KB
DEFAULT_RING = 4096

#: the dump document's schema marker
DUMP_KIND = "pydcop_tpu-flight"


class FlightRecorder:
    """Bounded ring of telemetry records (thread-safe appends — the
    deque's maxlen push is GIL-atomic, like the tracer's buffer)."""

    enabled = True

    def __init__(
        self,
        maxlen: int = DEFAULT_RING,
        epoch: Optional[float] = None,
        unix_t0: Optional[float] = None,
    ):
        if maxlen < 1:
            raise ValueError(f"ring size must be >= 1, got {maxlen}")
        self.maxlen = maxlen
        # shared timebase with the owning session's tracer, so span
        # records (stamped with the tracer epoch) and counter deltas
        # (stamped here) sort on one timeline
        self._epoch = time.perf_counter() if epoch is None else epoch
        self._unix_t0 = time.time() if unix_t0 is None else unix_t0
        self._ring: deque = deque(maxlen=maxlen)
        self.dumps = 0

    # -- recording (the hot side) -----------------------------------------

    def record(self, rec: Dict[str, Any]) -> None:
        """Append one tracer-schema record (span/event/raw)."""
        self._ring.append(rec)

    def counter(self, name: str, n: float) -> None:
        """Append one counter delta."""
        self._ring.append(
            {
                "kind": "counter",
                "name": name,
                "n": n,
                "t": time.perf_counter() - self._epoch,
            }
        )

    def gauge(self, name: str, value: float) -> None:
        self._ring.append(
            {
                "kind": "gauge",
                "name": name,
                "value": value,
                "t": time.perf_counter() - self._epoch,
            }
        )

    # -- dumping (the cold side) ------------------------------------------

    def snapshot(self) -> List[Dict[str, Any]]:
        """Oldest-first copy of the ring (appends racing the copy may
        shift the window by a record — acceptable for a crash
        artifact)."""
        return list(self._ring)

    def dump(
        self,
        path: str,
        trigger: str,
        trace_id: Optional[str] = None,
        **extra: Any,
    ) -> Dict[str, Any]:
        """Write the ring atomically to ``path`` and return the
        document.  ``trigger`` says WHY (``shed`` / ``quarantine`` /
        ``error`` / ``drain`` / ``sigterm``), ``trace_id`` names the
        request that pulled the trigger."""
        doc: Dict[str, Any] = {
            "kind": DUMP_KIND,
            "version": 1,
            "trigger": trigger,
            "trace_id": trace_id,
            "unix_t0": self._unix_t0,
            "t_dump": time.perf_counter() - self._epoch,
            "pid": os.getpid(),
            "ring_size": self.maxlen,
        }
        doc.update(extra)
        doc["records"] = self.snapshot()
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(doc, f, default=str)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        self.dumps += 1
        # count on the live registry (import at call time: metrics and
        # the session module import flightrec, not the reverse)
        from pydcop_tpu_torch.telemetry import get_metrics

        met = get_metrics()
        if met.enabled:
            met.inc("telemetry.flight_dumps")
        return doc


class _NullFlightRecorder:
    """Disabled recorder (no session): the one-attribute-check guard,
    like the null tracer/metrics singletons."""

    enabled = False

    def record(self, rec) -> None:
        pass

    def counter(self, name, n) -> None:
        pass

    def gauge(self, name, value) -> None:
        pass

    def snapshot(self):
        return []

    def dump(self, path, trigger, trace_id=None, **extra):
        raise RuntimeError(
            "no flight recorder is active (open a telemetry session "
            "first)"
        )


NULL_FLIGHT = _NullFlightRecorder()


def load_dump(path: str) -> Dict[str, Any]:
    """Read and validate a flight dump file."""
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or doc.get("kind") != DUMP_KIND:
        raise ValueError(f"{path} is not a flight-recorder dump")
    return doc


def format_dump(doc: Dict[str, Any], tail: int = 0) -> str:
    """Human-readable rendering for ``flight-dump``: the
    trigger + triggering trace id up top, then the recent timeline
    (``tail`` > 0 limits to the newest N records) with the triggering
    request's records flagged."""
    lines: List[str] = []
    trace_id = doc.get("trace_id")
    lines.append(
        f"flight dump: trigger={doc.get('trigger')!r} "
        f"trace={trace_id or '-'} pid={doc.get('pid')} "
        f"ring={doc.get('ring_size')}"
    )
    records = doc.get("records") or []
    shown = records[-tail:] if tail and tail > 0 else records
    if len(shown) < len(records):
        lines.append(f"... ({len(records) - len(shown)} older records)")
    for r in shown:
        kind = r.get("kind")
        t = r.get("t")
        ts = f"{t:>10.4f}" if isinstance(t, (int, float)) else " " * 10
        args = r.get("args") or {}
        rtrace = args.get("trace")
        hit = (
            "*"
            if trace_id
            and (
                rtrace == trace_id
                or (isinstance(rtrace, (list, tuple)) and trace_id in rtrace)
            )
            else " "
        )
        if kind == "span":
            lines.append(
                f"{hit}{ts} span  {r.get('name'):<24} "
                f"dur={r.get('dur', 0.0):.4f} "
                + _fmt_args(args)
            )
        elif kind == "event":
            lines.append(
                f"{hit}{ts} event {r.get('name'):<24} " + _fmt_args(args)
            )
        elif kind == "counter":
            lines.append(
                f"{hit}{ts} count {r.get('name'):<24} +{r.get('n')}"
            )
        elif kind == "gauge":
            lines.append(
                f"{hit}{ts} gauge {r.get('name'):<24} ={r.get('value')}"
            )
        else:
            lines.append(f"{hit}{ts} {kind}")
    if not records:
        lines.append("(empty ring)")
    return "\n".join(lines)


def _fmt_args(args: Dict[str, Any]) -> str:
    return " ".join(
        f"{k}={v}" for k, v in sorted(args.items()) if v is not None
    )
