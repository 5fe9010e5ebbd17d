"""Request trace context: the ids that correlate one logical request
across the wire, across client retries, and across processes (a copy of
``pydcop_tpu/telemetry/context.py``; the ids are the JAX package's, so
the two packages' clients and servers stitch into one timeline).

A **trace id** names one logical request for its whole life: the
:class:`~pydcop_tpu_torch.engine.service.ServiceClient` mints it at submit
time and every resend of the same frame carries the SAME id (it rides
the request frame next to the idempotency key), so a retry whose reply
is replayed from the server's cache stitches back to the ORIGINAL
server-side spans instead of looking like a second solve.  A **span
id** names one delivery attempt: fresh per resend, so the stitched
timeline (``trace-summary --requests``) can show attempt 1
dying to a ``conn_drop`` and attempt 2 landing on the cached reply.

Both ids are PURE functions of their inputs (blake2b over the client
id / request ordinal / attempt) — no clocks, no entropy.  That is a
feature, not an accident: the chaos-soak determinism contract (same
seed + same admission order ⇒ identical outcome sequence) extends to
the telemetry plane: two soak runs produce identical stitched
timelines.

The deliberate flip side of purity: two client LIFETIMES reusing an
explicit ``client_id`` re-mint the same trace ids (request ordinals
restart at 1), so a long-lived server trace stitches both lives'
request #N into one timeline.  Trace ids are correlation hints for
operators, so that ambiguity costs a merged report row at worst; the
idempotency key — which guards *correctness* (reply-cache replay) —
keeps its per-lifetime ``os.urandom`` nonce precisely because it may
not collide.  Deployments stitching across restarts should put a
lifetime marker in the ``client_id`` itself.

The **ambient scope** half is how spans recorded deep inside the
engine get tagged without threading a trace argument through every
layer: the service installs :func:`trace_scope` around each dispatch,
and the tracer stamps every span/event recorded inside the scope with
the active trace id(s) (a group dispatch carries every member's id).
Thread-local, like the supervisor and the telemetry session.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Optional, Sequence, Tuple

#: the wire form: ``{"id": trace-id, "span": attempt-span-id,
#: "attempt": N}``, carried in the request frame next to ``ikey``
WIRE_KEYS = ("id", "span", "attempt")


def mint_trace_id(client_id: str, ordinal: int) -> str:
    """The trace id of one logical request: pure in (client id,
    per-client request ordinal), stable across resends."""
    h = hashlib.blake2b(
        f"{client_id}:{ordinal}".encode("utf-8"), digest_size=8
    )
    return f"tr-{h.hexdigest()}"


def attempt_span_id(trace_id: str, attempt: int) -> str:
    """The span id of one delivery attempt: fresh per resend."""
    h = hashlib.blake2b(
        f"{trace_id}:{attempt}".encode("utf-8"), digest_size=6
    )
    return f"sp-{h.hexdigest()}"


def wire_trace(trace_id: str, attempt: int) -> dict:
    """The request frame's ``"trace"`` field for one attempt."""
    return {
        "id": trace_id,
        "span": attempt_span_id(trace_id, attempt),
        "attempt": attempt,
    }


def parse_wire_trace(obj) -> Optional[Tuple[str, str, int]]:
    """Validate an inbound frame's ``"trace"`` field into
    ``(trace_id, span_id, attempt)``; None when absent or malformed
    (tracing is best-effort — a bad trace field never rejects the
    request it rides on)."""
    if not isinstance(obj, dict):
        return None
    tid, sid = obj.get("id"), obj.get("span")
    if not isinstance(tid, str) or not tid:
        return None
    if not isinstance(sid, str):
        sid = ""
    try:
        attempt = int(obj.get("attempt", 1))
    except (TypeError, ValueError):
        attempt = 1
    return (tid[:128], sid[:128], attempt)


_scope = threading.local()


def current_trace_ids() -> Optional[Tuple[str, ...]]:
    """Trace ids of the enclosing :func:`trace_scope`, or None."""
    return getattr(_scope, "ids", None)


class trace_scope:
    """Context manager: tag every span/event the current thread
    records with these trace ids (the tracer reads
    :func:`current_trace_ids` at append time).  Re-entrant; ``None``
    / empty id lists make it a no-op, so callers need no guard."""

    __slots__ = ("_ids", "_prev")

    def __init__(self, ids: Optional[Sequence[Optional[str]]]):
        clean = tuple(i for i in (ids or ()) if i)
        self._ids = clean or None

    def __enter__(self):
        self._prev = getattr(_scope, "ids", None)
        if self._ids is not None:
            _scope.ids = self._ids
        return self

    def __exit__(self, *exc):
        if self._ids is not None:
            _scope.ids = self._prev
        return False
