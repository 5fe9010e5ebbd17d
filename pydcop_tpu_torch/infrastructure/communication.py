"""Communication layer + per-agent Messaging router (a copy of
``pydcop_tpu/infrastructure/communication.py``; reference:
``pydcop/infrastructure/communication.py``).

The reference ships two interchangeable layers: in-process queues and
HTTP+JSON.  Here the in-process layer backs ``--mode thread``; the
cross-process TCP plane is ``infrastructure/hostnet.py``
(``TcpCommunicationLayer``).

``Messaging`` preserves the reference's observable behavior: priority
classes (management messages preempt algorithm messages), per-message
count/size metrics, and failure surfacing for unknown computations.
"""

from __future__ import annotations

import heapq
import threading
from typing import Dict, Optional, Tuple

from pydcop_tpu_torch.infrastructure.computations import Message
from pydcop_tpu_torch.telemetry import get_metrics, get_tracer

# priority classes: lower value = delivered first
MSG_MGT = 10
MSG_VALUE = 15
MSG_ALGO = 20


class UnknownComputation(Exception):
    pass


class UnreachableAgent(Exception):
    pass


class CommunicationLayer:
    """Transport abstraction: routes a message to the agent hosting the
    destination computation."""

    def __init__(self):
        self.discovery: Dict[str, "Messaging"] = {}

    def register(self, agent_name: str, messaging: "Messaging") -> None:
        self.discovery[agent_name] = messaging

    def unregister(self, agent_name: str) -> None:
        self.discovery.pop(agent_name, None)

    def send_msg(
        self,
        dest_agent: str,
        src_comp: str,
        dest_comp: str,
        msg: Message,
        priority: int = MSG_ALGO,
    ) -> None:
        raise NotImplementedError


class InProcessCommunicationLayer(CommunicationLayer):
    """Direct queue delivery between agents of one process."""

    def send_msg(
        self,
        dest_agent: str,
        src_comp: str,
        dest_comp: str,
        msg: Message,
        priority: int = MSG_ALGO,
    ) -> None:
        messaging = self.discovery.get(dest_agent)
        if messaging is None:
            raise UnreachableAgent(dest_agent)
        messaging.deliver(src_comp, dest_comp, msg, priority)


class MessageLog:
    """Full-message-content log (reference parity: the reference's
    ``Messaging`` can dump every message for debugging a distributed
    run — SURVEY §5 tracing row).  One JSON line per delivered
    message: ``{t, agent, src, dest, type, size, content}`` with the
    content in ``simple_repr`` form (the wire format), so a log line
    is exactly what the TCP plane would have carried.

    One run per file: the path is truncated on open, so rerunning
    against the same path cannot silently interleave two runs' lines.
    Thread-safe append; logging failures never break delivery."""

    def __init__(self, path: str):
        import threading as _threading

        self._f = open(path, "w", encoding="utf-8")
        self._lock = _threading.Lock()

    def log(self, agent: str, src: str, dest: str, msg: Message) -> None:
        import json as _json
        import time as _time

        from pydcop_tpu_torch.utils.simple_repr import simple_repr

        try:
            line = _json.dumps(
                {
                    "t": _time.time(),
                    "agent": agent,
                    "src": src,
                    "dest": dest,
                    "type": msg.type,
                    "size": msg.size,
                    "content": simple_repr(msg),
                },
                default=str,
            )
            with self._lock:
                self._f.write(line + "\n")
        except Exception:
            pass  # a malformed message must not break delivery

    def flush(self) -> None:
        """Push buffered lines to the OS — called at agent shutdown so
        the tail of a log survives even an abrupt process exit after
        stop (close() also flushes, but a shared log may outlive one
        agent's stop)."""
        try:
            with self._lock:
                if not self._f.closed:
                    self._f.flush()
        except Exception:
            pass

    def close(self) -> None:
        try:
            with self._lock:
                self._f.close()
        except Exception:
            pass


class Messaging:
    """Per-agent message router with priority queues and metrics.

    One consumer (the agent thread) pops with :meth:`next_msg`; any
    thread may :meth:`deliver`.  Counts every message and its logical
    size (``Message.size``), split by priority class — the counters the
    reference's msgs/sec metric is derived from.

    A popped message stays accounted in :attr:`pending` until the
    consumer calls :meth:`task_done`: the pop and the in-flight mark
    happen under one lock, so a quiescence monitor reading ``pending``
    can never observe the gap between "message dequeued" and "handler
    started" (that gap once let thread-mode runs terminate with a
    message in flight).
    """

    def __init__(self, agent_name: str, msg_log: Optional[MessageLog] = None):
        self.agent_name = agent_name
        self._heap: list = []
        self._seq = 0  # FIFO tie-break within a priority class
        self._cond = threading.Condition()
        self._in_flight = False
        self.count_msg = 0
        self.size_msg = 0
        self.count_by_priority: Dict[int, int] = {}
        self.msg_log = msg_log

    def deliver(
        self,
        src_comp: str,
        dest_comp: str,
        msg: Message,
        priority: int = MSG_ALGO,
    ) -> None:
        with self._cond:
            self._seq += 1
            self.count_msg += 1
            self.size_msg += msg.size
            self.count_by_priority[priority] = (
                self.count_by_priority.get(priority, 0) + 1
            )
            heapq.heappush(
                self._heap, (priority, self._seq, src_comp, dest_comp, msg)
            )
            self._cond.notify()
        # telemetry outside the lock: one attribute check when disabled
        # (docs/observability.md overhead notes)
        met = get_metrics()
        if met.enabled:
            met.inc("msg.delivered")
            met.inc("msg.size", msg.size)
        tr = get_tracer()
        if tr.detailed:
            tr.event(
                "deliver", cat="message", agent=self.agent_name,
                src=src_comp, dest=dest_comp, type=msg.type,
            )
        if self.msg_log is not None:  # outside the lock: file IO
            self.msg_log.log(self.agent_name, src_comp, dest_comp, msg)

    def next_msg(
        self, timeout: Optional[float] = None
    ) -> Optional[Tuple[str, str, Message]]:
        """Pop the next (src, dest, msg), or None on timeout.

        Atomically marks the popped message in-flight; the consumer
        must call :meth:`task_done` when its handler finishes.
        """
        with self._cond:
            if not self._heap:
                self._cond.wait(timeout)
            if not self._heap:
                return None
            _, _, src, dest, msg = heapq.heappop(self._heap)
            self._in_flight = True
            return src, dest, msg

    def task_done(self) -> None:
        """Mark the last popped message as fully handled."""
        with self._cond:
            self._in_flight = False

    @property
    def pending(self) -> int:
        """Queued messages + the in-flight one (if any)."""
        with self._cond:
            return len(self._heap) + (1 if self._in_flight else 0)

    @property
    def queued(self) -> int:
        """Waiting messages only, excluding the in-flight one.

        The island flush probe needs "anything still to deliver?"
        regardless of whether it is asked from inside a handler (one
        in-flight message — the one that triggered the probe) or from
        ``on_start`` (none): counting the heap alone answers both
        without the caller guessing the in-flight state.
        """
        with self._cond:
            return len(self._heap)
