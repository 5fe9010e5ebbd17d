"""ChaosCommunicationLayer: apply a :class:`FaultPlan` to any
communication layer (a copy of ``pydcop_tpu/faults/chaos.py``).

The wrapper sits between an agent's computations and its real
transport (in-process queues or the TCP message plane) and gives every
outbound message to the plan: drop it, duplicate it, swap it with the
next one on the same link, delay it, hold it through a partition
window, or — past the tolerance grace window — declare the link dead
exactly the way a retried-out TCP channel would, so the runtimes'
permanent-failure paths (repair, graceful degradation) fire from
*injected* faults the same as from real ones.

Determinism contract: WHICH message suffers WHICH fault is a pure
function of ``(plan seed, link, per-link sequence number)`` — recorded
in :attr:`events` as ``(kind, link, seq)`` tuples, so two runs with
the same plan produce the identical per-link event sequence.  Delivery
*timing* of delayed messages naturally follows the wall clock; per-link
FIFO order is preserved through delays and holds (only an explicit
``reorder`` fault violates it, by design).
"""

from __future__ import annotations

import heapq
import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from pydcop_tpu_torch.faults.plan import FaultPlan
from pydcop_tpu_torch.infrastructure.communication import (
    MSG_ALGO,
    CommunicationLayer,
    UnknownComputation,
    UnreachableAgent,
)
from pydcop_tpu_torch.infrastructure.computations import Message
from pydcop_tpu_torch.telemetry import get_metrics, get_tracer

logger = logging.getLogger(__name__)

# a reorder-held message is released after this long when no follow-up
# message arrives on its link to swap with (an unpaired hold must not
# strand the last message of a link forever)
REORDER_RELEASE = 0.25


class ChaosCommunicationLayer(CommunicationLayer):
    """Wrap ``inner`` and apply ``plan`` to every outbound message of
    agent ``src_agent``.

    ``grace`` is the transient-fault tolerance window: a partition
    whose remaining outage exceeds it flips the link from "hold and
    heal" to "dead" — reported once through ``on_send_error`` (the
    same hook the TCP plane's writer uses), after which messages to
    the dead link are recorded and dropped.  ``on_crash`` runs when
    the plan schedules this agent's crash (process runtimes pass a
    hard-exit; in-process runtimes reject crash clauses instead).

    Registration, discovery, addressing and the inbound path all
    delegate to ``inner`` — chaos is outbound-only, which is enough:
    every link has a chaos layer at its sending end.
    """

    def __init__(
        self,
        inner: CommunicationLayer,
        plan: FaultPlan,
        src_agent: str,
        grace: float = 5.0,
        on_send_error: Optional[Callable[[str, BaseException], None]] = None,
        on_crash: Optional[Callable[[], None]] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        # no super().__init__: discovery is delegated to inner so the
        # transport's own inbound routing keeps working unchanged
        self.inner = inner
        self.plan = plan
        self.src_agent = src_agent
        self.grace = grace
        self.on_send_error = on_send_error
        self._clock = clock
        self._t0 = clock()
        self._lock = threading.Lock()
        self._seq: Dict[str, int] = {}  # per-destination message count
        self._last_due: Dict[str, float] = {}  # per-dest FIFO fence
        self._dead: Dict[str, str] = {}  # dest -> reason
        self._reorder_held: Dict[str, List[tuple]] = {}
        self._in_flight = 0  # accepted but not yet handed to inner
        self.events: List[Tuple[str, str, int]] = []
        # scheduler: one timer wheel for delays, partition holds,
        # reorder releases and the crash schedule
        self._heap: List[tuple] = []
        self._heap_n = 0
        self._cond = threading.Condition(self._lock)
        self._closing = False
        self._thread = threading.Thread(
            target=self._scheduler_loop,
            name=f"chaos-{src_agent}",
            daemon=True,
        )
        self._thread.start()
        crash_t = plan.crash_at(src_agent)
        if crash_t is not None:
            self._schedule(self._t0 + crash_t, self._crash, on_crash)

    # -- delegation -----------------------------------------------------

    @property
    def discovery(self):
        return self.inner.discovery

    def register(self, agent_name: str, messaging) -> None:
        self.inner.register(agent_name, messaging)

    def unregister(self, agent_name: str) -> None:
        self.inner.unregister(agent_name)

    def set_addresses(self, directory) -> None:
        self.inner.set_addresses(directory)

    def forget_agent(self, name: str) -> None:
        self.inner.forget_agent(name)

    @property
    def address(self):
        return self.inner.address

    @property
    def count_sent(self) -> int:
        """Inner transport's ledger PLUS chaos-held messages: a frame
        waiting out a delay or partition must keep the orchestrator's
        two-counter quiescence rule (sent == delivered) from firing
        while it is invisible to both transport and destination."""
        with self._lock:
            held = self._in_flight
        return getattr(self.inner, "count_sent", 0) + held

    @property
    def in_flight(self) -> int:
        """Messages accepted from computations but not yet given to the
        transport (delayed / partition-held / reorder-held) — the
        in-process runtimes add this to their idle predicate."""
        with self._lock:
            return self._in_flight

    def close(self) -> None:
        with self._cond:
            self._closing = True
            self._cond.notify_all()
        if hasattr(self.inner, "close"):
            self.inner.close()

    # -- event record ---------------------------------------------------

    def _record(self, kind: str, dest: str, seq: int) -> None:
        link = f"{self.src_agent}>{dest}"
        with self._lock:
            self.events.append((kind, link, seq))
        # injected faults land on the run's telemetry timeline (same
        # trace as cycle/message events) — only when a session is
        # active, and always outside the lock
        met = get_metrics()
        if met.enabled:
            met.inc(f"fault.{kind}")
        tr = get_tracer()
        if tr.enabled:
            tr.event(
                kind, cat="fault", link=link, seq=seq,
                seed=self.plan.seed,
            )

    def event_summary(self) -> Dict[str, int]:
        with self._lock:
            counts: Dict[str, int] = {}
            for kind, _, _ in self.events:
                counts[kind] = counts.get(kind, 0) + 1
            return counts

    # -- outbound -------------------------------------------------------

    def send_msg(
        self,
        dest_agent: str,
        src_comp: str,
        dest_comp: str,
        msg: Message,
        priority: int = MSG_ALGO,
    ) -> None:
        if dest_agent == self.src_agent:
            # an agent's own loopback is process-internal memory, not a
            # network link — never faulted
            self.inner.send_msg(dest_agent, src_comp, dest_comp, msg, priority)
            return
        now = self._clock() - self._t0
        with self._lock:
            seq = self._seq[dest_agent] = self._seq.get(dest_agent, 0) + 1
            dead = self._dead.get(dest_agent)
        if dead is not None:
            self._record("unreachable", dest_agent, seq)
            return  # link already declared dead (reported once)
        heal = self.plan.partition_heal(self.src_agent, dest_agent, now)
        send = (dest_agent, src_comp, dest_comp, msg, priority)
        if heal is not None:
            if heal - now <= self.grace:
                # transient blip: hold, release at heal time (FIFO)
                self._record("hold", dest_agent, seq)
                self._defer(heal, send)
            else:
                # outlives the grace window: after grace actually
                # elapses (the time a retrying transport would spend),
                # the link is declared dead — the permanent-fault path
                self._record("partition", dest_agent, seq)
                with self._lock:
                    self._in_flight += 1
                self._schedule(
                    self._t0 + now + self.grace, self._give_up, dest_agent
                )
            return
        d = self.plan.decide(self.src_agent, dest_agent, seq)
        if d.drop:
            self._record("drop", dest_agent, seq)
            return
        if d.dup:
            self._record("dup", dest_agent, seq)
            self._dispatch(send)
            self._dispatch(send)
            return
        if d.reorder:
            # hold this message; the NEXT one on the link overtakes it
            self._record("reorder", dest_agent, seq)
            with self._lock:
                self._in_flight += 1
                self._reorder_held.setdefault(dest_agent, []).append(send)
            self._schedule(
                self._clock() + REORDER_RELEASE,
                self._release_reorder, dest_agent,
            )
            return
        if d.delay:
            self._record("delay", dest_agent, seq)
            self._defer(now + d.delay, send)
            return
        self._dispatch(send)

    # -- internals ------------------------------------------------------

    def _dispatch(self, send: tuple) -> None:
        """Hand one message to the transport, respecting the per-dest
        FIFO fence (a message may never overtake an earlier held one),
        then release any reorder-held message it overtakes."""
        dest = send[0]
        with self._lock:
            fence = self._last_due.get(dest, 0.0)
            now_abs = self._clock()
            if fence > now_abs:
                self._in_flight += 1
                self._push(fence, self._forward_scheduled, send)
                held = []
            else:
                held = self._reorder_held.pop(dest, [])
                if held:
                    self._in_flight -= len(held)
        if fence > now_abs:
            return
        self._forward(send)
        for h in held:
            self._forward(h)

    def _defer(self, due_rel: float, send: tuple) -> None:
        """Schedule a forward at ``due_rel`` (run-relative seconds),
        advancing the link's FIFO fence so later immediate messages
        queue up behind it instead of overtaking."""
        dest = send[0]
        due_abs = self._t0 + due_rel
        with self._lock:
            due_abs = max(due_abs, self._last_due.get(dest, 0.0))
            self._last_due[dest] = due_abs
            self._in_flight += 1
            self._push(due_abs, self._forward_scheduled, send)

    def _forward_scheduled(self, send: tuple) -> None:
        with self._lock:
            self._in_flight -= 1
        self._forward(send)

    def _forward(self, send: tuple) -> None:
        dest_agent, src_comp, dest_comp, msg, priority = send
        with self._lock:
            if dest_agent in self._dead:
                return  # a hold released after the link died: nothing
                # may be delivered on a dead link (reported already)
        try:
            self.inner.send_msg(dest_agent, src_comp, dest_comp, msg, priority)
        except (UnreachableAgent, UnknownComputation) as e:
            # the transport's own failure, surfaced the transport's way
            cb = self.on_send_error
            if cb is not None:
                cb(dest_agent, e)
            else:
                logger.warning(
                    "chaos: transport failure to %s: %s", dest_agent, e
                )

    def _give_up(self, dest_agent: str) -> None:
        with self._lock:
            already = dest_agent in self._dead
            self._dead[dest_agent] = "injected partition outlived grace"
            self._in_flight -= 1  # the frame that triggered this hold
            dropped = self._reorder_held.pop(dest_agent, [])
            self._in_flight -= len(dropped)
        if already:
            return
        err = UnreachableAgent(
            f"{dest_agent}: injected partition outlived the "
            f"{self.grace:.1f}s grace window"
        )
        cb = self.on_send_error
        if cb is not None:
            cb(dest_agent, err)
        else:
            logger.warning("chaos: %s", err)

    def _release_reorder(self, dest_agent: str) -> None:
        """No follow-up message arrived to swap with: release."""
        with self._lock:
            held = self._reorder_held.pop(dest_agent, [])
            self._in_flight -= len(held)
        for send in held:
            self._forward(send)

    def _crash(self, on_crash: Optional[Callable[[], None]]) -> None:
        self._record("crash", self.src_agent, 0)
        if on_crash is not None:
            on_crash()
        else:  # pragma: no cover — wiring always sets on_crash
            logger.warning(
                "chaos: crash scheduled for %s but no on_crash handler "
                "installed; ignoring", self.src_agent,
            )

    # -- timer wheel ----------------------------------------------------

    def _push(self, due_abs: float, fn, arg) -> None:
        """Caller holds the lock."""
        self._heap_n += 1
        heapq.heappush(self._heap, (due_abs, self._heap_n, fn, arg))
        self._cond.notify()

    def _schedule(self, due_abs: float, fn, arg) -> None:
        with self._lock:
            self._push(due_abs, fn, arg)

    def _scheduler_loop(self) -> None:
        while True:
            with self._cond:
                while not self._closing:
                    if self._heap:
                        wait = self._heap[0][0] - self._clock()
                        if wait <= 0:
                            break
                        self._cond.wait(wait)
                    else:
                        self._cond.wait()
                if self._closing:
                    return
                _, _, fn, arg = heapq.heappop(self._heap)
            try:
                fn(arg)  # outside the lock: may hit the real network
            except Exception:  # pragma: no cover — keep the wheel alive
                logger.exception("chaos scheduler action failed")
