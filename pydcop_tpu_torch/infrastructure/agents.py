"""Thread-per-agent execution container (a copy of
``pydcop_tpu/infrastructure/agents.py``; reference:
``pydcop/infrastructure/agents.py``).

One :class:`Agent` = one daemon thread + one :class:`Messaging` router
+ the computations the distribution placed on it.  This is the
``--mode thread`` execution path; production solving uses the batched
engine instead (``pydcop_tpu_torch.engine``).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

from pydcop_tpu_torch.infrastructure.communication import (
    MSG_ALGO,
    CommunicationLayer,
    Messaging,
    UnknownComputation,
    UnreachableAgent,
)
from pydcop_tpu_torch.infrastructure.computations import (
    Message,
    MessagePassingComputation,
)


class Agent:
    """Hosts computations and pumps their messages on its own thread.

    Routing goes through a shared :class:`Discovery` directory
    (registration/removal events flow to its subscribers, the
    reference's dynamic-discovery behavior); a private one is created
    when none is given.
    """

    def __init__(
        self,
        name: str,
        comm: CommunicationLayer,
        on_error: Optional[Callable[[str, BaseException], None]] = None,
        discovery=None,
        msg_log=None,
        on_unreachable: Optional[
            Callable[[str, BaseException], None]
        ] = None,
    ):
        if discovery is None:
            from pydcop_tpu_torch.infrastructure.discovery import Discovery

            discovery = Discovery()
        self.name = name
        self._comm = comm
        self._discovery = discovery
        discovery.register_agent(name)
        self._computations: Dict[str, MessagePassingComputation] = {}
        self.messaging = Messaging(name, msg_log=msg_log)
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._comps_started = threading.Event()
        self._on_error = on_error
        # resilient runtimes (hostnet k_target) set this: a send to a
        # dead/unknown peer is then reported here and DROPPED instead
        # of raising into the posting computation's handler — the
        # distributed best-effort semantics migration needs (the dead
        # peer's computations are being re-deployed elsewhere)
        self._on_unreachable = on_unreachable
        self._busy = False  # a handler is mid-execution
        self.activity_time = 0.0  # seconds spent handling messages
        comm.register(name, self.messaging)

    # -- deployment ----------------------------------------------------

    def deploy_computation(self, comp: MessagePassingComputation) -> None:
        comp.message_sender = self._send
        self._computations[comp.name] = comp
        self._discovery.register_computation(comp.name, self.name)

    @property
    def computations(self) -> Dict[str, MessagePassingComputation]:
        return dict(self._computations)

    def _send(self, src_comp: str, dest_comp: str, msg: Message) -> None:
        dest_agent = self._discovery.computation_agent(dest_comp)
        if self._on_unreachable is not None:
            try:
                if dest_agent is None:
                    raise UnknownComputation(dest_comp)
                self._comm.send_msg(
                    dest_agent, src_comp, dest_comp, msg, MSG_ALGO
                )
            except (UnknownComputation, UnreachableAgent) as e:
                self._on_unreachable(dest_agent or dest_comp, e)
            return
        if dest_agent is None:
            raise UnknownComputation(dest_comp)
        self._comm.send_msg(dest_agent, src_comp, dest_comp, msg, MSG_ALGO)

    # -- lifecycle -----------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, name=f"agent-{self.name}", daemon=True
        )
        self._thread.start()

    def start_computations(self) -> None:
        for comp in self._computations.values():
            comp.start()
        self._comps_started.set()

    def stop(self) -> None:
        """Orderly end-of-run stop.  Does NOT unregister from the
        directory: sibling agent threads may still be draining late
        in-flight messages addressed to this agent's computations —
        removal here would turn those sends into UnknownComputation
        failures during a successful shutdown."""
        self._stop_evt.set()
        for comp in self._computations.values():
            if comp.is_running:
                comp.stop()
        # the message log (when one is attached) is flushed — not
        # closed: other agents may share the file — so the tail is on
        # disk even if the process exits right after stop
        if self.messaging.msg_log is not None:
            self.messaging.msg_log.flush()

    def leave(self) -> None:
        """DEPART the system (the dynamic/resilience event): stop and
        unregister, publishing computation + agent removal events to
        the directory's subscribers."""
        self.stop()
        self._discovery.unregister_agent(self.name)

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    @property
    def is_idle(self) -> bool:
        """No queued AND no in-flight message.  ``Messaging.pending``
        counts a popped message until ``task_done``, with the pop and
        the in-flight mark under one lock — so a handler that is about
        to run (and may post more messages) is never invisible to the
        quiescence monitor."""
        return self.messaging.pending == 0

    # -- message pump --------------------------------------------------

    def _run(self) -> None:
        # gate the pump until this agent's computations have started:
        # a faster peer's opening messages then simply WAIT in the
        # thread-safe Messaging queue instead of being popped into
        # not-yet-running computations (whose pre-start buffers would
        # replay them on the starter's thread — measured pathological
        # under a 100-agent message flood)
        while not self._stop_evt.is_set():
            if self._comps_started.wait(timeout=0.05):
                break
        while not self._stop_evt.is_set():
            item = self.messaging.next_msg(timeout=0.05)
            if item is None:
                continue
            src, dest, msg = item
            comp = self._computations.get(dest)
            if comp is None:
                self.messaging.task_done()
                continue  # computation moved/stopped mid-flight
            t0 = time.perf_counter()
            self._busy = True
            try:
                comp.on_message(src, msg, t0)
            except BaseException as e:  # surface, don't kill the pump
                if self._on_error is not None:
                    self._on_error(dest, e)
                else:
                    raise
            finally:
                self._busy = False
                self.messaging.task_done()
                self.activity_time += time.perf_counter() - t0
