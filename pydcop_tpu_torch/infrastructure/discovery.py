"""Dynamic discovery service (a copy of
``pydcop_tpu/infrastructure/discovery.py``; reference:
``pydcop/infrastructure/discovery.py``).

The reference's Discovery is a directory agents and computations
register with AND subscribe to: registration/removal events propagate
to subscribers and drive the resilience machinery.  Here the directory
is a small thread-safe in-process service:

- the host runtime registers agents/computations as it deploys them;
- each ``hostnet`` agent process keeps one for its computation → agent
  routing; the JAX package's elastic cross-process runtime keeps one on
  its orchestrator (not ported yet: ROADMAP A15b.2).

Events are delivered synchronously on the calling thread (callbacks
must be cheap/non-blocking, like the reference's).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple

AGENT = "agent"
COMPUTATION = "computation"

# event kinds
ADDED = "added"
REMOVED = "removed"

Callback = Callable[[str, str, str, Optional[str]], None]
# signature: (kind, event, name, detail) where kind is AGENT or
# COMPUTATION, event ADDED/REMOVED, detail = hosting agent for
# computations (or None)


class Discovery:
    """Thread-safe directory with add/remove subscriptions."""

    def __init__(self):
        self._lock = threading.RLock()
        self._agents: Dict[str, Dict] = {}
        self._computations: Dict[str, str] = {}  # comp -> agent
        self._subs: List[Tuple[Optional[str], Callback]] = []

    # -- registration ------------------------------------------------

    def register_agent(self, name: str, **info) -> None:
        with self._lock:
            self._agents[name] = dict(info)
            self._emit(AGENT, ADDED, name, None)

    def unregister_agent(self, name: str) -> List[str]:
        """Remove an agent and all its computations; returns the
        orphaned computation names (removal events fire for each)."""
        with self._lock:
            self._agents.pop(name, None)
            orphans = [
                c for c, a in self._computations.items() if a == name
            ]
            for c in orphans:
                del self._computations[c]
                self._emit(COMPUTATION, REMOVED, c, name)
            self._emit(AGENT, REMOVED, name, None)
            return orphans

    def register_computation(self, comp: str, agent: str) -> None:
        with self._lock:
            if agent not in self._agents:
                raise ValueError(
                    f"computation {comp!r} registered on unknown agent "
                    f"{agent!r}"
                )
            self._computations[comp] = agent
            self._emit(COMPUTATION, ADDED, comp, agent)

    def unregister_computation(self, comp: str) -> None:
        with self._lock:
            agent = self._computations.pop(comp, None)
            self._emit(COMPUTATION, REMOVED, comp, agent)

    # -- queries -----------------------------------------------------

    def agents(self) -> List[str]:
        with self._lock:
            return sorted(self._agents)

    def agent_info(self, name: str) -> Optional[Dict]:
        with self._lock:
            info = self._agents.get(name)
            return dict(info) if info is not None else None

    def computations(self, agent: Optional[str] = None) -> List[str]:
        with self._lock:
            return sorted(
                c
                for c, a in self._computations.items()
                if agent is None or a == agent
            )

    def computation_agent(self, comp: str) -> Optional[str]:
        with self._lock:
            return self._computations.get(comp)

    # -- subscriptions -----------------------------------------------

    def subscribe(
        self, callback: Callback, kind: Optional[str] = None
    ) -> Callable[[], None]:
        """Subscribe to add/remove events (optionally of one kind).
        Returns an unsubscribe function."""
        entry = (kind, callback)
        with self._lock:
            self._subs.append(entry)

        def unsubscribe():
            with self._lock:
                if entry in self._subs:
                    self._subs.remove(entry)

        return unsubscribe

    def _emit(
        self, kind: str, event: str, name: str, detail: Optional[str]
    ) -> None:
        for sub_kind, cb in list(self._subs):
            if sub_kind is None or sub_kind == kind:
                cb(kind, event, name, detail)
