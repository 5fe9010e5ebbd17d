"""The self-healing replicated serving fleet (a copy of
``pydcop_tpu/engine/fleet.py``, in front of the port's ``serve``
replicas; the JAX package's ``docs/serving.md`` describes it).

A single :class:`~pydcop_tpu_torch.engine.service.SolverService` process is
a single point of failure.  This module adds the fleet layer on top
of the existing serving stack without changing the wire protocol:

- :class:`HashRing` — a pure consistent-hash placement over replica
  names.  Sessions and stateless requests pin to a replica by hash of
  the session id / dcop text; the STANDBY chain of a replica is its
  successor sequence in deterministic sorted-name order, so the
  replica a failed-over session lands on is exactly the replica its
  deltas were replicated to.  Every placement decision is a pure
  function of (replica set, key, dead set) — no wall clock, no RNG —
  which is what lets a seeded ``replica_kill`` soak replay
  bit-for-bit.
- :class:`FleetRouter` — a thin TCP router speaking the service's
  newline-JSON frames on both sides.  It forwards each frame to its
  ring owner through the :class:`ServiceClient` retry machinery,
  PRESERVING the client's idempotency key and trace context
  (:meth:`ServiceClient.forward`), so a failover retry is answered
  from a reply cache — the router's own, or the standby's replicated
  one — instead of being re-solved (exactly-once).  Dead replicas are
  detected twice over: a forward transport failure marks the owner
  dead immediately (and re-forwards the SAME frame to the standby),
  and a ``/healthz`` watcher marks replicas dead/alive in the
  background (a ``draining`` replica counts as dead — planned
  rebalance is just drain + resume).
- :func:`standby_map` — the fleet controller's replication wiring:
  each replica streams its bounded session delta log to its ring
  successors (``k`` of them for k-resilience) via the ``standby`` /
  ``replicate`` wire ops (``engine/service.py``), so a SIGKILL'd
  replica's sessions resume on the standby through the existing
  :class:`~pydcop_tpu_torch.engine.incremental.IncrementalCompiler` replay
  path — ``compile.incremental``-only after segment 1, bit-identical
  to an undisturbed service.

Session stickiness: once a session is served by a replica it stays
there while that replica is alive (a revived replica gets NEW ring
arcs back, never a session that moved — the moved session's state
lives on its current owner, which keeps replicating it down ITS
standby chain).  On the owner's death the session moves to the next
ALIVE successor — the first replica in its replication chain.
"""

from __future__ import annotations

import bisect
import hashlib
import json
import socket
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import (
    Any,
    Dict,
    FrozenSet,
    Iterable,
    List,
    Mapping,
    Optional,
    Sequence,
    Tuple,
    Union,
)

from pydcop_tpu_torch.engine.service import (
    ServiceClient,
    ServiceError,
    ServiceTransportError,
    _read_frame,
)
from pydcop_tpu_torch.telemetry import get_metrics, get_tracer


class FleetError(ServiceError):
    """A fleet-level routing failure (typically: no live replica left
    to own the request's ring arc)."""


@dataclass(frozen=True)
class Replica:
    """One fleet member: its wire address and (optionally) the
    ``serve --metrics_port`` exporter address the health watcher
    polls and ``pydcop_tpu_torch top`` aggregates."""

    name: str
    addr: str
    metrics: Optional[str] = None


#: virtual nodes per replica on the hash ring — enough that arcs stay
#: reasonably balanced for single-digit fleets without making lookup
#: tables large
_RING_VNODES = 64


def _ring_u(token: str) -> int:
    """Ring position from a keyed hash — the placement determinism
    core: the value depends on nothing but the token."""
    h = hashlib.blake2b(token.encode("utf-8"), digest_size=8).digest()
    return int.from_bytes(h, "big")


def ring_key(msg: Mapping[str, Any]) -> Tuple[str, Optional[str]]:
    """The routing key of one wire frame: ``(hash key, session)``.
    Session frames key on the session NAME (every segment of a
    session must land on the same replica); stateless frames key on
    the dcop payload text, so resubmissions of the same problem share
    a replica's warm compiled-problem cache.  Pure."""
    session = msg.get("session")
    if session:
        return f"s:{session}", str(session)
    dcop = msg.get("dcop")
    digest = hashlib.sha256(
        str(dcop).encode("utf-8", "replace")
    ).hexdigest()
    return f"d:{digest}", None


class HashRing:
    """Consistent-hash placement over a FIXED replica-name set.

    ``lookup`` walks the vnode ring; ``successors`` / ``next_alive``
    walk the deterministic sorted-name cycle — the standby chain.
    Both are pure functions of their arguments, so two routers (or
    two seeded runs) with the same replica set make identical
    placement and failover decisions."""

    def __init__(
        self, names: Iterable[str], vnodes: int = _RING_VNODES
    ) -> None:
        self.names: Tuple[str, ...] = tuple(sorted(set(names)))
        if not self.names:
            raise ValueError("HashRing needs at least one replica")
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        points: List[Tuple[int, str]] = []
        for name in self.names:
            for v in range(vnodes):
                points.append((_ring_u(f"{name}#{v}"), name))
        points.sort()
        self._points = points
        self._hashes = [p[0] for p in points]

    def lookup(self, key: str) -> str:
        """The ring owner of ``key``: the first vnode at or after the
        key's hash position, wrapping."""
        i = bisect.bisect_left(self._hashes, _ring_u(key))
        if i == len(self._points):
            i = 0
        return self._points[i][1]

    def successor(self, name: str) -> str:
        """The next DISTINCT replica after ``name`` in sorted cyclic
        order — its first standby, and the replica its sessions fail
        over to."""
        if name not in self.names:
            raise ValueError(f"unknown replica {name!r}")
        i = self.names.index(name)
        return self.names[(i + 1) % len(self.names)]

    def successors(self, name: str, k: int = 1) -> List[str]:
        """The first ``k`` distinct successors of ``name`` (its
        standby chain, nearest first).  Capped at the other replicas
        that exist."""
        out: List[str] = []
        cur = name
        for _ in range(min(k, len(self.names) - 1)):
            cur = self.successor(cur)
            out.append(cur)
        return out

    def next_alive(
        self, name: str, dead: FrozenSet[str]
    ) -> str:
        """``name`` itself if alive, else the first alive replica in
        its successor chain — the failover rule that keeps routing
        aligned with the replication chain."""
        cur = name
        for _ in range(len(self.names)):
            if cur not in dead:
                return cur
            cur = self.successor(cur)
        raise FleetError(
            "fleet: no live replica left "
            f"({len(self.names)} registered, all marked dead)"
        )


def standby_map(
    names: Iterable[str], k: int = 1
) -> Dict[str, List[str]]:
    """Replica name → its ``k`` standby names (ring successor chain,
    nearest first) — what the fleet controller turns into per-replica
    ``standby`` wire ops.  Pure."""
    ring = HashRing(names)
    return {name: ring.successors(name, k) for name in ring.names}


def _as_replicas(
    replicas: Union[
        Mapping[str, str], Sequence[Replica], Sequence[Tuple]
    ]
) -> "OrderedDict[str, Replica]":
    out: "OrderedDict[str, Replica]" = OrderedDict()
    if isinstance(replicas, Mapping):
        for name in sorted(replicas):
            out[str(name)] = Replica(str(name), str(replicas[name]))
        return out
    reps = []
    for r in replicas:
        if isinstance(r, Replica):
            reps.append(r)
        else:
            name, addr = r[0], r[1]
            metrics = r[2] if len(r) > 2 else None
            reps.append(Replica(str(name), str(addr), metrics))
    for r in sorted(reps, key=lambda r: r.name):
        out[r.name] = r
    return out


#: ops the router ROUTES to a single ring owner (everything session-
#: or problem-addressed); the rest are fleet-local or broadcast
_ROUTED_OPS = ("solve", "infer", "close_session")

#: how long one downstream forward may retry before the router
#: declares the owner dead and fails the frame over to its standby —
#: the knob that bounds takeover latency to roughly one tick budget
#: plus this window
_FORWARD_RETRY_WINDOW_S = 0.75

#: downstream client socket timeout — bounds both the connect to a
#: replica and the wait for one reply.  Generous on purpose: a slow
#: first-compile solve must not read as a dead replica (a SIGKILL'd
#: process fails the socket immediately regardless, so takeover
#: latency does not ride on this); a genuinely hung replica is the
#: ``/healthz`` watcher's job
_DOWNSTREAM_TIMEOUT_S = 60.0


class FleetRouter:
    """Consistent-hash front for N :class:`ServiceServer` replicas.

    Speaks the service's newline-JSON wire protocol upstream (so
    :class:`ServiceClient` works against it unchanged) and forwards
    frames downstream through :meth:`ServiceClient.forward`, which
    preserves the client's idempotency key and trace context.  One
    handler thread per upstream connection; each handler keeps its
    own downstream clients, so one slow client never blocks another.

    Exactly-once across failover: the router caches ok solve replies
    in a bounded LRU by the CLIENT's ikey (a retry of an
    already-answered request replays here without touching a
    replica); a retry racing an in-flight solve attaches at the
    owning replica's in-flight table; and a failover re-forward of
    the SAME frame to the standby is answered from the standby's
    replicated reply cache when the original reply was computed, or
    legitimately solved exactly once when it never was.
    """

    def __init__(
        self,
        replicas: Union[
            Mapping[str, str], Sequence[Replica], Sequence[Tuple]
        ],
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        health_interval: float = 0.25,
        retry_window: float = _FORWARD_RETRY_WINDOW_S,
        connect_timeout: float = _DOWNSTREAM_TIMEOUT_S,
        reply_cache: int = 1024,
        backoff_seed: int = 0,
        autostart: bool = True,
    ) -> None:
        self.replicas = _as_replicas(replicas)
        if not self.replicas:
            raise ValueError("FleetRouter needs at least one replica")
        self.ring = HashRing(self.replicas)
        self.health_interval = health_interval
        self.retry_window = retry_window
        self.connect_timeout = connect_timeout
        self._backoff_seed = backoff_seed

        self._lock = threading.Lock()
        self._dead: set = set()
        self._owner: Dict[str, str] = {}  # session -> replica name
        self._replies: "OrderedDict[str, Dict[str, Any]]" = (
            OrderedDict()
        )
        self._reply_cache_max = reply_cache

        self._stats_lock = threading.Lock()
        self._n_requests = 0
        self._n_forwards = 0
        self._n_failovers = 0
        self._n_replayed = 0
        self._n_marked_dead = 0
        self._n_revived = 0

        self._shutdown = threading.Event()
        self._threads: List[threading.Thread] = []
        self._conns: List[socket.socket] = []
        self._server = socket.create_server((host, port))
        self.address: Tuple[str, int] = (
            host, self._server.getsockname()[1]
        )
        self._accept: Optional[threading.Thread] = None
        self._health_thread: Optional[threading.Thread] = None
        if autostart:
            self.start()

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        if self._accept is not None:
            return
        self._accept = threading.Thread(
            target=self._accept_loop, name="fleet-router-accept",
            daemon=True,
        )
        self._accept.start()
        if any(r.metrics for r in self.replicas.values()):
            self._health_thread = threading.Thread(
                target=self._health_loop, name="fleet-router-health",
                daemon=True,
            )
            self._health_thread.start()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._shutdown.wait(timeout)

    def request_shutdown(self) -> None:
        self._shutdown.set()

    def close(self) -> None:
        self._shutdown.set()
        try:
            self._server.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        for t in list(self._threads):
            t.join(timeout=5)
        if self._health_thread is not None:
            self._health_thread.join(timeout=5)

    def __enter__(self) -> "FleetRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- liveness --------------------------------------------------------

    def mark_dead(self, name: str) -> None:
        """Mark a replica dead: its ring arcs and sticky sessions
        re-pin to the next alive successor on the very next frame."""
        with self._lock:
            if name in self._dead or name not in self.replicas:
                return
            self._dead.add(name)
        with self._stats_lock:
            self._n_marked_dead += 1
        met = get_metrics()
        if met.enabled:
            met.inc("fleet.marked_dead")
        tr = get_tracer()
        if tr.enabled:
            tr.event("fleet-dead", cat="fleet", replica=name)

    def mark_alive(self, name: str) -> None:
        """Mark a replica alive again (a resumed drain, a restarted
        process): it gets NEW placements back; sessions that moved
        stay with their current owner."""
        with self._lock:
            if name not in self._dead:
                return
            self._dead.discard(name)
        with self._stats_lock:
            self._n_revived += 1
        met = get_metrics()
        if met.enabled:
            met.inc("fleet.revived")
        tr = get_tracer()
        if tr.enabled:
            tr.event("fleet-revived", cat="fleet", replica=name)

    def dead(self) -> List[str]:
        with self._lock:
            return sorted(self._dead)

    def _health_loop(self) -> None:
        from pydcop_tpu_torch.telemetry.export import http_get

        while not self._shutdown.wait(self.health_interval):
            for name in self.ring.names:
                rep = self.replicas[name]
                if not rep.metrics:
                    continue
                try:
                    doc = json.loads(
                        http_get(
                            f"http://{rep.metrics}/healthz",
                            timeout=max(self.health_interval, 1.0),
                        )
                    )
                    ok = doc.get("status") == "ok"
                except (OSError, ValueError):
                    ok = False
                if ok:
                    self.mark_alive(name)
                else:
                    self.mark_dead(name)

    # -- placement (pure decisions) --------------------------------------

    def _pick_owner(
        self,
        key: str,
        prev: Optional[str],
        dead: FrozenSet[str],
    ) -> str:
        """The replica that owns this frame: the session's current
        owner while it lives, else the ring owner — in both cases
        walked down the successor chain past dead replicas, which is
        exactly the replication chain.  Pure in its arguments."""
        start = prev if prev is not None else self.ring.lookup(key)
        return self.ring.next_alive(start, dead)

    # -- health / stats --------------------------------------------------

    def health(self) -> Dict[str, Any]:
        """The router's aggregate ``/healthz`` document: fleet status
        plus a per-replica roster (``pydcop_tpu_torch top`` expands the
        roster's ``metrics`` addresses into per-replica rows)."""
        with self._lock:
            dead = set(self._dead)
            sessions = len(self._owner)
        roster = {
            name: {
                "addr": rep.addr,
                "metrics": rep.metrics,
                "alive": name not in dead,
            }
            for name, rep in self.replicas.items()
        }
        status = (
            "down"
            if len(dead) == len(self.replicas)
            else "degraded" if dead else "ok"
        )
        with self._stats_lock:
            return {
                "status": status,
                "fleet": True,
                "replicas": roster,
                "sessions": sessions,
                "requests": self._n_requests,
                "failovers": self._n_failovers,
            }

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            dead = sorted(self._dead)
            sessions = len(self._owner)
        with self._stats_lock:
            return {
                "replicas": len(self.replicas),
                "dead": dead,
                "sessions": sessions,
                "requests": self._n_requests,
                "forwards": self._n_forwards,
                "failovers": self._n_failovers,
                "replayed_replies": self._n_replayed,
                "marked_dead": self._n_marked_dead,
                "revived": self._n_revived,
            }

    # -- the frame loop --------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._shutdown.is_set():
            try:
                conn, _addr = self._server.accept()
            except OSError:
                return  # closed
            with self._lock:
                self._conns.append(conn)
            t = threading.Thread(
                target=self._handle, args=(conn,),
                name="fleet-router-conn", daemon=True,
            )
            self._threads.append(t)
            t.start()

    @staticmethod
    def _send(conn: socket.socket, obj: Dict[str, Any]) -> bool:
        try:
            conn.sendall((json.dumps(obj) + "\n").encode("utf-8"))
            return True
        except (OSError, ValueError):
            return False

    def _handle(self, conn: socket.socket) -> None:
        reader = conn.makefile("rb")
        clients: Dict[str, ServiceClient] = {}
        try:
            while not self._shutdown.is_set():
                msg, err = _read_frame(reader)
                if msg is None and err is None:
                    return  # peer closed
                if err is not None:
                    if not self._send(
                        conn,
                        {
                            "id": None,
                            "ok": False,
                            "error": err,
                            "frame_rejected": True,
                        },
                    ):
                        return
                    continue
                try:
                    reply = self._serve(msg, clients)
                except Exception as e:  # noqa: BLE001 — the error
                    # IS the reply; one bad frame must not drop the
                    # connection and every request behind it
                    reply = {
                        "ok": False,
                        "error": f"{type(e).__name__}: {e}",
                    }
                reply["id"] = msg.get("id")
                if not self._send(conn, reply):
                    return
                if msg.get("op") == "shutdown":
                    self._shutdown.set()
                    return
        finally:
            for cli in clients.values():
                cli.close()
            try:
                reader.close()
                conn.close()
            except OSError:
                pass
            with self._lock:
                try:
                    self._conns.remove(conn)
                except ValueError:
                    pass
            try:
                self._threads.remove(threading.current_thread())
            except ValueError:
                pass

    def _client(
        self, clients: Dict[str, ServiceClient], name: str
    ) -> ServiceClient:
        cli = clients.get(name)
        if cli is None:
            cli = ServiceClient(
                self.replicas[name].addr,
                timeout=self.connect_timeout,
                retry_window=self.retry_window,
                backoff_seed=self._backoff_seed,
            )
            clients[name] = cli
        return cli

    def _drop_client(
        self, clients: Dict[str, ServiceClient], name: str
    ) -> None:
        cli = clients.pop(name, None)
        if cli is not None:
            cli.close()

    def _cache_reply(
        self, ikey: str, reply: Dict[str, Any]
    ) -> None:
        with self._lock:
            self._replies[ikey] = dict(reply)
            self._replies.move_to_end(ikey)
            while len(self._replies) > self._reply_cache_max:
                self._replies.popitem(last=False)

    def _note_replay(self) -> None:
        with self._stats_lock:
            self._n_replayed += 1
        met = get_metrics()
        if met.enabled:
            met.inc("fleet.replayed_replies")

    def _serve(
        self, msg: Dict[str, Any], clients: Dict[str, ServiceClient]
    ) -> Dict[str, Any]:
        op = msg.get("op")
        if op == "ping":
            return {"ok": True, "pong": True, "fleet": True}
        if op == "stats":
            return {"ok": True, "stats": self._fleet_stats(clients)}
        if op == "shutdown":
            self._broadcast_shutdown(clients)
            return {"ok": True, "stopping": True}
        if op in _ROUTED_OPS:
            return self._forward_routed(msg, clients)
        raise ServiceError(f"unknown op {op!r}")

    def _fleet_stats(
        self, clients: Dict[str, ServiceClient]
    ) -> Dict[str, Any]:
        per: Dict[str, Any] = {}
        with self._lock:
            dead = set(self._dead)
        for name in self.ring.names:
            if name in dead:
                per[name] = {"error": "dead"}
                continue
            try:
                per[name] = self._client(clients, name).stats()
            except (ServiceError, OSError) as e:
                per[name] = {
                    "error": f"{type(e).__name__}: {e}"[:200]
                }
        return {"fleet": self.stats(), "replicas": per}

    def _broadcast_shutdown(
        self, clients: Dict[str, ServiceClient]
    ) -> None:
        with self._lock:
            dead = set(self._dead)
        for name in self.ring.names:
            if name in dead:
                continue
            try:
                self._client(clients, name).shutdown()
            except (ServiceError, OSError):
                pass

    def _forward_routed(
        self, msg: Dict[str, Any], clients: Dict[str, ServiceClient]
    ) -> Dict[str, Any]:
        met = get_metrics()
        with self._stats_lock:
            self._n_requests += 1
        if met.enabled:
            met.inc("fleet.requests")
        ikey = msg.get("ikey")
        if ikey is not None:
            with self._lock:
                cached = self._replies.get(ikey)
                if cached is not None:
                    self._replies.move_to_end(ikey)
            if cached is not None:
                # a retry of an already-answered request: replay at
                # the router, never touch a replica
                self._note_replay()
                return dict(cached)
        key, session = ring_key(msg)
        for _ in range(len(self.replicas) + 1):
            with self._lock:
                dead = frozenset(self._dead)
                prev = (
                    self._owner.get(session) if session else None
                )
            owner = self._pick_owner(key, prev, dead)
            if session:
                with self._lock:
                    self._owner[session] = owner
            try:
                cli = self._client(clients, owner)
                with self._stats_lock:
                    self._n_forwards += 1
                reply = cli.forward(msg)
            except (ServiceTransportError, OSError) as e:
                # the owner is gone: mark it dead and re-forward the
                # SAME frame (same ikey, same trace) to its standby —
                # the replicated reply cache replays a computed
                # answer; an uncomputed one is solved exactly once
                self.mark_dead(owner)
                self._drop_client(clients, owner)
                with self._stats_lock:
                    self._n_failovers += 1
                if met.enabled:
                    met.inc("fleet.failovers")
                tr = get_tracer()
                if tr.enabled:
                    tr.event(
                        "fleet-failover", cat="fleet",
                        replica=owner, session=session,
                        error=f"{type(e).__name__}"[:80],
                    )
                continue
            if (
                session
                and msg.get("op") == "close_session"
                and reply.get("ok")
            ):
                with self._lock:
                    self._owner.pop(session, None)
            if ikey is not None and reply.get("ok"):
                self._cache_reply(ikey, reply)
            return reply
        raise FleetError(
            "fleet: no live replica answered the request "
            f"(replicas={len(self.replicas)}, dead={self.dead()})"
        )
