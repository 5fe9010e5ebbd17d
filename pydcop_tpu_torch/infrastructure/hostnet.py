"""Cross-process host runtime: message-driven agents over TCP (a port of
``pydcop_tpu/infrastructure/hostnet.py``).

This is the package's equivalent of the reference's HTTP agent
deployment (``pydcop/infrastructure/communication.py``
``HttpCommunicationLayer`` + ``commands/agent.py``): real
``MessagePassingComputation`` agents spread over OS processes (or
hosts), exchanging algorithm messages as ``simple_repr`` JSON frames —
the reference's wire format — over persistent TCP connections instead
of per-message HTTP POSTs.

It runs the *host* message-driven engine with arbitrary per-agent
placement — the heterogeneous-agent deployment mode, where machines need
nothing but Python + this package, and an accel agent hosts its placed
subgraph as one compiled island on its own device (``run_host_agent``'s
``device``: the CUDA device unless the agent process asks for the CPU).
The JAX package's other cross-process path, the SPMD runtime over a
device mesh, is not ported (ROADMAP A15b.2).

Deployment protocol (control plane, newline-JSON over the agent's
orchestrator connection):

1. agents connect and ``register`` with their name + message-plane
   address (their ``TcpCommunicationLayer`` listener),
2. the orchestrator ships each agent ``deploy``: the DCOP yaml, algo
   + params, its computation placement, the full agent directory, and
   the seed — each agent rebuilds the problem locally and instantiates
   ONLY its computations through the algorithm registry
   (``build_computation``), the reference's deployment seam,
3. ``start`` begins message passing; the orchestrator polls ``status``
   (pending messages + delivered count per agent) and declares
   quiescence when every agent is idle and the global delivered count
   is stable across 3 consecutive polls (the distributed analogue of
   the in-process quiescence rule),
4. ``collect`` gathers each agent's variable values; the orchestrator
   assembles the assignment, evaluates the cost, and broadcasts
   ``stop``.

Failure handling: a dead agent connection aborts the run with a clean
``AgentFailureError`` (control connections double as liveness
monitors); surviving agents receive ``stop`` on the way out.
"""

from __future__ import annotations

import json
import socket
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from pydcop_tpu_torch.infrastructure.communication import (
    MSG_ALGO,
    CommunicationLayer,
    Messaging,
    UnreachableAgent,
)
from pydcop_tpu_torch.infrastructure.computations import Message
from pydcop_tpu_torch.telemetry import get_metrics, get_tracer

_ENC = "utf-8"

# per-destination outbound queue bound (frames): the backpressure
# high-water mark that keeps a slow-but-alive peer from growing a
# sender's memory without limit
MAX_QUEUED_FRAMES = 10_000


class _DestChannel:
    """One destination's outbound state: pending frames, a condition
    sharing the layer lock (so only this destination's writer and
    backpressured senders are woken), the dead-link marker, and the
    frame sequence counter (the receiver's dedupe key across
    reconnect-resends)."""

    __slots__ = ("frames", "cond", "dead", "seq")

    def __init__(self, lock: threading.Lock):
        self.frames: List[bytes] = []
        self.cond = threading.Condition(lock)
        self.dead: Optional[str] = None
        self.seq = 0


class TcpCommunicationLayer(CommunicationLayer):
    """Message-plane transport: one listener per process, pooled
    outbound connections, ``simple_repr`` JSON frames.

    Frame format (one JSON object per line)::

        {"da": dest_agent, "sc": src_comp, "dc": dest_comp,
         "p": priority, "m": simple_repr(message)}
    """

    def __init__(
        self,
        bind_host: str = "127.0.0.1",
        port: int = 0,
        on_send_error=None,
        retry_window: float = 5.0,
    ):
        super().__init__()
        self.addresses: Dict[str, Tuple[str, int]] = {}
        # transient-fault tolerance: a failed connect/send is retried
        # with exponential backoff + jitter for this many seconds (the
        # grace window) before the link is declared dead — a short
        # partition or peer restart is then a blip, not a run failure
        self.retry_window = retry_window
        # retry-timing determinism: writer-loop backoff jitter is the
        # keyed-hash variant (utils/backoff.py) — pure in (seed, dest,
        # attempt) — so a chaos replay reproduces every link's retry
        # schedule bit-for-bit regardless of thread interleaving.
        # run_agent points this at the fault plan's seed; distinct
        # destination keys keep links decorrelated from each other.
        self.backoff_seed = 0
        # resend dedupe: highest frame seq delivered per sender id —
        # a reconnect resends its whole batch, and replaying a frame
        # into Messaging would double-count `delivered` and re-trigger
        # handlers (guarded by _lock)
        self._last_seq: Dict[str, int] = {}
        # outbound: one bounded FIFO queue + writer thread per
        # destination, so a slow or unresponsive peer (blocking
        # connect/sendall, up to 10s) only stalls ITS queue — the
        # sending (pump) thread never blocks on the network for other
        # destinations.  The bound restores the old blocking-send
        # backpressure per destination: a slow-but-alive peer blocks
        # senders to IT at MAX_QUEUED frames instead of growing the
        # queue without limit.
        self._channels: Dict[Tuple[str, int], "_DestChannel"] = {}
        self._lock = threading.Lock()
        # send failures are asynchronous now: surfaced through this
        # callback (agent → errors list → status reply → orchestrator
        # fails the run), preserving the old fail-fast behavior; with
        # no callback the failure is logged (never silent)
        self.on_send_error = on_send_error
        # messages handed to the transport (local + remote): one half
        # of the two-counter quiescence rule — the orchestrator may
        # declare quiescence only when global sent == global delivered,
        # otherwise a frame queued here or in flight on a slow TCP
        # link is invisible and the run can end mid-propagation.
        # Guarded by _lock: a lost increment would leave sent <
        # delivered forever and break quiescence.
        self.count_sent = 0
        self._server = socket.create_server(
            (bind_host, port), reuse_port=False
        )
        self.address: Tuple[str, int] = (
            bind_host, self._server.getsockname()[1]
        )
        # the id stamped on outbound frames ("sa"): unique per layer
        # within a run — the receiver's dedupe namespace
        self._sender_id = f"{self.address[0]}:{self.address[1]}"
        self._closing = False
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="hostnet-accept", daemon=True
        )
        self._accept_thread.start()

    # -- directory ------------------------------------------------------

    def set_addresses(self, directory: Dict[str, Any]) -> None:
        """Install the agent → (host, port) message-plane directory."""
        self.addresses.update(
            {a: (h, int(p)) for a, (h, p) in directory.items()}
        )

    def forget_agent(self, name: str) -> None:
        """Drop a dead agent: its address, and its outbound channel
        (queued frames are discarded and backpressured senders are
        released — they see ``UnreachableAgent``, which the resilient
        agent loop tolerates as a send error, not a computation
        error)."""
        addr = self.addresses.pop(name, None)
        if addr is None:
            return
        with self._lock:
            ch = self._channels.get(addr)
            if ch is not None:
                ch.dead = ch.dead or "agent removed (migration)"
                ch.frames = []
                ch.cond.notify_all()

    # -- inbound --------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                conn, _ = self._server.accept()
            except OSError:
                return
            threading.Thread(
                target=self._recv_loop, args=(conn,),
                name="hostnet-recv", daemon=True,
            ).start()

    def _recv_loop(self, conn: socket.socket) -> None:
        from pydcop_tpu_torch.utils.simple_repr import from_repr

        reader = conn.makefile("rb")
        try:
            while True:
                line = reader.readline()
                if not line:
                    return
                frame = json.loads(line.decode(_ENC))
                met = get_metrics()
                if met.enabled:
                    met.inc("hostnet.recv_frames")
                sender = frame.get("sa")
                if sender is not None:
                    # reconnect-resend dedupe: a writer that lost its
                    # connection mid-batch resends the WHOLE batch;
                    # frames from one sender arrive in seq order (one
                    # writer thread, ordered TCP), so anything at or
                    # below the high-water mark was already delivered
                    sq = int(frame.get("sq", 0))
                    with self._lock:
                        duplicate = sq <= self._last_seq.get(sender, 0)
                        if not duplicate:
                            self._last_seq[sender] = sq
                    if duplicate:
                        if met.enabled:
                            met.inc("hostnet.dedupe_dropped")
                        tr = get_tracer()
                        if tr.enabled:
                            tr.event(
                                "dedupe-drop", cat="message",
                                sender=sender, seq=sq,
                            )
                        continue
                messaging = self.discovery.get(frame["da"])
                if messaging is None:
                    continue  # late frame for a stopped agent
                messaging.deliver(
                    frame["sc"], frame["dc"], from_repr(frame["m"]),
                    frame.get("p", MSG_ALGO),
                )
        except (OSError, ValueError):
            return
        finally:
            try:
                conn.close()
            except OSError:
                pass

    # -- outbound -------------------------------------------------------

    def send_msg(
        self,
        dest_agent: str,
        src_comp: str,
        dest_comp: str,
        msg: Message,
        priority: int = MSG_ALGO,
    ) -> None:
        met = get_metrics()
        if met.enabled:
            met.inc("hostnet.sent")
        local = self.discovery.get(dest_agent)
        if local is not None:  # same process: no serialization
            local.deliver(src_comp, dest_comp, msg, priority)
            with self._lock:
                self.count_sent += 1
            return
        addr = self.addresses.get(dest_agent)
        if addr is None:
            raise UnreachableAgent(dest_agent)
        from pydcop_tpu_torch.utils.simple_repr import simple_repr

        # serialized OUTSIDE the lock (the payload can be arbitrarily
        # large and every destination shares this lock); only the
        # per-channel seq is spliced in under the lock, where it is
        # assigned — frames must enter the channel in seq order
        prefix = json.dumps(
            {
                "da": dest_agent,
                "sc": src_comp,
                "dc": dest_comp,
                "p": priority,
                "m": simple_repr(msg),
                "sa": self._sender_id,
            }
        )[:-1]  # strip the closing brace, "sq" is appended below
        with self._lock:
            ch = self._channels.get(addr)
            if ch is None:
                ch = self._channels[addr] = _DestChannel(self._lock)
                threading.Thread(
                    target=self._writer_loop,
                    args=(addr, ch, dest_agent),
                    name=f"hostnet-send-{addr[0]}:{addr[1]}",
                    daemon=True,
                ).start()
            # bounded queue = per-destination backpressure; only
            # senders to THIS peer ever block here
            while (
                len(ch.frames) >= MAX_QUEUED_FRAMES
                and ch.dead is None
                and not self._closing
            ):
                ch.cond.wait()
            if ch.dead is not None:
                raise UnreachableAgent(f"{dest_agent}: {ch.dead}")
            # counted at ENQUEUE: a queued-but-unsent frame must keep
            # sent > delivered so quiescence cannot fire mid-flight.
            # The seq is assigned under the same lock that appends, so
            # frames enter the channel in seq order — the property the
            # receiver's resend dedupe relies on.
            self.count_sent += 1
            ch.seq += 1
            ch.frames.append(
                f'{prefix},"sq":{ch.seq}}}\n'.encode(_ENC)
            )
            ch.cond.notify_all()

    def _writer_loop(
        self, addr: Tuple[str, int], ch: "_DestChannel", dest_agent: str
    ) -> None:
        """Drain one destination's queue over a persistent connection.

        Transient failures (connection refused/reset, short partitions)
        are retried — reconnect + resend with exponential backoff and
        jitter, bounded by :attr:`retry_window` — through the shared
        backoff helper.  A resend may replay frames the peer already
        received before the connection died; the receiver drops those
        by (sender id, frame seq), so retries are exactly-once at the
        Messaging layer.  Only a retried-out failure (the permanent
        case) marks the destination dead and reports it through
        ``on_send_error`` — the run is then failed, repaired, or
        degraded by the control plane."""
        from pydcop_tpu_torch.utils.backoff import call_with_backoff

        conn_box: List[Optional[socket.socket]] = [None]

        def _attempt(payload: bytes) -> None:
            try:
                if conn_box[0] is None:
                    conn_box[0] = socket.create_connection(
                        addr, timeout=10
                    )
                conn_box[0].sendall(payload)
            except OSError:
                met = get_metrics()
                if met.enabled:
                    # every failed attempt becomes a backoff retry
                    # (unless the window is spent — the dead-link
                    # counter below records that outcome)
                    met.inc("hostnet.retries")
                c, conn_box[0] = conn_box[0], None
                if c is not None:
                    try:
                        c.close()
                    except OSError:
                        pass
                raise

        try:
            while True:
                with self._lock:
                    while not ch.frames and not self._closing:
                        ch.cond.wait()
                    if self._closing and not ch.frames:
                        return
                    if ch.dead is not None:
                        return  # peer forgotten (migration): stop
                    batch = ch.frames
                    ch.frames = []
                    ch.cond.notify_all()  # wake backpressured senders
                call_with_backoff(
                    lambda payload=b"".join(batch): _attempt(payload),
                    self.retry_window,
                    base=0.05,
                    max_delay=1.0,
                    seed=self.backoff_seed,
                    key=f"hostnet:{dest_agent}",
                    giving_up=lambda: self._closing
                    or ch.dead is not None,
                )
        except OSError as e:
            with self._lock:
                ch.dead = ch.dead or str(e)
                ch.frames = []
                ch.cond.notify_all()
            met = get_metrics()
            if met.enabled:
                met.inc("hostnet.dead_links")
            tr = get_tracer()
            if tr.enabled:
                tr.event(
                    "link-dead", cat="message", peer=dest_agent,
                    error=str(e),
                )
            cb = self.on_send_error
            if cb is not None:
                cb(dest_agent, e)
            else:
                import logging

                logging.getLogger(__name__).warning(
                    "hostnet: dropping messages to %s (%s): %s",
                    dest_agent, addr, e,
                )
        finally:
            if conn_box[0] is not None:
                try:
                    conn_box[0].close()
                except OSError:
                    pass

    def close(self) -> None:
        with self._lock:
            self._closing = True
            for ch in self._channels.values():
                ch.cond.notify_all()
        try:
            self._server.close()
        except OSError:
            pass


# -- control-plane helpers (same framing as the SPMD orchestrator) ------


def _send(conn: socket.socket, obj: Dict[str, Any]) -> None:
    conn.sendall((json.dumps(obj) + "\n").encode(_ENC))


def _recv(reader) -> Optional[Dict[str, Any]]:
    line = reader.readline()
    if not line:
        return None
    return json.loads(line.decode(_ENC))


class AgentFailureError(RuntimeError):
    pass


class PlacementError(ValueError):
    """Invalid placement/distribution input (a usage error, not an
    internal failure — the CLI converts it to a clean exit)."""


def run_host_orchestrator(
    dcop,
    algo: str,
    params: Dict[str, Any],
    nb_agents: int,
    port: int,
    rounds: int = 200,
    timeout: Optional[float] = None,
    seed: int = 0,
    distribution: Optional[str] = None,
    placement: Optional[Dict[str, List[str]]] = None,
    register_timeout: float = 120.0,
    poll_timeout: float = 30.0,
    best_sample_period: float = 0.5,
    ui_port: Optional[int] = None,
    server: Optional[socket.socket] = None,
    accel_agents: Optional[List[str]] = None,
    k_target: int = 0,
    chaos: Optional[str] = None,
    chaos_seed: int = 0,
    grace_period: float = 5.0,
    degraded_ok: bool = True,
    device=None,
) -> Dict[str, Any]:
    """Wait for ``nb_agents`` host agents, deploy, run to quiescence /
    budget / timeout, and return the assembled result dict.

    ``k_target > 0`` enables k-resilience (the reference's
    ``ResilientAgent`` + replication machinery, SURVEY §2.6): after
    placement, ``replication.ucs_hostingcosts.replica_distribution``
    picks ``k_target`` replica-holder agents per computation; when an
    agent dies mid-run the orchestrator solves the reparation DCOP
    (``replication.repair``) over the LIVE replica holders, ships the
    orphaned computations to the chosen agents (with the variables'
    last sampled values as restart state), updates every agent's
    directory, and the run continues to quiescence.  A computation
    whose replica holders are all dead is lost and fails the run.
    After any migration the two-counter quiescence ledger is void
    (frames sent to the dead agent can never be reconciled), so the
    orchestrator falls back to idle + delivered-stability over a
    doubled window — the reference has no global ledger at all.
    An island (accel) agent's computations are re-deployed as PLAIN
    host computations on the replica holders: the compiled pytree
    state dies with its process, but the value restart carries the
    assignment, which is the state that matters to the run.

    Placement: an explicit ``placement`` (agent → computation names,
    the ``distribute --output`` yaml's ``distribution:`` mapping), or
    a ``distribution`` strategy name (computed over the REGISTERED
    agents through the distribution layer, using the dcop's AgentDef
    capacity/hosting data when the registered names match), else
    round-robin.

    ``poll_timeout`` bounds every control-plane read after
    registration: a wedged or partitioned agent (no RST, nothing to
    read) fails the run with :class:`AgentFailureError` instead of
    hanging it.  Anytime-best tracking: agent values are sampled every
    ``best_sample_period`` seconds and the best-cost sample is what
    ``cost``/``assignment`` report (``final_*`` is the last state) —
    the same semantics as the other engines.

    Transient-fault tolerance: ``grace_period`` is the window that
    separates blips from permanent death.  It is shipped to every
    agent as the message plane's retry window (failed sends are
    retried with backoff for that long before the link is declared
    dead), and bounds how long the orchestrator tolerates a sticky
    send failure before treating it as permanent.  A permanent
    message-plane failure with no repair path then *degrades* the run
    (``degraded_ok``, default on): the anytime-best assignment is
    returned with ``status="degraded"`` and a ``degraded`` record,
    instead of raising — control-plane agent death keeps its existing
    fail/repair semantics.

    Fault injection: ``chaos`` is a :class:`~pydcop_tpu_torch.faults.FaultPlan`
    spec applied by every agent to its outbound message plane with the
    deterministic seed ``chaos_seed``; the plan
    and the per-kind injected-event counts are recorded in the result
    under ``"chaos"`` for replay.

    ``device`` is where a ``k_target`` migration solves its reparation
    DCOP (``replication.repair``; default: the CUDA device); nothing
    else of the orchestrator touches a device.
    """
    from pydcop_tpu_torch.algorithms import (
        load_algorithm_module,
        prepare_algo_params,
        require_island_support,
    )
    from pydcop_tpu_torch.dcop.yamldcop import dcop_yaml
    from pydcop_tpu_torch.graphs import load_graph_module

    t0 = time.perf_counter()
    tracer = get_tracer()
    module = load_algorithm_module(algo)
    if not hasattr(module, "build_computation"):
        raise ValueError(
            f"{algo}: no host build_computation — use the SPMD "
            "orchestrator for batched-only algorithms"
        )
    accel_agents = set(accel_agents or ())
    if accel_agents:
        require_island_support(module, algo)
    if k_target > 0 and not getattr(module, "MIGRATION_SAFE", False):
        # phased round-barrier algorithms (mgm/mgm2/dba/gdba) and
        # single-shot protocols (dpop/syncbb) would deadlock or wedge
        # when a rebuilt computation rejoins at cycle 0: fail at
        # deploy time, not silently mid-run
        raise PlacementError(
            f"{algo}: k_target migration needs a quiescence-"
            "terminating algorithm that re-syncs migrated neighbors "
            "(dsa/adsa/dsatuto, maxsum/amaxsum); round-barrier and "
            "single-shot protocols would wedge at the cycle barrier"
        )
    params = prepare_algo_params(params, module.algo_params)
    chaos_plan = None
    if chaos:
        from pydcop_tpu_torch.faults import FaultPlan, FaultSpecError

        try:  # fail fast on a malformed spec, before any registration
            chaos_plan = FaultPlan.from_spec(chaos, chaos_seed)
        except FaultSpecError as e:
            raise PlacementError(str(e)) from e
        if tracer.enabled:
            tracer.event(
                "chaos-plan", cat="fault", spec=chaos, seed=chaos_seed
            )
    graph = load_graph_module(module.GRAPH_TYPE).build_computation_graph(
        dcop
    )
    comp_names = sorted(n.name for n in graph.nodes)

    ui = None  # created after registration; closed in the finally
    if server is None:
        server = socket.create_server(("", port))
    # a caller may pass a PRE-BOUND listener (solve(mode='process')
    # does: it must know the port before forking the agents, and a
    # probe-then-rebind would race other port users)
    server.settimeout(register_timeout)
    peers: Dict[str, Tuple[socket.socket, Any]] = {}
    addresses: Dict[str, Tuple[str, int]] = {}

    def _ask_all(
        obj: Dict[str, Any],
        names: Optional[List[str]] = None,
        resilient: bool = False,
    ) -> Dict[str, Dict[str, Any]]:
        """Pipelined control round-trip: the request goes to EVERY
        agent before any reply is read, so a poll sweep costs one
        round-trip latency instead of n_agents of them (the round-3
        serial loop was a quadratic-ish drag at ~100 agents).

        ``resilient=True`` (k_target runs): a dead agent does not
        abort the sweep — the surviving replies are returned and the
        dead names land in the shared ``newly_dead`` list for the
        caller's migration handler; reply ``error`` fields are also
        returned (not raised) so send-errors toward a just-dead peer
        can be tolerated instead of failing the run."""
        names = list(peers) if names is None else names
        sent: List[str] = []
        for name in names:
            try:
                _send(peers[name][0], obj)
                sent.append(name)
            except OSError as e:
                if not resilient:
                    raise AgentFailureError(
                        f"agent {name} died mid-solve "
                        f"({type(e).__name__})"
                    ) from e
                newly_dead.append(name)
        replies: Dict[str, Dict[str, Any]] = {}
        for name in sent:
            try:
                reply = _recv(peers[name][1])
            except (OSError, ValueError) as e:
                if not resilient:
                    raise AgentFailureError(
                        f"agent {name} died mid-solve "
                        f"({type(e).__name__})"
                    ) from e
                newly_dead.append(name)
                continue
            if reply is None:
                if not resilient:
                    raise AgentFailureError(
                        f"agent {name} died mid-solve"
                    )
                newly_dead.append(name)
                continue
            # a reply-borne "error" field is NOT raised here: the run
            # loop owns that decision (computation errors are fatal,
            # send errors get the grace window / degraded path — for
            # both the resilient and the static mode)
            replies[name] = reply
        return replies

    # agents found dead during a resilient sweep, consumed by the run
    # loop's migration handler (duplicates possible across sweeps —
    # consumers de-dup against `peers`)
    newly_dead: List[str] = []

    try:
        t_reg = time.perf_counter()
        while len(peers) < nb_agents:
            try:
                conn, peer_addr = server.accept()
            except socket.timeout:
                raise AgentFailureError(
                    f"only {len(peers)}/{nb_agents} agents registered "
                    f"within {register_timeout:.0f}s"
                ) from None
            conn.settimeout(register_timeout)
            reader = conn.makefile("rb")
            try:
                reg = _recv(reader)
            except (OSError, ValueError):
                conn.close()
                continue
            if not reg or reg.get("type") != "register":
                conn.close()
                continue
            name = reg["agent"]
            if name in peers:  # fail the duplicate fast + accurately
                try:
                    _send(
                        conn,
                        {
                            "type": "error",
                            "reason": f"agent name {name!r} is already "
                            "registered",
                        },
                    )
                except OSError:
                    pass
                conn.close()
                continue
            conn.settimeout(poll_timeout)
            peers[name] = (conn, reader)
            # the message-plane port the agent listens on, reached at
            # the IP its control connection came from
            addresses[name] = (peer_addr[0], int(reg["msg_port"]))

        tracer.add_span(
            "register", "phase", t_reg,
            time.perf_counter() - t_reg, agents=len(peers),
        )
        agent_names = sorted(peers)

        # a chaos clause naming a nonexistent agent would silently
        # inject NOTHING while the result still records the plan as
        # applied — a resilience test that "passes" with zero faults;
        # reject misspellings against the registered roster instead
        if chaos_plan is not None:
            unknown_chaos = chaos_plan.referenced_agents() - set(
                agent_names
            )
            if unknown_chaos:
                raise PlacementError(
                    f"chaos spec names unregistered agent(s) "
                    f"{sorted(unknown_chaos)} (registered: "
                    f"{agent_names}) — those faults would never fire"
                )

        # placement: explicit map > distribution strategy > round-robin
        from pydcop_tpu_torch.distribution import Distribution

        if placement is not None:
            unknown = set(placement) - set(agent_names)
            if unknown:
                raise PlacementError(
                    f"placement names unregistered agent(s) "
                    f"{sorted(unknown)} (registered: {agent_names})"
                )
        elif distribution is not None:
            from pydcop_tpu_torch.dcop.objects import AgentDef
            from pydcop_tpu_torch.distribution import compute_distribution

            agent_defs = [
                dcop.agents[a] if a in dcop.agents else AgentDef(a)
                for a in agent_names
            ]
            try:
                dist = compute_distribution(
                    distribution, graph, agent_defs,
                    hints=dcop.dist_hints, algo_module=module,
                )
            except ValueError as e:  # unknown/impossible strategy —
                # a usage/problem error, not an internal failure
                raise PlacementError(str(e)) from e
            placement = {
                a: dist.computations_hosted(a) for a in agent_names
            }
        else:
            placement = {a: [] for a in agent_names}
            for i, cname in enumerate(comp_names):
                placement[agent_names[i % len(agent_names)]].append(cname)

        # uniform validation whatever produced the placement:
        # Distribution() rejects a computation hosted twice; coverage
        # and name checks catch incomplete/bogus strategies and files
        try:  # Distribution() rejects a computation hosted twice
            placed = set(Distribution(placement).computations)
        except ValueError as e:
            raise PlacementError(str(e)) from e
        missing = set(comp_names) - placed
        if missing:
            raise PlacementError(
                f"placement leaves computation(s) {sorted(missing)} "
                "unhosted"
            )
        bogus = placed - set(comp_names)
        if bogus:
            raise PlacementError(
                f"placement names unknown computation(s) "
                f"{sorted(bogus)} (this problem/graph has: "
                f"{comp_names[:10]}...)"
            )
        placement = {a: list(placement.get(a, [])) for a in agent_names}

        unknown_accel = accel_agents - set(agent_names)
        if unknown_accel:
            raise PlacementError(
                f"accel_agents names unregistered agent(s) "
                f"{sorted(unknown_accel)} (registered: {agent_names})"
            )

        # k-resilience: pick replica-holder agents per computation
        # BEFORE the run (reference: replication happens at deploy
        # time, so a failure never has to plan from scratch)
        replica_map = None
        if k_target > 0:
            from pydcop_tpu_torch.dcop.objects import AgentDef
            from pydcop_tpu_torch.distribution import Distribution as _Dist
            from pydcop_tpu_torch.replication.ucs_hostingcosts import (
                replica_distribution,
            )

            agent_defs = {
                a: dcop.agents[a] if a in dcop.agents else AgentDef(a)
                for a in agent_names
            }
            replica_map = replica_distribution(
                _Dist(placement), agent_defs.values(), k_target
            )

        t_dep = time.perf_counter()
        yaml_text = dcop_yaml(dcop)
        directory = {a: list(addresses[a]) for a in agent_names}
        for name, (conn, _) in peers.items():
            _send(
                conn,
                {
                    "type": "deploy",
                    "dcop_yaml": yaml_text,
                    "algo": algo,
                    "params": params,
                    "computations": placement[name],
                    "placement": placement,
                    "directory": directory,
                    "seed": seed,
                    "accel": name in accel_agents,
                    # robustness knobs: the message plane's transient-
                    # fault grace window, and the (optional) fault-
                    # injection plan every agent applies outbound
                    "grace": grace_period,
                    "chaos": chaos,
                    "chaos_seed": chaos_seed,
                },
            )
        for name in peers:
            conn, reader = peers[name]
            # deploy = yaml parse + graph build + computation
            # construction on the agent — a large DCOP legitimately
            # takes longer than a status poll, so the ack read gets
            # the registration budget, not poll_timeout
            conn.settimeout(register_timeout)
            try:
                ack = _recv(reader)
            except (OSError, ValueError) as e:
                raise AgentFailureError(
                    f"agent {name} died during deploy "
                    f"({type(e).__name__})"
                ) from e
            finally:
                conn.settimeout(poll_timeout)
            if not ack or ack.get("type") != "deployed":
                raise AgentFailureError(f"agent {name} failed to deploy")
        tracer.add_span(
            "deploy", "phase", t_dep, time.perf_counter() - t_dep,
            agents=len(peers),
        )

        for name in peers:
            try:
                _send(peers[name][0], {"type": "start"})
            except OSError as e:
                raise AgentFailureError(
                    f"agent {name} died at start"
                ) from e

        resilient = k_target > 0

        # per-agent CUMULATIVE injected-fault counts (collect replies
        # carry the running totals; keeping the latest per agent makes
        # repeated sampling idempotent)
        chaos_by_agent: Dict[str, Dict[str, int]] = {}

        def _collect() -> Tuple[Dict[str, Any], int, int]:
            assignment: Dict[str, Any] = {}
            delivered = size = 0
            for aname, res in _ask_all(
                {"type": "collect"}, resilient=resilient
            ).items():
                assignment.update(res["values"])
                delivered += res["delivered"]
                size += res["size"]
                if res.get("chaos"):
                    chaos_by_agent[aname] = res["chaos"]
            return assignment, delivered, size

        # anytime-best tracking (same semantics as the other engines:
        # ``cost``/``assignment`` = best sampled state, ``final_*`` =
        # last state).  A sample torn across agents is still a valid
        # assignment — just a mix of two instants (runtime.py snapshot
        # makes the same argument).
        sign = -1.0 if dcop.objective == "max" else 1.0
        best = {"cost": float("inf"), "assignment": {}}
        # most recent COMPLETE sample (not necessarily the best):
        # migration restores a dead agent's variables from here
        last_ok = {"assignment": {}}
        trace: List[float] = []
        trace_msgs: List[int] = []  # delivered count at each sample

        if ui_port is not None:
            from pydcop_tpu_torch.infrastructure.ui import UiServer

            ui = UiServer(ui_port)

        def _complete(assignment: Dict[str, Any]) -> bool:
            """Every variable covered, every value selected — the one
            predicate both the sampler and the final collect use."""
            return set(assignment) == set(dcop.variables) and not any(
                v is None for v in assignment.values()
            )

        def _sample_best(delivered: int = 0) -> None:
            assignment, _, _ = _collect()
            if not _complete(assignment):
                return  # some variable has no selected value yet
            cost = dcop.solution_cost(assignment)
            last_ok["assignment"] = assignment
            trace.append(cost)  # anytime stream (--collect_on CSVs)
            trace_msgs.append(delivered)
            if sign * cost < best["cost"]:
                best["cost"] = sign * cost
                best["assignment"] = assignment
            if ui is not None:
                ui.publish(
                    delivered, cost, sign * best["cost"],
                    values=assignment,
                )

        # -- k-resilience: replica-based migration on agent death -----
        migrations: List[Dict[str, Any]] = []
        ledger_void = False  # post-migration: sent/delivered ledger
        # can never reconcile (frames to the dead peer are orphaned)
        suspects: Dict[Tuple[str, str], float] = {}
        dead_ever: set = set()  # every agent that has died this run:
        # ONLY send-errors toward these are tolerable — an error whose
        # "peer" is not a known-dead agent (e.g. an unroutable
        # computation name) is a real fault and must fail the run

        def _handle_failures() -> None:
            nonlocal ledger_void
            dead = sorted({d for d in newly_dead if d in peers})
            newly_dead.clear()
            if not dead:
                return
            t_rep = time.perf_counter()
            dead_ever.update(dead)
            from pydcop_tpu_torch.dcop.objects import AgentDef
            from pydcop_tpu_torch.replication.repair import repair_placement

            orphans: List[str] = []
            for d in dead:
                try:
                    peers[d][0].close()
                except OSError:
                    pass
                peers.pop(d)
                addresses.pop(d, None)
                orphans.extend(placement.pop(d, []))
                accel_agents.discard(d)
            if not peers:
                raise AgentFailureError(
                    f"all agents died (last: {dead})"
                )
            candidates = {
                c: [a for a in replica_map.replicas(c) if a in peers]
                for c in orphans
            }
            lost = sorted(c for c, cand in candidates.items() if not cand)
            if lost:
                raise AgentFailureError(
                    f"agent(s) {dead} died and computation(s) {lost} "
                    f"have no live replica holder (k_target={k_target})"
                )
            live_defs = [
                dcop.agents[a] if a in dcop.agents else AgentDef(a)
                for a in peers
            ]
            chosen = repair_placement(
                candidates, live_defs, seed=seed, device=device
            )
            for c, a in sorted(chosen.items()):
                placement[a].append(c)
            init_vals = {
                c: last_ok["assignment"][c]
                for c in chosen
                if c in dcop.variables and c in last_ok["assignment"]
            }
            msg = {
                "type": "reconfigure",
                "dead": dead,
                "migrated": chosen,
                "placement": placement,
                "directory": {a: list(addresses[a]) for a in peers},
                "initial_values": init_vals,
            }
            # phase 1: hosts GAINING computations deploy them first, so
            # the phase-2 re-announcements from neighbors can never
            # reach a not-yet-existing computation
            new_hosts = sorted(set(chosen.values()))
            _ask_all(msg, names=new_hosts, resilient=True)
            others = [a for a in peers if a not in set(new_hosts)]
            if others:
                _ask_all(msg, names=others, resilient=True)
            # a second failure DURING migration lands in newly_dead
            # and the next sweep handles it against the updated state
            migrations.append({"dead": dead, "moved": dict(chosen)})
            tracer.add_span(
                "repair", "repair", t_rep,
                time.perf_counter() - t_rep,
                dead=",".join(dead), moved=len(chosen),
            )
            suspects.clear()
            ledger_void = True

        # run loop: poll status until quiescent / budget / timeout
        t_run = time.perf_counter()
        max_msgs = rounds * max(len(comp_names), 1)
        status = "finished"
        degraded_info: Optional[Dict[str, Any]] = None
        stable = 0
        last_total = -1
        last_sample = 0.0
        while True:
            time.sleep(0.05)
            total = 0
            total_sent = 0
            all_idle = True
            replies = _ask_all({"type": "status?"}, resilient=resilient)
            now = time.perf_counter()
            if resilient and newly_dead:
                _handle_failures()
                stable, last_total = 0, -1
                continue
            for name, st in replies.items():
                if st.get("error"):
                    kind = st.get("error_kind")
                    peer_name = st.get("error_peer")
                    if kind != "send":
                        # a computation handler raised (or a legacy
                        # agent with no kind field): always fatal
                        raise AgentFailureError(
                            f"agent {name} failed: {st['error']}"
                        )
                    if not (resilient and peer_name in dead_ever):
                        # a send-error whose peer is NOT a known-dead
                        # agent (a live peer, or an unroutable
                        # computation name).  The agent's message
                        # plane already spent its retry window before
                        # surfacing this, so after the orchestrator's
                        # own grace (time for the control plane to
                        # notice a death / a heal to drain) it is
                        # PERMANENT: degrade to the anytime-best when
                        # allowed, else fail the run.
                        first = suspects.setdefault(
                            (name, peer_name), now
                        )
                        if now - first > grace_period:
                            if degraded_ok and best["assignment"]:
                                degraded_info = {
                                    "agent": name,
                                    "peer": peer_name,
                                    "error": st["error"],
                                }
                            else:
                                raise AgentFailureError(
                                    f"agent {name} send failure toward "
                                    f"{peer_name!r} outlived the "
                                    f"{grace_period:.1f}s grace "
                                    f"window: {st['error']}"
                                )
                        all_idle = False
                    # tolerated (dead peer / in-grace): the agent's
                    # totals still count — an agent with a sticky
                    # tolerated error must stay VISIBLE to quiescence
                total += st["delivered"]
                # missing field (older agent) degrades to the old
                # idle+stability rule instead of never quiescing
                total_sent += st.get("sent", st["delivered"])
                all_idle = all_idle and st["idle"]
            if now - last_sample >= best_sample_period:
                _sample_best(total)
                last_sample = now
            if degraded_info is not None:
                status = "degraded"
                break
            if timeout is not None and now - t0 > timeout:
                status = "timeout"
                break
            if total >= max_msgs:
                status = "msg_budget"
                break
            # two-counter quiescence: every agent idle, every SENT
            # frame also DELIVERED (nothing in flight on any TCP
            # link), and the totals stable across 3 polls — idle +
            # stability alone can declare quiescence mid-propagation
            # on a slow link (advisor r3, medium).  After a migration
            # the ledger is void (see _handle_failures), so fall back
            # to idle + stability over a DOUBLED window.
            if ledger_void:
                quiesced = all_idle and total == last_total
                need = 6
            else:
                quiesced = (
                    all_idle
                    and total_sent == total
                    and total == last_total
                )
                need = 3
            if quiesced:
                stable += 1
                if stable >= need:
                    break
            else:
                stable = 0
            last_total = total
        tracer.add_span(
            "deliver-loop", "phase", t_run,
            time.perf_counter() - t_run, status=status,
        )

        if degraded_info is not None:
            # graceful degradation: a permanent message-plane failure
            # with no repair path.  The control plane is still healthy
            # (a dead control connection raises AgentFailureError
            # elsewhere) — collect once for the traffic counters, but
            # the ASSIGNMENT is the anytime-best: post-partition agent
            # values are a torn mix trusted less than the best
            # complete sample.
            try:
                _, delivered, size = _collect()
            except AgentFailureError:
                delivered = trace_msgs[-1] if trace_msgs else 0
                size = 0
            final_assignment = dict(best["assignment"])
            final_cost = sign * best["cost"]
        else:
            final_assignment, delivered, size = _collect()
        # same guard as _sample_best: under a very short timeout or
        # budget an agent may report values before its computations
        # started (None) — solution_cost would crash inside constraint
        # evaluation; fall back to the best sampled assignment, or
        # fail cleanly when no complete snapshot ever existed
        if degraded_info is not None:
            pass  # assignment/cost already pinned to the anytime-best
        elif _complete(final_assignment):
            final_cost = dcop.solution_cost(final_assignment)
            trace.append(final_cost)  # the end state belongs in the
            # anytime stream too (a short run may never have hit a
            # complete periodic sample)
            trace_msgs.append(delivered)
            if sign * final_cost < best["cost"]:
                best["cost"] = sign * final_cost
                best["assignment"] = final_assignment
        elif best["assignment"]:
            final_assignment = best["assignment"]
            final_cost = sign * best["cost"]
        else:
            raise AgentFailureError(
                "run ended before any complete assignment was "
                "collected (timeout/message budget too short for the "
                "computations to start)"
            )
        if ui is not None:  # final event: the BEST pair (cost and
            # values belong together, matching the SPMD orchestrator)
            ui.publish(
                delivered, sign * best["cost"], sign * best["cost"],
                values=best["assignment"], status=status,
            )
        chaos_totals: Dict[str, int] = {}
        for counts in chaos_by_agent.values():
            for kind, n in counts.items():
                chaos_totals[kind] = chaos_totals.get(kind, 0) + n
        return {
            "assignment": best["assignment"],
            "cost": sign * best["cost"],
            "final_assignment": final_assignment,
            "final_cost": final_cost,
            "cycle": delivered,
            "msg_count": delivered,
            "msg_size": size,
            "status": status,
            "time": time.perf_counter() - t0,
            "cost_trace": trace,
            "trace_subsampled": True,  # one entry per 0.5s sample
            "trace_msgs": trace_msgs,  # exact delivered count per sample
            "agents": agent_names,
            "placement": {a: sorted(c) for a, c in placement.items()},
            # replica migrations performed (k_target resilience):
            # [{dead: [...], moved: {comp: new_agent}}, ...]
            "migrations": migrations,
            # fault-injection replay record: the plan (spec + seed
            # rebuild it exactly) and the per-kind injected counts
            **(
                {
                    "chaos": {
                        **chaos_plan.to_meta(),
                        "events": chaos_totals,
                    }
                }
                if chaos_plan is not None
                else {}
            ),
            # permanent message-plane failure the run degraded over
            **(
                {"degraded": degraded_info}
                if degraded_info is not None
                else {}
            ),
        }
    finally:
        if ui is not None:
            ui.close()
        for conn, _ in peers.values():
            try:
                _send(conn, {"type": "stop"})
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        server.close()


def run_host_agent(
    name: str,
    orchestrator: str,
    retry_for: float = 30.0,
    msg_log: Optional[str] = None,
    chaos: Optional[str] = None,
    chaos_seed: int = 0,
    device: str = "cuda",
) -> Dict[str, Any]:
    """One host agent process: register, deploy, run until ``stop``.

    ``msg_log`` dumps every delivered message's full content to a
    JSONL file (the reference's per-message log option).  Returns a
    summary dict (delivered count, values) for logging.

    ``chaos``/``chaos_seed`` apply a local fault-injection plan to
    this agent's outbound message plane; when None, the plan the
    orchestrator shipped in the deploy message (if any) is used — a
    local spec overrides it, so one agent of a fleet can be singled
    out for faults.

    ``device`` is where this agent's island compiles and steps when the
    orchestrator deploys one (an accel agent); the deploy message
    carries no device, it belongs to the agent's process.  Without a
    CUDA device the default fails the deploy (``NoCudaDeviceError``),
    never falling back to the CPU.  An island agent adds the CUDA
    kernel launches its run made to its telemetry, as the counters
    ``kernel.<wrapper>.launches``."""
    from pydcop_tpu_torch.algorithms import (
        AlgorithmDef,
        ComputationDef,
        load_algorithm_module,
    )
    from pydcop_tpu_torch.dcop.yamldcop import load_dcop
    from pydcop_tpu_torch.graphs import load_graph_module
    from pydcop_tpu_torch.infrastructure.agents import Agent
    from pydcop_tpu_torch.infrastructure.computations import (
        VariableComputation,
    )
    from pydcop_tpu_torch.infrastructure.discovery import Discovery

    from pydcop_tpu_torch.utils.backoff import call_with_backoff

    ohost, _, oport = orchestrator.partition(":")
    # control-plane connect: the same shared backoff-with-jitter
    # helper every retry loop uses (the old fixed 0.3s sleep hammered
    # a not-yet-listening orchestrator in lockstep across a fleet)
    conn = call_with_backoff(
        lambda: socket.create_connection((ohost, int(oport)), timeout=5),
        retry_for,
        base=0.1,
        max_delay=2.0,
        # keyed deterministic jitter (utils/backoff.py): per-agent
        # keys keep a fleet's connect storms decorrelated, while a
        # chaos replay (same chaos_seed) reproduces each agent's
        # connect timing exactly
        seed=chaos_seed,
        key=f"agent:{name}:connect",
    )
    conn.settimeout(None)
    reader = conn.makefile("rb")

    # handler/transport errors surface through the next status reply
    # (a dead pump or dead peer link must never masquerade as
    # quiescence) — shared by the agent pump and the async senders.
    # Entries are (kind, peer, text): the orchestrator's resilience
    # mode tolerates kind='send' toward a dead peer (and the
    # reconfigure that migrates its computations purges them), while
    # kind='comp' (a handler raised) always fails the run.
    errors: List[Tuple[str, str, str]] = []
    dead_peers: set = set()  # agents known dead (reconfigure msgs)
    comm = TcpCommunicationLayer(
        on_send_error=lambda dest, e: errors.append(
            ("send", str(dest), f"send to {dest}: {e!r}")
        )
    )
    _send(
        conn,
        {
            "type": "register",
            "agent": name,
            "msg_port": comm.address[1],
        },
    )
    dep = _recv(reader)
    if dep and dep.get("type") == "error":
        comm.close()
        raise AgentFailureError(
            f"agent {name}: rejected by orchestrator: {dep['reason']}"
        )
    if not dep or dep.get("type") != "deploy":
        comm.close()
        raise AgentFailureError(
            f"agent {name}: expected deploy, got {dep!r}"
        )

    tracer = get_tracer()
    t_dep = time.perf_counter()
    dcop = load_dcop(dep["dcop_yaml"])
    module = load_algorithm_module(dep["algo"])
    graph = load_graph_module(module.GRAPH_TYPE).build_computation_graph(
        dcop
    )
    algo_def = AlgorithmDef(dep["algo"], dep["params"], dcop.objective)
    mine = set(dep["computations"])
    by_name = {n.name: n for n in graph.nodes}
    comm.set_addresses(
        {a: tuple(addr) for a, addr in dep["directory"].items()}
    )
    # transient-fault grace window: the orchestrator's single knob —
    # the message plane retries failed sends with backoff for this
    # long before a link is declared dead (permanent)
    comm.retry_window = float(dep.get("grace", comm.retry_window))
    # fault injection: a local --chaos spec overrides the plan the
    # orchestrator shipped (so one agent of a fleet can be singled
    # out); the wrapper applies it to every outbound message
    chaos_spec = chaos if chaos is not None else dep.get("chaos")
    plane = comm
    chaos_layer = None
    if chaos_spec:
        import os as _os

        from pydcop_tpu_torch.faults import ChaosCommunicationLayer, FaultPlan

        try:
            plan = FaultPlan.from_spec(
                chaos_spec,
                chaos_seed
                if chaos is not None
                else int(dep.get("chaos_seed", 0)),
            )
        except Exception:
            comm.close()  # a malformed LOCAL spec (the orchestrator
            # validates its own before deploying)
            raise
        if tracer.enabled:
            tracer.event(
                "chaos-plan", cat="fault",
                spec=plan.spec, seed=plan.seed, agent=name,
            )
        # the plan's seed also keys the message plane's retry-backoff
        # jitter, so the whole retry schedule replays with the faults
        comm.backoff_seed = plan.seed
        chaos_layer = ChaosCommunicationLayer(
            comm,
            plan,
            name,
            grace=comm.retry_window,
            on_send_error=lambda dest, e: errors.append(
                ("send", str(dest), f"send to {dest}: {e!r}")
            ),
            # a scheduled crash is the scripted SIGKILL: no cleanup,
            # no goodbye on the control plane — exactly what the
            # repair machinery must survive
            on_crash=lambda: _os._exit(23),
        )
        plane = chaos_layer
    # computation → agent routing for the messaging layer
    directory = Discovery()
    for aname, comps in dep["placement"].items():
        directory.register_agent(aname)
        for cname in comps:
            directory.register_computation(cname, aname)

    log = None
    if msg_log is not None:
        from pydcop_tpu_torch.infrastructure.communication import MessageLog

        log = MessageLog(msg_log)
    agent = Agent(
        name, plane,
        on_error=lambda comp, e: errors.append(
            ("comp", str(comp), f"{comp}: {e!r}")
        ),
        discovery=directory,
        msg_log=log,
        # a send to a dead/unknown peer is a tolerated send-error (the
        # peer's computations are being migrated), never a computation
        # error that would fail the run
        on_unreachable=lambda dest, e: errors.append(
            ("send", str(dest), f"send to {dest}: {e!r}")
        ),
    )
    launches0 = None
    if dep.get("accel") and hasattr(module, "build_island"):
        # compiled island: this agent's whole sub-graph runs on the
        # array engine on this process's device behind per-node
        # proxies — the heterogeneous "one strong host" deployment
        from pydcop_tpu_torch.device import NoCudaDeviceError, resolve_device
        from pydcop_tpu_torch.ops import maxsum_kernels

        try:
            island_device = resolve_device(device)
        except (NoCudaDeviceError, ValueError):
            comm.close()
            raise
        launches0 = dict(maxsum_kernels.launches)
        computations = module.build_island(
            [
                ComputationDef(by_name[cname], algo_def)
                for cname in sorted(mine)
            ],
            dcop,
            seed=dep["seed"],
            # Messaging.queued excludes the in-flight message, so the
            # probe is exact both inside a proxy handler and from
            # on_start (where nothing is in flight)
            pending_fn=lambda: agent.messaging.queued,
            device=island_device,
        )
    else:
        computations = [
            module.build_computation(
                ComputationDef(by_name[cname], algo_def),
                seed=dep["seed"],
            )
            for cname in sorted(mine)
        ]
    for comp in computations:
        agent.deploy_computation(comp)
    tracer.add_span(
        "deploy", "phase", t_dep, time.perf_counter() - t_dep,
        agent=name, computations=len(computations),
    )
    _send(conn, {"type": "deployed", "n": len(computations)})

    delivered = 0
    try:
        while True:
            msg = _recv(reader)
            if msg is None:
                break  # orchestrator died: stop quietly
            mtype = msg.get("type")
            if mtype == "start":
                # the pump starts WITH the computations: inbound
                # frames that arrived early sit queued in Messaging
                # (and any popped before a computation's own start are
                # buffered by the computation itself)
                agent.start()
                agent.start_computations()
            elif mtype == "status?":
                # filter at READ time over a snapshot — never rewrite
                # the shared list (writer/pump threads append to it
                # concurrently, and a rewrite racing an append could
                # silently drop a fatal entry).  Send-errors toward a
                # migrated dead peer are expected noise; a computation
                # error (handler raised) is ALWAYS fatal and must
                # never be shadowed by a tolerable send entry that
                # happens to sit at index 0.
                snap = list(errors)
                err = next(
                    (e for e in snap if e[0] == "comp"),
                    next(
                        (
                            e
                            for e in snap
                            if not (
                                e[0] == "send" and e[1] in dead_peers
                            )
                        ),
                        None,
                    ),
                )
                _send(
                    conn,
                    {
                        "type": "status",
                        # held chaos frames count as sent-not-delivered
                        # (plane is the chaos wrapper when one is on),
                        # so injected delays/holds block quiescence
                        # exactly like real in-flight TCP frames
                        "idle": agent.is_idle,
                        "delivered": agent.messaging.count_msg,
                        "sent": plane.count_sent,
                        "error": err[2] if err else None,
                        "error_kind": err[0] if err else None,
                        "error_peer": err[1] if err else None,
                    },
                )
            elif mtype == "reconfigure":
                # replica migration (orchestrator k_target): deploy the
                # computations chosen for THIS agent, re-route the
                # migrated names, drop the dead peers, purge stale
                # send-errors toward them, and nudge every local
                # neighbor of a migrated computation to re-announce
                migrated: Dict[str, str] = msg["migrated"]
                init_vals = msg.get("initial_values", {})
                my_new = sorted(
                    c for c, a in migrated.items() if a == name
                )
                new_comps = []
                for cname in my_new:
                    comp = module.build_computation(
                        ComputationDef(by_name[cname], algo_def),
                        seed=dep["seed"],
                    )
                    if (
                        isinstance(comp, VariableComputation)
                        and cname in init_vals
                    ):
                        comp.restart_value = init_vals[cname]
                    new_comps.append(comp)
                # route the migrated names BEFORE unregistering the
                # dead agents, so a concurrent pump send never hits
                # an unregistration window
                for cname, aname in migrated.items():
                    directory.register_computation(cname, aname)
                for d in msg["dead"]:
                    directory.unregister_agent(d)
                    comm.forget_agent(d)
                dead_peers.update(msg["dead"])
                mine.update(my_new)
                comm.set_addresses(
                    {a: tuple(x) for a, x in msg["directory"].items()}
                )
                # (stale send-errors toward dead_peers are purged at
                # every status report — the only place they are read)
                for comp in new_comps:
                    agent.deploy_computation(comp)
                    computations.append(comp)
                    comp.start()
                # re-announce: each LOCAL computation neighboring a
                # migrated one re-sends its view, through the pump so
                # the hook runs on the computation thread
                for comp in computations:
                    nbrs = getattr(comp, "neighbors", ())
                    for m in migrated:
                        if m != comp.name and m in nbrs:
                            agent.messaging.deliver(
                                "_system",
                                comp.name,
                                Message("_peer_restarted", m),
                            )
                _send(conn, {"type": "reconfigured", "n": len(my_new)})
            elif mtype == "collect":
                values = {
                    c.variable.name: c.current_value
                    for c in computations
                    if isinstance(c, VariableComputation)
                }
                delivered = agent.messaging.count_msg
                _send(
                    conn,
                    {
                        "type": "result",
                        "values": values,
                        "delivered": delivered,
                        "size": agent.messaging.size_msg,
                        **(
                            {"chaos": chaos_layer.event_summary()}
                            if chaos_layer is not None
                            else {}
                        ),
                    },
                )
            elif mtype == "stop":
                break
    finally:
        agent.stop()
        # the pump ends with the message in hand: an island's device
        # round still running when the interpreter exits aborts the
        # process (torch's worker threads are torn down under it)
        agent.join(timeout=60.0)
        plane.close()  # the chaos wrapper (when on) closes the inner
        # transport after stopping its timer wheel
        if log is not None:
            log.close()
        met = get_metrics()
        if launches0 is not None and met.enabled:
            for kname, n in maxsum_kernels.launches.items():
                n -= launches0[kname]
                if n:
                    met.inc(f"kernel.{kname}.launches", n)
        try:
            conn.close()
        except OSError:
            pass
    return {"agent": name, "delivered": delivered}
