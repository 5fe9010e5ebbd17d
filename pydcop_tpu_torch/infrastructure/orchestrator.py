"""Cross-process orchestrator/agent control plane (port of
``pydcop_tpu/infrastructure/orchestrator.py``; reference:
``pydcop/infrastructure/orchestrator.py`` + ``commands/agent.py``).

The reference runs one HTTP server per agent and POSTs every algorithm
message between processes.  Here, as in the JAX package, all processes
run the SAME sharded SPMD program (``engine.run_batched`` over a
:class:`~pydcop_tpu_torch.parallel.distributed.ProcessMesh`, one process
a shard), and the per-round neighbor exchange is a collective over a
``torch.distributed`` gloo process group — not application-level
messaging.  What remains is a thin *management* plane, which this
module provides over plain TCP JSON lines:

1. agents connect and register with the orchestrator;
2. the orchestrator ships each agent a deploy message (the problem
   YAML inline, algorithm + params, run budget, its process id, and
   the address of the process group's store); the message names no
   device: each process takes its own ``--device``;
3. every process joins the process group (the orchestrator is rank 0
   and serves the group's store) and runs the sharded solve — one
   process = one shard, results replicated;
4. **lockstep control**: at every interior chunk boundary each agent
   sends a ``chunk`` message and waits for the orchestrator's
   ``go``/``halt`` decision.  This is simultaneously (a) the heartbeat
   that detects hung agents, (b) the only place a wall-clock
   ``timeout`` is decided — by the orchestrator alone, so every
   process stops at the same chunk boundary (a per-process wall-clock
   check would diverge and leave the others in a collective), and (c)
   the point where a run can be halted early;
5. agents report their result; the orchestrator cross-checks all
   reported costs agree (SPMD determinism check), replies ``stop``,
   and returns the assembled result dict.

Failure handling (reference parity: the orchestrator surfaces agent
failure, SURVEY.md §2.5): a reader thread per connection turns peer
death into an immediate EOF event — a SIGKILLed process's sockets are
closed by the kernel, so detection is sub-second, not a socket-timeout
wait.  On failure the orchestrator notifies the surviving agents
(``abort``), fails the solve with a clean error naming the dead agent,
and — because a process wedged inside a collective whose peer died may
not return before the group's timeout — a watchdog force-exits the
process after ``abort_grace`` seconds with exit code 70.  Agents mirror
the same logic when the orchestrator dies.  ``stop``/``abort`` is
always sent in a ``finally`` so healthy peers never sit out the socket
timeout.

This module imports no torch: the solve (:func:`_run_spmd`) imports it
when it runs, so the elastic runtime's supervisors
(``infrastructure/elastic.py``), which only spawn and watch workers,
never load it.
"""

from __future__ import annotations

import json
import os
import queue
import socket
import sys
import threading
import time
from typing import Any, Dict, List, Optional

_ENC = "utf-8"
_TIMEOUT = 120.0

# exit code for "force-killed while wedged in a collective whose peer
# died" — distinguishable from ordinary tracebacks in tests and scripts
ABORT_EXIT_CODE = 70


class AgentFailureError(RuntimeError):
    """An agent process died or stopped responding mid-solve."""


def _send(conn: socket.socket, obj: Dict[str, Any]) -> None:
    conn.sendall((json.dumps(obj) + "\n").encode(_ENC))


def _recv(reader) -> Optional[Dict[str, Any]]:
    line = reader.readline()
    if not line:
        return None
    return json.loads(line.decode(_ENC))


class _Peer:
    """One control-plane connection, pumped by a reader thread.

    All inbound messages land in :attr:`inbox`; EOF or a read error
    lands a ``None`` sentinel and fires ``on_eof`` (unless the run
    already finished).  This keeps the main thread free to block in
    XLA while death detection stays immediate.
    """

    def __init__(self, name: str, conn: socket.socket, done_evt,
                 on_eof=None, on_msg=None, reader=None):
        self.name = name
        self.conn = conn
        self.inbox: "queue.Queue" = queue.Queue()
        self._done_evt = done_evt
        self._on_eof = on_eof
        self._on_msg = on_msg
        # reuse the registration-phase reader when given: a second
        # makefile() on the same socket would race its buffer
        self._reader = reader if reader is not None else conn.makefile("rb")
        self._thread = threading.Thread(
            target=self._pump, name=f"ctl-{name}", daemon=True
        )
        self._thread.start()

    def _pump(self) -> None:
        try:
            while True:
                msg = _recv(self._reader)
                if msg is None:
                    break
                if self._on_msg is not None:
                    self._on_msg(msg)
                self.inbox.put(msg)
        except (OSError, ValueError):
            pass
        self.inbox.put(None)
        if self._on_eof is not None and not self._done_evt.is_set():
            self._on_eof(self.name)

    def send(self, obj: Dict[str, Any]) -> bool:
        try:
            _send(self.conn, obj)
            return True
        except OSError:
            return False

    def get(self, timeout: float) -> Optional[Dict[str, Any]]:
        """Next inbound message; None on peer EOF; raises on timeout."""
        return self.inbox.get(timeout=timeout)

    def close(self) -> None:
        try:
            self.conn.close()
        except OSError:
            pass


def _announce(what: str, asked: Optional[int], bound: int) -> None:
    """When the port ``asked`` for ``what`` was 0 (the OS picks it),
    tell the operator on stderr which port it got: agents, or the
    feed's clients, need it."""
    if asked == 0:
        print(f"orchestrator: {what} on port {bound}", file=sys.stderr,
              flush=True)


def _arm_watchdog(done_evt, grace: float, reason: str) -> None:
    """Force-exit the process if the main thread stays wedged (inside a
    collective whose peer died) past ``grace`` seconds."""

    def _watch():
        if not done_evt.wait(grace):
            print(
                f"pydcop_tpu_torch: FATAL: {reason}; main thread did not "
                f"return within {grace:.0f}s (wedged in a collective?) "
                "— force-exiting",
                file=sys.stderr,
                flush=True,
            )
            os._exit(ABORT_EXIT_CODE)

    threading.Thread(target=_watch, daemon=True).start()


def run_orchestrator(
    dcop_yaml: str,
    algo: str,
    params: Dict[str, Any],
    port: int,
    nb_agents: int = 1,
    rounds: int = 200,
    seed: int = 0,
    chunk_size: int = 64,
    timeout: Optional[float] = None,
    host: str = "0.0.0.0",
    advertise_host: str = "localhost",
    heartbeat_timeout: float = _TIMEOUT,
    abort_grace: float = 5.0,
    scenario_yaml: Optional[str] = None,
    k_target: int = 0,
    ui_port: Optional[int] = None,
    device=None,
) -> Dict[str, Any]:
    """Serve the management plane, run the solve as process 0, and
    return the assembled result dict.

    With ``ui_port``, a live observability feed (SSE, see
    ``infrastructure/ui.py``) publishes the lockstep progress and the
    final result while the run is in flight.

    ``device`` is where this process's shard runs (``parallel/
    distributed.py:rank_device``: the CUDA device by default, raising
    ``NoCudaDeviceError`` before any agent registers when there is
    none; ``"cpu"`` only when asked for).  With ``port`` 0 the port the
    OS picked is announced on stderr.

    Raises :class:`AgentFailureError` (after notifying survivors) if an
    agent dies or stops heartbeating mid-solve.
    """
    from pydcop_tpu_torch.parallel.distributed import (
        bind_store,
        rank_device,
    )

    dev = rank_device(device, 0)  # no card: fail before registration
    num_processes = nb_agents + 1
    t_start = time.monotonic()

    server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    server.bind((host, port))
    server.listen(nb_agents)
    _announce("control plane", port, server.getsockname()[1])
    server.settimeout(heartbeat_timeout)
    # rank 0's store listens before any agent learns its port (a port
    # picked free and bound later could be taken in between)
    store = bind_store(num_processes, heartbeat_timeout, advertise_host)
    coord_port = store.port

    done_evt = threading.Event()
    dead: List[str] = []  # names of agents whose connection dropped
    peers: List[_Peer] = []
    solve_started = False  # process group up → teardown can wedge

    def _on_peer_eof(name: str) -> None:
        dead.append(name)
        for p in peers:
            if p.name != name:
                p.send({"type": "abort", "reason": f"agent {name} died"})
        _arm_watchdog(done_evt, abort_grace, f"agent {name!r} died")

    def _broadcast(obj: Dict[str, Any]) -> None:
        for p in peers:
            p.send(obj)

    def _fail(why: str) -> AgentFailureError:
        # notify survivors before raising so they don't sit out the
        # socket timeout blocked on our next decision
        _broadcast({"type": "abort", "reason": why})
        return AgentFailureError(why)

    try:
        while len(peers) < nb_agents:
            conn, _ = server.accept()
            conn.settimeout(heartbeat_timeout)
            reader = conn.makefile("rb")
            msg = _recv(reader)
            if not msg or msg.get("type") != "register":
                conn.close()
                continue
            name = msg.get("name", f"agent_{len(peers) + 1}")
            peers.append(
                _Peer(name, conn, done_evt, on_eof=_on_peer_eof,
                      reader=reader)
            )

        deploy_base = {
            "type": "deploy",
            "dcop_yaml": dcop_yaml,
            "algo": algo,
            "params": params,
            "rounds": rounds,
            "seed": seed,
            "chunk_size": chunk_size,
            "num_processes": num_processes,
            "coordinator": f"{advertise_host}:{coord_port}",
            "heartbeat_timeout": heartbeat_timeout,
            "abort_grace": abort_grace,
        }
        if scenario_yaml is not None:
            deploy_base["scenario_yaml"] = scenario_yaml
            deploy_base["k_target"] = k_target
        for i, peer in enumerate(peers):
            peer.send({**deploy_base, "process_id": i + 1})

        def chunk_cb(done_rounds: int, best_cost: float) -> Optional[str]:
            # lockstep barrier: collect one `chunk` ack per agent,
            # then broadcast the shared go/halt decision
            deadline = time.monotonic() + heartbeat_timeout
            for peer in peers:
                while True:
                    if dead:
                        raise _fail(f"agent {dead[0]!r} died mid-solve")
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise _fail(
                            f"agent {peer.name!r} missed the chunk "
                            f"heartbeat ({heartbeat_timeout:.0f}s)"
                        )
                    try:
                        msg = peer.get(timeout=min(remaining, 1.0))
                    except queue.Empty:
                        continue
                    if msg is None:
                        raise _fail(f"agent {peer.name!r} died mid-solve")
                    if msg.get("type") == "chunk":
                        break
            if (
                timeout is not None
                and time.monotonic() - t_start > timeout
            ):
                _broadcast({"type": "halt", "status": "timeout"})
                return "timeout"
            _broadcast({"type": "go"})
            return None

        ui = None
        cb = chunk_cb
        if ui_port is not None:
            from pydcop_tpu_torch.infrastructure.ui import (
                UiServer,
                chunk_publisher,
            )

            ui = UiServer(ui_port)
            _announce("live feed", ui_port, ui.port)
            cb = chunk_publisher(ui, prev_callback=chunk_cb)

        solve_started = True
        try:
            result = _run_spmd(
                dcop_yaml, algo, params, rounds, seed, chunk_size,
                coordinator=f"localhost:{coord_port}",
                num_processes=num_processes,
                process_id=0,
                chunk_callback=cb,
                scenario_yaml=scenario_yaml,
                k_target=k_target,
                device=dev,
                group_timeout=heartbeat_timeout,
                abort_grace=abort_grace,
                store=store,
            )
            if ui is not None:
                ui.publish(
                    result["cycle"], result["cost"], result["cost"],
                    values=result.get("assignment"),
                    status=result.get("status"),
                )
        finally:
            if ui is not None:
                ui.close()

        # collect + cross-check agent results (SPMD replication means
        # every process must report the identical cost)
        agent_results = []
        for peer in peers:
            deadline = time.monotonic() + heartbeat_timeout
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise _fail(
                        f"agent {peer.name!r} sent no result within "
                        f"{heartbeat_timeout:.0f}s"
                    )
                try:
                    msg = peer.get(timeout=remaining)
                except queue.Empty:
                    continue
                if msg is None:
                    raise _fail(
                        f"agent {peer.name!r} disconnected without a "
                        "result"
                    )
                if msg.get("type") == "result":
                    break
                # late chunk acks from the final boundary: skip
            agent_results.append(msg)
            if abs(msg["cost"] - result["cost"]) > 1e-5:
                raise _fail(
                    f"agent {peer.name!r} reported cost {msg['cost']}, "
                    f"orchestrator computed {result['cost']} — SPMD "
                    "divergence"
                )
        result["agents"] = [p.name for p in peers]
        return result
    except BaseException as exc:
        # a peer death usually surfaces as a failed gloo collective
        # before the chunk barrier notices — name the dead agent
        if dead and not isinstance(exc, AgentFailureError):
            exc = AgentFailureError(
                f"agent {dead[0]!r} died mid-solve "
                f"(collective failed: {type(exc).__name__})"
            )
        # after a MID-SOLVE failure the process group is
        # unrecoverable and its teardown can hang trying to reach the
        # dead peer: guarantee the process exits.  Pre-solve
        # failures (registration/deploy) leave nothing wedged — let
        # the caller handle the exception normally.
        if solve_started:
            _arm_watchdog(threading.Event(), abort_grace, str(exc))
        raise exc
    finally:
        done_evt.set()
        _broadcast({"type": "stop"})
        for peer in peers:
            peer.close()
        server.close()


def run_agent(
    orchestrator_addr: str,
    name: str,
    retry_for: float = 30.0,
    device="cuda",
) -> Dict[str, Any]:
    """Register with the orchestrator, run the deployed solve as one
    SPMD process in lockstep with the control plane, report the
    result, and return it.

    ``device`` is where this process's shard runs
    (``parallel/distributed.py:rank_device`` with the deployed process
    id: ``"cuda"`` is the card ``process_id % device_count``; without
    CUDA the agent raises ``NoCudaDeviceError`` before it joins the
    process group).  An elastic deploy hands it to the workers this
    agent supervises."""
    ohost, oport = orchestrator_addr.rsplit(":", 1)
    deadline = time.monotonic() + retry_for
    conn = None
    while True:
        try:
            conn = socket.create_connection((ohost, int(oport)), timeout=5)
            break
        except OSError:
            if time.monotonic() >= deadline:
                raise
            time.sleep(0.3)
    conn.settimeout(_TIMEOUT)
    done_evt = threading.Event()
    abort_reason: List[str] = []
    grace = 5.0
    solve_started = False

    try:
        _send(conn, {"type": "register", "name": name})
        reader = conn.makefile("rb")
        deploy = _recv(reader)
        if not deploy or deploy.get("type") != "deploy":
            raise RuntimeError(f"agent {name}: bad deploy message {deploy}")
        if deploy.get("elastic"):
            # elastic runtime: this process becomes a worker SUPERVISOR
            # (spawns/kills SPMD worker subprocesses across reforms).
            # Supervisors are IDLE between reforms by design — the
            # read timeout must go or the pump thread mistakes quiet
            # for orchestrator death and kills its healthy worker
            from pydcop_tpu_torch.infrastructure.elastic import (
                elastic_agent_loop,
            )

            conn.settimeout(None)
            peer = _Peer("orchestrator", conn, done_evt, reader=reader)
            try:
                return elastic_agent_loop(
                    conn, peer, deploy, name, orchestrator_addr,
                    device=device,
                )
            finally:
                done_evt.set()
        heartbeat = float(deploy.get("heartbeat_timeout", _TIMEOUT))
        grace = float(deploy.get("abort_grace", 5.0))
        from pydcop_tpu_torch.parallel.distributed import rank_device

        dev = rank_device(device, int(deploy["process_id"]))

        # from here on, a reader thread owns the socket: an `abort`
        # (another agent died) or EOF (orchestrator died) must be able
        # to unwedge this process even while the main thread is blocked
        # inside a collective

        def _on_eof(_name: str) -> None:
            abort_reason.append("orchestrator died")
            _arm_watchdog(done_evt, grace, "orchestrator died")

        def _watch_abort(msg):
            if msg.get("type") == "abort":
                abort_reason.append(msg.get("reason", "aborted"))
                _arm_watchdog(
                    done_evt, grace, f"aborted: {abort_reason[-1]}"
                )

        peer = _Peer("orchestrator", conn, done_evt, on_eof=_on_eof,
                     on_msg=_watch_abort, reader=reader)

        def chunk_cb(done_rounds: int, best_cost: float) -> Optional[str]:
            peer.send({"type": "chunk", "n": done_rounds})
            deadline = time.monotonic() + heartbeat
            while True:
                if abort_reason:
                    raise AgentFailureError(
                        f"agent {name}: run aborted ({abort_reason[0]})"
                    )
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise AgentFailureError(
                        f"agent {name}: no go/halt from orchestrator "
                        f"within {heartbeat:.0f}s"
                    )
                try:
                    msg = peer.get(timeout=min(remaining, 1.0))
                except queue.Empty:
                    continue
                if msg is None:
                    raise AgentFailureError(
                        f"agent {name}: orchestrator died mid-solve"
                    )
                t = msg.get("type")
                if t == "go":
                    return None
                if t == "halt":
                    return msg.get("status", "halted")
                if t == "abort":
                    raise AgentFailureError(
                        f"agent {name}: run aborted "
                        f"({msg.get('reason', '')})"
                    )
                # anything else (early stop) — keep waiting

        solve_started = True
        result = _run_spmd(
            deploy["dcop_yaml"],
            deploy["algo"],
            deploy["params"],
            deploy["rounds"],
            deploy["seed"],
            deploy["chunk_size"],
            coordinator=deploy["coordinator"],
            num_processes=deploy["num_processes"],
            process_id=deploy["process_id"],
            chunk_callback=chunk_cb,
            scenario_yaml=deploy.get("scenario_yaml"),
            k_target=int(deploy.get("k_target", 0)),
            device=dev,
            group_timeout=heartbeat,
            abort_grace=grace,
        )
        peer.send(
            {
                "type": "result",
                "name": name,
                "cost": result["cost"],
                "cycle": result["cycle"],
            }
        )
        # wait for stop (or EOF) so the orchestrator's cross-check
        # finishes before our socket goes away
        try:
            while True:
                msg = peer.get(timeout=heartbeat)
                if msg is None or msg.get("type") in ("stop", "abort"):
                    break
        except queue.Empty:
            pass
        return result
    except BaseException as exc:
        if abort_reason and not isinstance(exc, AgentFailureError):
            exc = AgentFailureError(
                f"agent {name}: run aborted ({abort_reason[0]}; "
                f"collective failed: {type(exc).__name__})"
            )
        if solve_started:  # see run_orchestrator: pre-solve failures
            # leave nothing wedged, don't force-exit the host process
            _arm_watchdog(threading.Event(), grace, str(exc))
        raise exc
    finally:
        done_evt.set()
        conn.close()


def _run_spmd(
    dcop_yaml: str,
    algo: str,
    params: Dict[str, Any],
    rounds: int,
    seed: int,
    chunk_size: int,
    coordinator: str,
    num_processes: int,
    process_id: int,
    timeout: Optional[float] = None,
    chunk_callback=None,
    scenario_yaml: Optional[str] = None,
    k_target: int = 0,
    device=None,
    group_timeout: float = _TIMEOUT,
    abort_grace: Optional[float] = None,
    store=None,
) -> Dict[str, Any]:
    """Join the process group and run the sharded solve.

    Every process executes this identical function on its own device
    (``device``, see ``parallel/distributed.py:rank_device``; rank
    ``process_id``) over a
    ``ProcessMesh``: each rank steps its own shard and the state's
    replicated leaves give every process the full result.  The
    wall-clock ``timeout`` is only honored on single-process runs —
    orchestrated runs stop via ``chunk_callback`` so all processes stop
    at the same chunk boundary.  ``group_timeout`` bounds every wait at
    a collective.  Rank 0 passes the ``store`` it serves.  The process
    leaves the group in a ``finally``; after a failure, with
    ``abort_grace`` set, a watchdog force-exits the process if leaving
    wedges.

    On a card the kernel library is built (or loaded) before the first
    round, so that no rank reaches the first chunk barrier late by a
    compile.  The telemetry session gets ``spmd.deploy_seconds`` (from
    entry to the first round: the group, the YAML parse, the compile,
    the kernels' build), ``spmd.engine_seconds``, ``spmd.psums``,
    ``spmd.psum_seconds`` and ``kernel.<wrapper>.launches`` of this
    rank.
    """
    t_enter = time.perf_counter()
    from pydcop_tpu_torch.algorithms import (
        load_algorithm_module,
        prepare_algo_params,
    )
    from pydcop_tpu_torch.dcop.yamldcop import load_dcop
    from pydcop_tpu_torch.engine.batched import run_batched
    from pydcop_tpu_torch.ops import maxsum_kernels
    from pydcop_tpu_torch.ops.compile import compile_dcop
    from pydcop_tpu_torch.parallel.distributed import (
        init_process_mesh,
        rank_device,
    )
    from pydcop_tpu_torch.telemetry import get_metrics

    device = rank_device(device, process_id)
    launches0 = dict(maxsum_kernels.launches)
    mesh = init_process_mesh(coordinator, num_processes, process_id, device,
                             group_timeout, store=store)
    ok = False
    try:
        dcop = load_dcop(dcop_yaml)
        module = load_algorithm_module(algo)
        full_params = prepare_algo_params(params, module.algo_params)
        n_shards = mesh.size  # global
        if device.type == "cuda":
            maxsum_kernels.build()
        if scenario_yaml is not None:
            from pydcop_tpu_torch.dcop.yamldcop import load_scenario
            from pydcop_tpu_torch.engine.dynamic import run_dynamic

            scenario = load_scenario(scenario_yaml)
            # run_dynamic's segment schedule is a deterministic function
            # of (dcop, scenario, seed), so every SPMD process replays
            # the exact same recompile/resume sequence; no wall-clock
            # timeout here for the same reason
            t_engine = time.perf_counter()
            r = run_dynamic(
                dcop,
                algo,
                params,
                scenario,
                k_target=k_target,
                final_rounds=rounds,
                seed=seed,
                mesh=mesh,
                n_shards=n_shards,
                chunk_size=chunk_size,
                chunk_callback=chunk_callback,
                device=device,
            )
            out = {
                **r,
                "num_processes": num_processes,
                "n_shards": n_shards,
                "backend": mesh.backend,
            }
        else:
            problem = compile_dcop(dcop, n_shards=n_shards, device=device)
            t_engine = time.perf_counter()
            r = run_batched(
                problem,
                module,
                full_params,
                rounds=rounds,
                seed=seed,
                timeout=timeout,
                chunk_size=chunk_size,
                mesh=mesh,
                chunk_callback=chunk_callback,
            )
            out = {
                "assignment": r.best_assignment,
                "cost": r.best_cost,
                "final_cost": r.cost,
                "cycle": r.cycles,
                "msg_count": r.messages,
                "msg_size": r.messages,
                "status": r.status,
                "time": r.time,
                "num_processes": num_processes,
                "n_shards": n_shards,
                "backend": mesh.backend,  # the process group's
                # per-round anytime stream, same shape as api.solve's
                # batched result: feeds the --collect_on metrics CSVs
                "cost_trace": r.cost_trace.tolist(),
            }
        met = get_metrics()
        if met.enabled:
            met.gauge("spmd.deploy_seconds", t_engine - t_enter)
            met.gauge("spmd.engine_seconds", time.perf_counter() - t_engine)
            met.inc("spmd.psums", mesh.psums)
            met.gauge("spmd.psum_seconds", mesh.psum_seconds)
            for kname, n in maxsum_kernels.launches.items():
                met.inc(f"kernel.{kname}.launches", n - launches0[kname])
        ok = True
        return out
    finally:
        if not ok and abort_grace is not None:
            _arm_watchdog(threading.Event(), abort_grace,
                          "the SPMD solve failed")
        mesh.close(barrier=ok)
