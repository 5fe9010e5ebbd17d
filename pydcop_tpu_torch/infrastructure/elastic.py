"""Elastic cross-process runtime: survive agent death mid-solve (port
of ``pydcop_tpu/infrastructure/elastic.py``).

The static orchestrator (``infrastructure/orchestrator.py``) fails the
run when an agent process dies — the right default for batch
experiments.  This module is the *resilient* deployment the reference
is known for (SURVEY §3.5: discovery removal events → reparation →
resume), rebuilt for the SPMD engine:

- Every participant (the orchestrator included) is a **supervisor**
  that hosts a disposable **worker subprocess**.  Workers run the
  actual SPMD solve over a ``torch.distributed`` process group (one
  process a shard, each on its supervisor's ``--device``); supervisors
  never import torch, so the control plane can never wedge in a dead
  collective.
- Workers barrier with the orchestrator at every chunk boundary (the
  lockstep protocol of the static runtime); the rank-0 worker's acks
  carry the current values, so the orchestrator always holds the last
  consistent assignment.
- On a worker or agent death (immediate EOF on its control
  connection), the orchestrator **re-forms**: kills all workers of
  the epoch, applies the failure to the problem — the dead agent's
  partition of DCOP agents is removed exactly like a scenario
  ``remove_agent`` (replicas migrate computations when ``k_target``
  > 0, computations without a live replica freeze their variable at
  its last value) — and starts a new epoch on the survivors with a
  fresh process group, the remaining round budget, and the carried
  values.  The orchestrator binds each epoch's store socket itself and
  hands it to its own worker (rank 0), so the port in the deploy is
  listening before any worker is told it.  A dead *worker* whose
  supervisor survives is simply respawned (crash recovery without
  capacity loss).
- A :class:`~pydcop_tpu_torch.infrastructure.discovery.Discovery` instance
  on the orchestrator receives register/removal events; the reform
  logic and the optional UI feed are its subscribers.

Partitioning: the problem's DCOP agents are split round-robin over the
control participants at start; dying participants take their DCOP
agents with them, matching the reference's agent-process = agents
mapping without requiring one OS process per DCOP agent.
"""

from __future__ import annotations

import os
import queue
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional

from pydcop_tpu_torch.infrastructure.discovery import Discovery
from pydcop_tpu_torch.infrastructure.orchestrator import (
    AgentFailureError,
    _announce,
    _arm_watchdog,
    _Peer,
    _recv,
    _send,
)

# both timing floors are env-overridable (deployment knobs that used
# to be hardcoded): defaults unchanged, a bad value fails at import
# with a clear message instead of deep inside a run
def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return float(raw)
    except ValueError:
        raise ValueError(
            f"{name}={raw!r} is not a number (seconds expected)"
        ) from None


_HEARTBEAT = _env_float("PYDCOP_TPU_ELASTIC_HEARTBEAT", 120.0)

# first barrier of an epoch additionally covers torch import + the
# YAML parse + compile_dcop + the kernels' first build on every worker
# — give it at least this much regardless of the configured heartbeat
_FIRST_BARRIER_MIN = _env_float(
    "PYDCOP_TPU_ELASTIC_FIRST_BARRIER_MIN", 600.0
)


def _spawn_worker(
    orchestrator_addr: str, epoch: int, process_id: int, device,
    store_fd: Optional[int] = None,
) -> subprocess.Popen:
    """The one place the worker subprocess command is built (used by
    the orchestrator for its local worker and by agent supervisors).
    ``store_fd``: a listening socket the worker inherits to serve the
    epoch's store on (rank 0)."""
    cmd = [
        sys.executable, "-m", "pydcop_tpu_torch", "worker",
        "--orchestrator", orchestrator_addr,
        "--epoch", str(epoch),
        "--process-id", str(process_id),
        "--device", str(device),
    ]
    if store_fd is not None:
        cmd += ["--store-fd", str(store_fd)]
    return subprocess.Popen(
        cmd, env=dict(os.environ),
        pass_fds=() if store_fd is None else (store_fd,),
    )


def _store_socket() -> socket.socket:
    """A listening socket on a port the OS picks, inheritable: an
    epoch's store, served by the rank-0 worker."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.bind(("", 0))
    s.listen(128)
    s.set_inheritable(True)
    return s


# ---------------------------------------------------------------------------
# orchestrator (supervisor + control plane)
# ---------------------------------------------------------------------------


class _Participant:
    """One control participant: the orchestrator itself or a remote
    agent supervisor, plus its current worker connection/process."""

    def __init__(self, name: str, peer: Optional[_Peer]):
        self.name = name
        self.peer = peer  # None for the orchestrator itself
        self.worker_peer: Optional[_Peer] = None
        self.worker_proc: Optional[subprocess.Popen] = None  # local only
        self.alive = True


def run_elastic_orchestrator(
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
    heartbeat_timeout: float = _HEARTBEAT,
    k_target: int = 0,
    ui_port: Optional[int] = None,
    abort_grace: float = 10.0,
    first_barrier_min: Optional[float] = None,
    device="cuda",
) -> Dict[str, Any]:
    """Run an elastic cross-process solve; returns the result dict with
    an ``events`` log of reforms.  The run only fails outright if ALL
    agents die or the orchestrator's own worker cannot run.

    ``heartbeat_timeout`` and ``first_barrier_min`` (the extra budget
    the FIRST barrier of an epoch gets for jax import + cold XLA
    compile) default to the module floors, themselves overridable via
    ``PYDCOP_TPU_ELASTIC_HEARTBEAT`` /
    ``PYDCOP_TPU_ELASTIC_FIRST_BARRIER_MIN`` — CI on slow shared
    runners raises them, short-window tests lower them; defaults are
    unchanged.  ``device`` is the ``--device`` of the orchestrator's own
    worker (agents give theirs to their workers); this process imports
    no torch."""
    if first_barrier_min is None:
        first_barrier_min = _FIRST_BARRIER_MIN
    from pydcop_tpu_torch.dcop.yamldcop import dcop_yaml as dump_yaml
    from pydcop_tpu_torch.dcop.yamldcop import load_dcop

    t_start = time.monotonic()
    base_dcop = load_dcop(dcop_yaml)

    server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    server.bind((host, port))
    server.listen(16)
    ctrl_port = server.getsockname()[1]
    _announce("control plane", port, ctrl_port)

    inbox: "queue.Queue" = queue.Queue()
    done_evt = threading.Event()
    discovery = Discovery()
    events_log: List[Dict[str, Any]] = []
    ui = None
    if ui_port is not None:
        from pydcop_tpu_torch.infrastructure.ui import UiServer

        ui = UiServer(ui_port)
        _announce("live feed", ui_port, ui.port)
        discovery.subscribe(
            lambda kind, ev, name, detail: ui.publish(
                0, None, None, discovery_event=f"{kind}:{ev}:{name}"
            )
        )

    def on_msg_factory(peer_box):
        def on_msg(msg):
            inbox.put((peer_box[0], msg))

        return on_msg

    def on_eof_factory(peer_box):
        def on_eof(_name):
            inbox.put((peer_box[0], None))

        return on_eof

    def accept_loop():
        while not done_evt.is_set():
            try:
                conn, _ = server.accept()
            except OSError:
                return
            # registration is bounded; AFTER it the connection must
            # have NO read timeout: supervisors are silent between
            # reforms and workers are silent through long XLA
            # compiles — liveness is EOF (kernel-signalled death) +
            # the main loop's barrier deadlines, never read idleness
            conn.settimeout(heartbeat_timeout)
            reader = conn.makefile("rb")
            try:
                msg = _recv(reader)
            except OSError:
                conn.close()
                continue
            if not msg or msg.get("type") != "register":
                conn.close()
                continue
            conn.settimeout(None)
            box: list = [None]
            peer = _Peer(
                msg.get("name", "?"), conn, done_evt,
                on_eof=on_eof_factory(box), on_msg=on_msg_factory(box),
                reader=reader,
            )
            box[0] = peer
            inbox.put((peer, {"__register__": True, **msg}))

    threading.Thread(target=accept_loop, daemon=True).start()

    # -- wait for agent registrations --------------------------------
    participants: List[_Participant] = [_Participant("_orchestrator", None)]
    discovery.register_agent("_orchestrator")
    deadline = time.monotonic() + heartbeat_timeout
    while len(participants) < nb_agents + 1:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            done_evt.set()
            server.close()
            raise AgentFailureError(
                f"only {len(participants) - 1}/{nb_agents} agents "
                f"registered within {heartbeat_timeout:.0f}s"
            )
        try:
            peer, msg = inbox.get(timeout=remaining)
        except queue.Empty:
            continue
        if msg and msg.get("__register__") and msg.get("role") != "worker":
            p = _Participant(msg.get("name", f"a{len(participants)}"), peer)
            participants.append(p)
            discovery.register_agent(p.name)

    # -- partition the computations (variables) over participants -----
    # the reference maps computations to agent processes via a
    # distribution; round-robin is the oneagent-style default here
    comps = sorted(base_dcop.variables)
    partition: Dict[str, List[str]] = {p.name: [] for p in participants}
    for i, v in enumerate(comps):
        owner = participants[i % len(participants)]
        partition[owner.name].append(v)
        discovery.register_computation(v, owner.name)

    # -- mutable run state -------------------------------------------
    frozen: Dict[str, Any] = {}
    carried_values: Dict[str, Any] = {}
    rounds_left = rounds
    epoch = 0
    status = "finished"

    def active_yaml() -> str:
        """Current problem: frozen variables become externals pinned at
        their last value; removed DCOP agents dropped."""
        from pydcop_tpu_torch.dcop.dcop import DCOP
        from pydcop_tpu_torch.dcop.objects import ExternalVariable

        d = DCOP(base_dcop.name, objective=base_dcop.objective)
        for v in base_dcop.variables.values():
            if v.name in frozen:
                d.add_variable(
                    ExternalVariable(v.name, v.domain, frozen[v.name])
                )
            else:
                d.add_variable(v)
        for ev in base_dcop.external_variables.values():
            d.add_variable(ev)
        for c in base_dcop.constraints.values():
            d.add_constraint(c)
        d.add_agents(base_dcop.agents.values())
        return dump_yaml(d)

    def remove_participant(part: _Participant) -> None:
        """Apply a participant death: its DCOP agents leave; their
        variables freeze at the carried values (k_target replication
        migrates nothing here because the batched state is globally
        replicated — every survivor already holds it, so 'repair' is
        simply re-partitioning; variables owned by nobody freeze)."""
        part.alive = False
        orphan_vars = partition.pop(part.name, [])
        survivors = [p for p in participants if p.alive]
        migrated: List[str] = []
        if k_target > 0 and survivors:
            # replicated state means any survivor can adopt: round-robin
            # the orphaned variables onto survivors (up to k_target per
            # survivor per reform, the replica budget)
            budget = {p.name: k_target for p in survivors}
            for i, v in enumerate(orphan_vars):
                tgt = survivors[i % len(survivors)]
                if budget[tgt.name] > 0:
                    partition[tgt.name].append(v)
                    budget[tgt.name] -= 1
                    migrated.append(v)
                    discovery.register_computation(v, tgt.name)
        for v in orphan_vars:
            if v not in migrated:
                frozen[v] = carried_values.get(
                    v, base_dcop.variables[v].domain[0]
                )
        discovery.unregister_agent(part.name)
        events_log.append(
            {
                "type": "participant_lost",
                "participant": part.name,
                "migrated": sorted(migrated),
                "frozen": sorted(
                    v for v in orphan_vars if v not in migrated
                ),
                "epoch": epoch,
            }
        )

    def spawn_local_worker(process_id: int, store_fd: int
                           ) -> subprocess.Popen:
        return _spawn_worker(f"localhost:{ctrl_port}", epoch, process_id,
                             device, store_fd)

    def kill_workers(live: List[_Participant]) -> None:
        for p in live:
            if p.worker_proc is not None:
                if p.worker_proc.poll() is None:
                    p.worker_proc.send_signal(signal.SIGKILL)
                    p.worker_proc.wait()
                p.worker_proc = None
            if p.worker_peer is not None:
                p.worker_peer.close()
                p.worker_peer = None

    result: Optional[Dict[str, Any]] = None
    try:
        while True:
            epoch += 1
            live = [p for p in participants if p.alive]
            if len(live) < 1 or not any(
                p.peer is None for p in live
            ):  # pragma: no cover — orchestrator always participant 0
                raise AgentFailureError("no live participants left")
            # the epoch's store listens before its port is deployed:
            # the local worker (rank 0) inherits this socket
            store_sock = _store_socket()
            coord_port = store_sock.getsockname()[1]
            num_processes = len(live)
            cur_yaml = active_yaml()
            deploy = {
                "type": "deploy",
                "elastic": True,
                "epoch": epoch,
                "dcop_yaml": cur_yaml,
                "algo": algo,
                "params": params,
                "rounds": rounds_left,
                "seed": seed + 1000 * epoch,
                "chunk_size": chunk_size,
                "num_processes": num_processes,
                "coordinator": f"{advertise_host}:{coord_port}",
                "heartbeat_timeout": heartbeat_timeout,
                "abort_grace": abort_grace,
                "initial_values": carried_values or None,
            }
            # process ids: orchestrator's worker = 0, agents 1..
            pid = 0
            for p in live:
                p.worker_pid = pid  # type: ignore[attr-defined]
                if p.peer is None:
                    p.worker_proc = spawn_local_worker(
                        0, store_sock.fileno())
                else:
                    # supervisors only spawn workers: ship them the
                    # slim header, not the full problem + values (the
                    # worker receives its own complete deploy when it
                    # registers)
                    p.peer.send(
                        {
                            "type": "deploy",
                            "elastic": True,
                            "epoch": epoch,
                            "process_id": pid,
                        }
                    )
                pid += 1
            store_sock.close()  # the local worker holds its own copy
            # local worker gets its deploy when it registers (below)

            # -- wait for all workers of this epoch ------------------
            live_workers: Dict[int, _Peer] = {}
            wd = time.monotonic() + max(heartbeat_timeout, 60.0)
            failed: Optional[_Participant] = None
            while len(live_workers) < num_processes and failed is None:
                remaining = wd - time.monotonic()
                if remaining <= 0:
                    raise AgentFailureError(
                        f"epoch {epoch}: workers failed to register "
                        f"({len(live_workers)}/{num_processes})"
                    )
                try:
                    peer, msg = inbox.get(timeout=remaining)
                except queue.Empty:
                    continue
                failed = _handle_common(peer, msg, live)
                if failed is not None:
                    break
                if (
                    msg
                    and msg.get("__register__")
                    and msg.get("role") == "worker"
                    and msg.get("epoch") == epoch
                ):
                    wpid = int(msg["process_id"])
                    live_workers[wpid] = peer
                    for p in live:
                        if p.worker_pid == wpid:  # type: ignore
                            p.worker_peer = peer
                    peer.send({**deploy, "process_id": wpid})

            # -- barrier loop ----------------------------------------
            completed = 0
            first_barrier = True
            while failed is None:
                acks: Dict[int, Dict] = {}
                # the first barrier also covers torch import + the
                # YAML parse + compile_dcop on every worker
                bd = time.monotonic() + (
                    max(heartbeat_timeout, first_barrier_min)
                    if first_barrier
                    else heartbeat_timeout
                )
                first_barrier = False
                while len(acks) < num_processes and failed is None:
                    remaining = bd - time.monotonic()
                    if remaining <= 0:
                        raise AgentFailureError(
                            f"epoch {epoch}: chunk barrier timed out"
                        )
                    try:
                        peer, msg = inbox.get(timeout=remaining)
                    except queue.Empty:
                        continue
                    failed = _handle_common(peer, msg, live)
                    if failed is not None:
                        break
                    if msg is None:
                        # unmatched EOF: a stale connection from a
                        # previous epoch (e.g. the dead agent's
                        # orphaned worker finally exiting) — ignore
                        continue
                    t = msg.get("type")
                    if t == "chunk" and msg.get("epoch") == epoch:
                        acks[int(msg["pid"])] = msg
                    elif t == "result" and msg.get("epoch") == epoch:
                        acks[int(msg["pid"])] = msg
                if failed is not None:
                    break
                if all(a.get("type") == "result" for a in acks.values()):
                    # epoch solved to completion: cross-check + done
                    costs = [a["cost"] for a in acks.values()]
                    if max(costs) - min(costs) > 1e-5:
                        raise AgentFailureError(
                            f"SPMD divergence across workers: {costs}"
                        )
                    r0 = acks[0]
                    completed = int(r0["cycle"])
                    result = dict(r0.get("result", {}))
                    break
                # interior barrier: record rank-0 values, decide go/halt
                r0 = acks.get(0, {})
                if "values" in r0:
                    carried_values.update(r0["values"])
                completed = max(
                    int(a.get("n", 0)) for a in acks.values()
                )
                if ui is not None:
                    ui.publish(
                        completed, None, r0.get("cost"), epoch=epoch
                    )
                if (
                    timeout is not None
                    and time.monotonic() - t_start > timeout
                ):
                    # the halted status flows back in the workers'
                    # result messages
                    for w in live_workers.values():
                        w.send({"type": "halt", "status": "timeout"})
                else:
                    for w in live_workers.values():
                        w.send({"type": "go"})

            if failed is not None:
                # -- reform ------------------------------------------
                if (
                    timeout is not None
                    and time.monotonic() - t_start > timeout
                ):
                    raise AgentFailureError(
                        "wall-clock timeout reached during reform"
                    )
                reforms = sum(
                    1 for e in events_log
                    if e["type"] in ("participant_lost", "worker_crash")
                )
                # crash-loop cap: a worker that deterministically dies
                # before its first barrier would otherwise respawn on
                # the identical problem forever
                if reforms >= 2 * (nb_agents + 1):
                    raise AgentFailureError(
                        f"giving up after {reforms} reforms "
                        "(crash-looping worker?)"
                    )
                rounds_left = max(1, rounds_left - completed)
                kill_workers(live)
                if isinstance(failed, _WorkerOnlyFailure):
                    # crash recovery: the supervisor is alive, only
                    # its worker died — respawn on the same partition
                    events_log.append(
                        {
                            "type": "worker_crash",
                            "participant": failed.name,
                            "epoch": epoch,
                        }
                    )
                else:
                    remove_participant(failed)
                for p in participants:
                    if p.alive and p.peer is not None:
                        p.peer.send({"type": "reform", "epoch": epoch})
                # drain stale messages of the dead epoch
                time.sleep(0.2)
                while not inbox.empty():
                    try:
                        peer, msg = inbox.get_nowait()
                    except queue.Empty:
                        break
                    if msg and msg.get("__register__"):
                        inbox.put((peer, msg))  # late register: keep
                        break
                continue
            break  # result collected

        assert result is not None
        if status == "finished" and result.get("status"):
            status = result["status"]
        # frozen variables re-enter the assignment at their pinned value
        assignment = dict(result.get("assignment", {}))
        for v, val in frozen.items():
            assignment[v] = val
        cost = base_dcop.solution_cost(
            {
                **assignment,
                **{
                    n: ev.value
                    for n, ev in base_dcop.external_variables.items()
                },
            }
        )
        if ui is not None:
            ui.publish(
                int(result.get("cycle", 0)), cost, cost,
                values=assignment, status=status, epoch=epoch,
            )
        return {
            "assignment": assignment,
            "cost": cost,
            "cycle": int(result.get("cycle", 0)),
            "msg_count": int(result.get("msg_count", 0)),
            "msg_size": int(result.get("msg_count", 0)),
            "status": status,
            "time": time.monotonic() - t_start,
            "events": events_log,
            "epochs": epoch,
            "agents": [p.name for p in participants if p.peer is not None],
            "agents_final": [
                p.name for p in participants
                if p.alive and p.peer is not None
            ],
            "lost_computations": sorted(frozen),
            "num_processes": len([p for p in participants if p.alive]),
        }
    finally:
        done_evt.set()
        if ui is not None:
            ui.close()
        for p in participants:
            if p.peer is not None:
                p.peer.send({"type": "stop"})
        kill_workers(participants)
        for p in participants:
            if p.peer is not None:
                p.peer.close()
        server.close()


def _handle_common(peer, msg, live):
    """Shared inbox handling: detects participant/worker death on EOF.
    Returns the failed participant (a plain _Participant for a
    supervisor death → partition removal, a _WorkerOnlyFailure when
    only the worker died → respawn without capacity loss), else None.
    """
    if msg is not None:
        return None
    for p in live:
        if peer is p.peer:
            return p
    for p in live:
        if peer is p.worker_peer:
            return _WorkerOnlyFailure(p)
    return None


class _WorkerOnlyFailure(_Participant):
    """Wrapper marking 'worker died, supervisor alive'."""

    def __init__(self, part: _Participant):
        self.part = part
        self.name = part.name
        self.peer = part.peer
        self.worker_peer = part.worker_peer
        self.worker_proc = part.worker_proc
        self.alive = True


# ---------------------------------------------------------------------------
# agent supervisor loop (called from run_agent on an elastic deploy)
# ---------------------------------------------------------------------------


def elastic_agent_loop(conn, peer, first_deploy, name, orchestrator_addr,
                       device="cuda"):
    """Supervise workers for an elastic run: spawn one per deploy/
    reform (on ``device``), kill on reform/stop.  Returns a small
    summary dict."""
    worker: Optional[subprocess.Popen] = None
    deploys = 0

    def spawn(msg):
        nonlocal worker, deploys
        kill()
        deploys += 1
        worker = _spawn_worker(
            orchestrator_addr, msg["epoch"], msg["process_id"], device
        )

    def kill():
        nonlocal worker
        if worker is not None and worker.poll() is None:
            worker.send_signal(signal.SIGKILL)
            worker.wait()
        worker = None

    try:
        spawn(first_deploy)
        while True:
            try:
                msg = peer.get(timeout=60.0)
            except queue.Empty:
                continue  # idle between reforms is the normal state
            if msg is None:
                break  # orchestrator died
            t = msg.get("type")
            if t == "deploy":
                spawn(msg)
            elif t == "reform":
                kill()  # next deploy will respawn
            elif t == "stop":
                break
    finally:
        kill()
        conn.close()
    return {"agent": name, "deploys": deploys, "status": "stopped"}


# ---------------------------------------------------------------------------
# worker process
# ---------------------------------------------------------------------------


def run_worker(orchestrator_addr: str, epoch: int, process_id: int,
               device="cuda", store_fd: Optional[int] = None) -> int:
    """One epoch's SPMD participant: register, receive config, run ONE
    continuous batched solve in lockstep with the orchestrator
    (message state is preserved across barriers — no per-chunk
    restarts), and report the result.  ``device``: where this worker's
    shard runs (``parallel/distributed.py:rank_device``); ``store_fd``:
    the inherited listening socket rank 0 serves the store on."""
    ohost, oport = orchestrator_addr.rsplit(":", 1)
    conn = socket.create_connection((ohost, int(oport)), timeout=30)
    # no read timeout: a worker legitimately waits at a barrier while
    # its peers pay long imports and compiles; liveness is the
    # orchestrator's job (EOF + barrier deadlines)
    conn.settimeout(None)
    _send(
        conn,
        {
            "type": "register",
            "role": "worker",
            "name": f"worker{process_id}e{epoch}",
            "epoch": epoch,
            "process_id": process_id,
        },
    )
    reader = conn.makefile("rb")
    cfg = _recv(reader)
    if not cfg or cfg.get("type") != "deploy":
        return 1

    # from here on a reader thread owns the socket: if the control
    # connection dies while this process is wedged inside a collective
    # whose peer died, a watchdog force-exits after the deployed grace
    # — otherwise the orphan would hold the device until the group's
    # timeout
    done_evt = threading.Event()
    grace = float(cfg.get("abort_grace", 10.0))
    peer = _Peer(
        "orchestrator", conn, done_evt,
        on_eof=lambda _n: _arm_watchdog(
            done_evt, grace, "worker control connection lost"
        ),
        reader=reader,
    )

    import dataclasses as dc

    from pydcop_tpu_torch.algorithms import (
        load_algorithm_module,
        prepare_algo_params,
    )
    from pydcop_tpu_torch.dcop.yamldcop import load_dcop
    from pydcop_tpu_torch.engine.batched import run_batched
    from pydcop_tpu_torch.ops.compile import (
        compile_dcop,
        decode_assignment,
        encode_assignment,
    )
    from pydcop_tpu_torch.parallel.distributed import (
        bind_store,
        init_process_mesh,
        rank_device,
    )

    dev = rank_device(device, process_id)
    heartbeat = float(cfg.get("heartbeat_timeout", _HEARTBEAT))
    store = None
    if store_fd is not None:
        store = bind_store(cfg["num_processes"], heartbeat,
                           listen_fd=store_fd)
    mesh = init_process_mesh(cfg["coordinator"], cfg["num_processes"],
                             process_id, dev, heartbeat, store=store)
    ok = False
    try:
        dcop = load_dcop(cfg["dcop_yaml"])
        module = load_algorithm_module(cfg["algo"])
        params = dict(
            prepare_algo_params(cfg["params"], module.algo_params)
        )

        problem = compile_dcop(dcop, n_shards=mesh.size, device=dev)
        if cfg.get("initial_values"):
            known = {
                n: v
                for n, v in cfg["initial_values"].items()
                if n in set(problem.var_names)
            }
            if len(known) == len(problem.var_names):
                problem = dc.replace(
                    problem, init_idx=encode_assignment(problem, known)
                )
                params["initial"] = "declared"

        def cb(done_rounds, best_cost, values_arr):
            ack = {
                "type": "chunk",
                "epoch": epoch,
                "pid": process_id,
                "n": done_rounds,
            }
            if process_id == 0:
                # rank 0 ships the replicated CURRENT values (the
                # orchestrator's carry point for cluster re-forms) and
                # the anytime cost (the UI feed)
                ack["values"] = decode_assignment(problem, values_arr)
                ack["cost"] = float(best_cost)
            _send(conn, ack)
            while True:
                try:
                    msg = peer.get(timeout=30.0)
                except queue.Empty:
                    continue
                if msg is None:
                    raise AgentFailureError("orchestrator died")
                t = msg.get("type")
                if t == "go":
                    return None
                if t == "halt":
                    return msg.get("status", "halted")
                if t == "stop":
                    raise AgentFailureError("stopped mid-epoch")

        cb.wants_values = True  # type: ignore[attr-defined]

        r = run_batched(
            problem,
            module,
            params,
            rounds=int(cfg["rounds"]),
            seed=int(cfg["seed"]),
            chunk_size=int(cfg["chunk_size"]),
            mesh=mesh,
            chunk_callback=cb,
        )
        ok = True
    finally:
        if not ok:
            _arm_watchdog(threading.Event(), grace, "the worker failed")
        mesh.close(barrier=ok)

    _send(
        conn,
        {
            "type": "result",
            "epoch": epoch,
            "pid": process_id,
            "cost": float(r.best_cost),
            "cycle": int(r.cycles),
            "result": {
                "assignment": r.best_assignment,
                "cost": float(r.best_cost),
                "cycle": int(r.cycles),
                "msg_count": int(r.messages),
                "status": r.status,
            },
        },
    )
    try:
        while True:
            try:
                msg = peer.get(timeout=60.0)
            except queue.Empty:
                continue
            if msg is None or msg.get("type") in ("stop", "reform"):
                break
    except OSError:
        pass
    done_evt.set()
    conn.close()
    return 0
