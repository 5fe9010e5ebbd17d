"""``pydcop_tpu_torch fleet`` — the self-healing replicated serving fleet
(port of ``pydcop_tpu/commands/fleet.py``).

Spawns N ``python -m pydcop_tpu_torch serve ... --device D`` replica
subprocesses (``--device`` passes through: the CUDA device by default,
each replica with its own CUDA context on the one card; ``cpu`` for the
CPU) (or attaches to externally
started ones by address), wires each replica's k standby successors
from the hash ring (``engine/fleet.py``), and fronts them with a
:class:`~pydcop_tpu_torch.engine.fleet.FleetRouter` speaking the ordinary
newline-JSON wire protocol — existing
:class:`~pydcop_tpu_torch.engine.service.ServiceClient` code points at the
router unchanged.  Sessions pin to a replica by hash of their name;
each replica streams its session delta logs to its ring successors,
so a SIGKILL'd replica's sessions resume on the standby
``compile.incremental``-only, and a failover retry of an answered
request replays the replicated reply (exactly-once).  See
``docs/serving.md``, "The fleet".

Chaos: ``--chaos replica_kill=T[:IDX]`` SIGKILLs one spawned replica
T seconds after the fleet is up — the victim chosen by a pure hash of
the seed unless pinned with ``:IDX`` — under the same determinism
contract as every other fault kind (``docs/faults.md``).  Fleet-level
kinds only: message/schedule/device/wire clauses belong to the layers
that inject them and are rejected here.

Prints one JSON head line ``{"fleet": "host:port", "replicas":
{name: addr, ...}, "pid": N}`` once the router is bound.
"""

from __future__ import annotations

import json
import os
import queue
import signal
import subprocess
import sys
import threading

from pydcop_tpu_torch.commands._common import (
    add_compile_cache_argument,
    add_trace_arguments,
    refuse_compile_cache,
)

#: seconds a spawned replica gets to print its head line (its first
#: CUDA context and imports included) before the fleet gives up on it
STARTUP_TIMEOUT = 120.0


def set_parser(subparsers) -> None:
    p = subparsers.add_parser(
        "fleet",
        help="run a replicated serving fleet: a consistent-hash "
        "router in front of N serve replicas with k-resilient "
        "session replication and exactly-once failover "
        "(docs/serving.md)",
    )
    p.add_argument(
        "--replicas", type=int, default=2, metavar="N",
        help="number of serve replica subprocesses to spawn on this "
        "host (ignored with --attach); default 2",
    )
    p.add_argument(
        "--attach", action="append", default=None, metavar="ADDR",
        dest="attach",
        help="front an EXTERNALLY started serve replica at ADDR "
        "(host:port, repeatable) instead of spawning; pair with "
        "ADDR=host:port/metrics_host:metrics_port to give the "
        "health watcher its /healthz endpoint",
    )
    p.add_argument(
        "--host", default="127.0.0.1",
        help="router bind address (default 127.0.0.1)",
    )
    p.add_argument(
        "--port", type=int, default=9009,
        help="router listen port (0 = ephemeral; printed on the "
        "head line)",
    )
    p.add_argument(
        "--resilience", type=int, default=1, metavar="K",
        help="standbys per replica (each replica streams its "
        "session delta logs to its K ring successors); default 1",
    )
    p.add_argument(
        "--pad_policy", default="pow2", metavar="POLICY",
        help="shape-bucketing policy passed to every spawned "
        "replica (must match across the fleet — a failed-over "
        "session must land in the same shape bucket); default pow2",
    )
    p.add_argument(
        "--max_batch", type=int, default=32, metavar="K",
        help="per-replica tick policy: dispatch at K pending",
    )
    p.add_argument(
        "--max_wait", type=float, default=0.01, metavar="SECONDS",
        help="per-replica tick policy: max queue hold",
    )
    add_compile_cache_argument(p)
    p.add_argument(
        "--device", default=None,
        help="passed to every spawned replica's `serve --device`: 'cpu' "
        "to serve on the CPU; default: the CUDA device",
    )
    p.add_argument(
        "--session_checkpoint", default=None, metavar="DIR",
        help="per-replica session checkpoint directory (each "
        "replica derives sessions-<pid>.json inside it)",
    )
    p.add_argument(
        "--flight_dump", default=None, metavar="DIR",
        help="per-replica flight-recorder dump directory (each "
        "replica derives flight-<pid>.json inside it)",
    )
    p.add_argument(
        "--health_interval", type=float, default=0.25,
        metavar="SECONDS",
        help="router /healthz poll interval — the detection half of "
        "the failover budget; default 0.25s",
    )
    p.add_argument(
        "--metrics_port", type=int, default=None, metavar="PORT",
        help="serve the ROUTER's aggregate /metrics and /healthz "
        "(fleet status + per-replica roster with their metrics "
        "addresses) on this port; `pydcop_tpu_torch top` expands the "
        "roster into per-replica rows (docs/observability.md)",
    )
    p.add_argument(
        "--chaos", default=None, metavar="SPEC",
        help="fleet-level seeded chaos: replica_kill=T[:IDX] "
        "SIGKILLs one spawned replica T seconds after startup "
        "(victim = pure hash of the seed, or pinned by :IDX) — "
        "docs/faults.md.  Message/schedule/device/wire kinds are "
        "rejected here (inject them at their own layers)",
    )
    p.add_argument(
        "--chaos_seed", type=int, default=0,
        help="seed for the --chaos fault plan (determinism/replay)",
    )
    add_trace_arguments(p)
    p.set_defaults(func=run_cmd)


def _parse_attach(specs):
    """``--attach`` values → ordered (name, addr, metrics) tuples.
    ``host:port`` alone leaves the health watcher blind to that
    replica (forward-failure detection still applies);
    ``host:port/mhost:mport`` names its /healthz endpoint."""
    out = []
    for i, spec in enumerate(specs):
        addr, _, metrics = spec.partition("/")
        if ":" not in addr:
            raise SystemExit(
                f"fleet: --attach {spec!r} is not host:port"
                "[/metrics_host:metrics_port]"
            )
        out.append((f"r{i}", addr, metrics or None))
    return out


def _spawn_replicas(args, n):
    """Spawn N ``serve --port 0 --metrics_port 0`` subprocesses and
    parse each head JSON line for its wire + metrics addresses.
    A replica that dies during startup, or prints no head line within
    :data:`STARTUP_TIMEOUT` seconds, surfaces its stderr as a structured
    error instead of a hang — a broken ``--resume`` checkpoint in a
    shared config must fail the fleet loudly.  Every spawned replica is
    killed before that error is raised."""
    env = dict(os.environ)
    if args.device == "cpu" and "OMP_NUM_THREADS" not in env:
        # CPU replicas share the host's cores: each torch's default
        # intra-op pool spans all of them, and N pools spinning at once
        # slow every replica's solves by orders of magnitude
        env["OMP_NUM_THREADS"] = str(max(1, (os.cpu_count() or 1) // n))
    procs = []
    replicas = []
    base = [
        sys.executable, "-m", "pydcop_tpu_torch", "serve",
        "--port", "0", "--metrics_port", "0",
        "--pad_policy", args.pad_policy,
        "--max_batch", str(args.max_batch),
        "--max_wait", str(args.max_wait),
    ]
    if args.device:
        base += ["--device", args.device]
    if args.session_checkpoint:
        base += ["--session_checkpoint", args.session_checkpoint]
    if args.flight_dump:
        base += ["--flight_dump", args.flight_dump]
    try:
        for i in range(n):
            proc = subprocess.Popen(
                base, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, env=env, text=True,
            )
            procs.append(proc)
    except BaseException:
        for p in procs:
            p.kill()
        raise
    for i, proc in enumerate(procs):
        line = _head_line(proc, STARTUP_TIMEOUT)
        if not line:
            for p in procs:
                p.kill()
            try:
                _, err = proc.communicate(timeout=10)
            except subprocess.TimeoutExpired:
                err = ""
            err = (err or "").strip()
            raise SystemExit(
                f"fleet: replica r{i} (pid {proc.pid}) died during "
                f"startup: {err.splitlines()[-1] if err else 'no output'}"
            )
        head = json.loads(line)
        replicas.append(
            (f"r{i}", head["serving"], head.get("metrics"))
        )
        # drain the pipes forever after: a replica must never block
        # on a full stderr buffer writing its drain-time stats line
        for stream in (proc.stdout, proc.stderr):
            t = threading.Thread(
                target=_drain, args=(stream,), daemon=True
            )
            t.start()
    return procs, replicas


def _head_line(proc, timeout: float) -> str:
    """The replica's first stdout line, or "" when it exits first or
    prints nothing within ``timeout`` seconds (a bounded wait)."""
    box: "queue.Queue[str]" = queue.Queue()
    reader = threading.Thread(
        target=lambda: box.put(proc.stdout.readline()), daemon=True
    )
    reader.start()
    try:
        return box.get(timeout=timeout)
    except queue.Empty:
        return ""


def _drain(stream) -> None:
    try:
        for _ in stream:
            pass
    except (OSError, ValueError):
        pass


def _wire_standbys(replicas, k):
    """Send each replica its ring-successor standby addresses (the
    ``standby`` wire op) — the replication chain the router's
    failover rule walks."""
    from pydcop_tpu_torch.engine.fleet import standby_map
    from pydcop_tpu_torch.engine.service import ServiceClient

    addr_of = {name: addr for name, addr, _ in replicas}
    smap = standby_map(list(addr_of), k=k)
    for name, succs in smap.items():
        with ServiceClient(addr_of[name], timeout=10.0) as cli:
            cli._call(
                "standby",
                standbys=[addr_of[s] for s in succs],
            )
    return smap


def run_cmd(args) -> int:
    from pydcop_tpu_torch.engine.fleet import FleetRouter, Replica
    from pydcop_tpu_torch.telemetry import get_metrics, session

    refuse_compile_cache(args)
    if args.resilience < 1:
        raise SystemExit("fleet: --resilience must be >= 1")

    plan = None
    if args.chaos:
        from pydcop_tpu_torch.faults import FaultPlan, FaultSpecError

        try:
            plan = FaultPlan.from_spec(args.chaos, args.chaos_seed)
        except FaultSpecError as e:
            raise SystemExit(f"fleet: {e}")
        # fleet accepts ONLY the fleet category; every other
        # category has its own injection layer and its own flag
        if plan.message_faults_configured or plan.crashes:
            raise SystemExit(
                "fleet: message/schedule chaos kinds inject at the "
                "agent message plane — use `pydcop_tpu run/agent "
                "--chaos` (docs/faults.md)"
            )
        if plan.device_faults_configured:
            raise SystemExit(
                "fleet: device chaos kinds inject at each replica's "
                "dispatch seam — use `pydcop_tpu serve --chaos` "
                "(docs/faults.md)"
            )
        if plan.wire_faults_configured:
            raise SystemExit(
                "fleet: wire chaos kinds inject in each replica's "
                "frame loop — use `pydcop_tpu serve --chaos` "
                "(docs/faults.md)"
            )
        if not plan.fleet_faults_configured:
            plan = None

    attach = _parse_attach(args.attach) if args.attach else None
    if plan is not None and attach is not None:
        raise SystemExit(
            "fleet: replica_kill needs spawned replicas (--replicas "
            "N) — the fleet does not own attached processes"
        )
    if attach is None and args.replicas < 1:
        raise SystemExit("fleet: --replicas must be >= 1")

    with session(args.trace, args.trace_format):
        procs = []
        router = None
        exporter = None
        killer = None
        prev_term = None
        try:
            if attach is not None:
                replicas = attach
            else:
                procs, replicas = _spawn_replicas(
                    args, args.replicas
                )
            _wire_standbys(replicas, args.resilience)
            router = FleetRouter(
                [Replica(*r) for r in replicas],
                host=args.host,
                port=args.port,
                health_interval=args.health_interval,
            )
            if args.metrics_port is not None:
                from pydcop_tpu_torch.telemetry.export import (
                    MetricsExporter,
                )

                exporter = MetricsExporter(
                    get_metrics().snapshot,
                    router.health,
                    host=args.host,
                    port=args.metrics_port,
                )
            if plan is not None:
                decision = plan.decide_replica_kill(len(replicas))
                if decision is not None:
                    delay, victim = decision
                    pid = procs[victim].pid

                    def _kill():
                        met = get_metrics()
                        if met.enabled:
                            met.inc("fleet.replica_killed")
                        try:
                            os.kill(pid, signal.SIGKILL)
                        except OSError:
                            pass

                    killer = threading.Timer(delay, _kill)
                    killer.daemon = True
                    killer.start()
            prev_term = signal.signal(
                signal.SIGTERM,
                lambda *_: router.request_shutdown(),
            )
            head = {
                "fleet": "%s:%d" % router.address,
                "pid": os.getpid(),
                "replicas": {
                    name: addr for name, addr, _ in replicas
                },
            }
            if exporter is not None:
                head["metrics"] = "%s:%d" % exporter.address
            print(json.dumps(head), flush=True)
            try:
                router.wait(args.timeout)
            except KeyboardInterrupt:
                pass
        finally:
            if killer is not None:
                killer.cancel()
            if router is not None:
                router.close()
            if exporter is not None:
                exporter.close()
            if prev_term is not None:
                signal.signal(signal.SIGTERM, prev_term)
            # graceful replica drain: TERM (the replicas' own drain
            # funnel writes checkpoints / final stats), then reap
            for proc in procs:
                if proc.poll() is None:
                    proc.terminate()
            for proc in procs:
                try:
                    proc.wait(timeout=15)
                except subprocess.TimeoutExpired:
                    proc.kill()
            if router is not None:
                stats = router.stats()
                print(
                    json.dumps({"fleet_stats": stats}, default=str),
                    file=sys.stderr,
                    flush=True,
                )
    return 0
