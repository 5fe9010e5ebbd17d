"""``serve`` — the continuous-batching solver service (port of
``pydcop_tpu/commands/serve.py``: the same flags, serving line and
stats line, plus ``--device``).

Starts a resident :class:`~pydcop_tpu_torch.engine.service.SolverService`
on the card (``--device cpu`` for the CPU) behind a TCP
:class:`~pydcop_tpu_torch.engine.service.ServiceServer` (the JAX
package's newline-JSON frames) and serves until a client sends
``shutdown``, the global ``-t/--timeout`` elapses, Ctrl-C, or SIGTERM.

Every exit path is a **graceful drain**: new admissions are rejected,
in-flight ticks finish and deliver, the final session checkpoint is
written (``--session_checkpoint``), and the final JSON stats report —
including the zeroed queue-depth gauge — is emitted on stderr.  A
restarted ``serve --resume`` replays the checkpointed sessions through
the :class:`~pydcop_tpu_torch.engine.incremental.IncrementalCompiler`, so
reconnecting clients' ``set_values`` follow-ups stay
``compile.incremental``-only.

Prints one JSON line ``{"serving": "host:port", "pid": N}`` once the
socket is bound (a parent process can parse it to find an ephemeral
``--port 0``).
"""

from __future__ import annotations

import json
import signal
import sys

from pydcop_tpu_torch.commands._common import (
    add_compile_cache_argument,
    add_supervisor_arguments,
    add_trace_arguments,
    refuse_compile_cache,
)


def set_parser(subparsers) -> None:
    p = subparsers.add_parser(
        "serve",
        help="run a resident continuous-batching solver service: an "
        "admission queue coalesces concurrent solve requests into "
        "shape buckets and dispatches merged groups per tick on warm "
        "compiled executables (docs/serving.md)",
    )
    p.add_argument(
        "--host", default="127.0.0.1",
        help="bind address (default 127.0.0.1 — loopback only)",
    )
    p.add_argument(
        "--port", type=int, default=9010,
        help="listen port (0 = ephemeral; the bound port is printed "
        "on the serving line)",
    )
    p.add_argument(
        "--pad_policy", default="pow2", metavar="POLICY",
        help="shape-bucketing policy applied to every request "
        "('pow2' / 'pow2:<floor>' / 'none'): what steers "
        "similarly-sized problems into shared executables and "
        "coalesced dispatches (docs/performance.md); default: pow2",
    )
    p.add_argument(
        "--max_batch", type=int, default=32, metavar="K",
        help="tick policy: dispatch as soon as K requests are "
        "pending (also the per-tick drain cap); default 32",
    )
    p.add_argument(
        "--max_wait", type=float, default=0.01, metavar="SECONDS",
        help="tick policy: never hold the oldest pending request "
        "longer than this before dispatching (the queue-wait bound "
        "behind the service's p99); default 0.01",
    )
    p.add_argument(
        "--instance_bucket", choices=["pow2", "none"], default="pow2",
        help="pad coalesced groups to power-of-two occupancy by "
        "repeating the last member, so group shapes stay few; "
        "default pow2",
    )
    add_compile_cache_argument(p)
    p.add_argument(
        "--device", default=None,
        help="'cpu' to serve on the CPU; default: the CUDA device (the "
        "command fails without one)",
    )
    p.add_argument(
        "--max_queue", type=int, default=1024, metavar="N",
        help="bounded admission queue: requests arriving at depth N "
        "are rejected immediately with status='shed' instead of "
        "growing the queue without limit; deadline-carrying requests "
        "the service already knows it cannot meet are shed too "
        "(docs/serving.md); default 1024",
    )
    p.add_argument(
        "--max_inflight", type=int, default=8, metavar="N",
        help="per-connection in-flight request cap (wire "
        "backpressure): a client pipelining past it is answered "
        "status='shed'; default 8",
    )
    p.add_argument(
        "--session_memo_bytes", type=int, default=64 << 20,
        metavar="BYTES",
        help="per-session byte bound of the subtree-fingerprint "
        "message memo behind exact-algorithm (dpop) session "
        "follow-ups: a set_values delta re-contracts only the dirty "
        "root-to-changed-constraint path; 0 disables memoization; "
        "default 64 MiB",
    )
    p.add_argument(
        "--session_checkpoint", default=None, metavar="PATH",
        help="write the final session checkpoint (pinned dcops, "
        "applied set_values deltas, per-session counters) to PATH on "
        "every exit path — SIGTERM/Ctrl-C/shutdown all drain "
        "gracefully first (docs/serving.md).  When PATH is a "
        "directory, a per-process file sessions-<port|pid>.json is "
        "derived inside it, so fleet replicas sharing one config "
        "never clobber each other's checkpoints",
    )
    p.add_argument(
        "--resume", action="store_true",
        help="replay the --session_checkpoint file at startup: "
        "restored sessions' set_values follow-ups stay "
        "compile.incremental-only, bit-identical to an undisturbed "
        "service.  A missing, truncated, or schema-drifted "
        "checkpoint fails with a structured error (exit, not a "
        "silently-empty service)",
    )
    p.add_argument(
        "--standby", action="append", default=None, metavar="ADDR",
        dest="standbys",
        help="stream every session's delta log to the replica at "
        "ADDR (host:port; repeatable for k-resilience) as it "
        "mutates, so a kill of THIS process resumes its sessions "
        "there compile.incremental-only — `pydcop_tpu fleet` wires "
        "these automatically from the hash ring (docs/serving.md)",
    )
    p.add_argument(
        "--metrics_port", type=int, default=None, metavar="PORT",
        help="serve GET /metrics (Prometheus text exposition of the "
        "full registry) and GET /healthz (queue depth, in-flight, "
        "drain state) on this port (0 = ephemeral; the bound port is "
        "printed on the serving line as \"metrics\"); poll it live "
        "with `pydcop_tpu top` (docs/observability.md)",
    )
    p.add_argument(
        "--flight_dump", default=None, metavar="PATH",
        help="dump the always-on flight-recorder ring (recent spans/"
        "events/counter deltas, bounded — no trace file needed) "
        "atomically to PATH whenever a request is shed or "
        "quarantined, a dispatch fails, or the service drains "
        "(SIGTERM included), the triggering request's trace id "
        "front and center; render with `pydcop_tpu flight-dump "
        "FILE` (docs/observability.md).  When PATH is a directory, "
        "a per-process file flight-<port|pid>.json is derived "
        "inside it (fleet replicas never clobber each other)",
    )
    p.add_argument(
        "--chaos", default=None, metavar="SPEC",
        help="inject deterministic DEVICE-layer faults into every "
        "dispatch (device_oom=W[:R], device_transient=P[:AFTER], "
        "nan_inject=P[:I]) and WIRE faults into the frame loop "
        "(conn_drop=P[:AFTER], slow_client=W, frame_corrupt=P[:AFTER] "
        "— docs/faults.md): a poisoned or OOM-ing request "
        "degrades/splits under the supervisor while its batchmates "
        "return bit-identical results; dropped/corrupted replies are "
        "replayed from the reply cache on idempotent retry.  The "
        "FLEET kind (replica_kill) is rejected here — it kills "
        "whole replicas, use `pydcop_tpu fleet --chaos`",
    )
    p.add_argument(
        "--chaos_seed", type=int, default=0,
        help="seed for the --chaos fault plan (determinism/replay)",
    )
    add_supervisor_arguments(p)
    add_trace_arguments(p)
    p.set_defaults(func=run_cmd)


def _per_process_path(
    path, prefix: str, port: int
):
    """Resolve a ``--session_checkpoint`` / ``--flight_dump`` target:
    when it is a DIRECTORY (exists as one, or is spelled with a
    trailing separator), derive ``<dir>/<prefix>-<suffix>.json`` with
    a per-process suffix — the bound port when one was requested
    (stable across restarts, so ``--resume`` finds it), else the pid.
    N fleet replicas sharing one config then never clobber each
    other's files."""
    import os

    if path is None:
        return None
    if os.path.isdir(path) or path.endswith(os.sep):
        suffix = str(port) if port else f"pid{os.getpid()}"
        return os.path.join(path, f"{prefix}-{suffix}.json")
    return path


def run_cmd(args) -> int:
    from pydcop_tpu_torch.device import NoCudaDeviceError
    from pydcop_tpu_torch.engine.service import ServiceServer, SolverService
    from pydcop_tpu_torch.telemetry import session

    refuse_compile_cache(args)

    session_checkpoint = _per_process_path(
        args.session_checkpoint, "sessions", args.port
    )
    flight_dump = _per_process_path(
        args.flight_dump, "flight", args.port
    )

    stats = None
    with session(args.trace, args.trace_format) as tel:
        try:
            service = SolverService(
                pad_policy=args.pad_policy,
                max_batch=args.max_batch,
                max_wait=args.max_wait,
                instance_bucket=args.instance_bucket,
                chaos=args.chaos,
                chaos_seed=args.chaos_seed,
                retry_budget=args.retry_budget,
                chunk_floor=args.chunk_floor,
                on_numeric_fault=args.on_numeric_fault,
                max_queue=args.max_queue,
                session_memo_bytes=args.session_memo_bytes,
                session_checkpoint=session_checkpoint,
                resume=args.resume,
                flight_dump=flight_dump,
                standbys=args.standbys,
                device=args.device,
            )
        except NoCudaDeviceError:
            # no card and no --device cpu: the entry point raises, as
            # solve and run do
            raise
        except ValueError as e:
            # flag/spec usage errors exit cleanly, like the sibling
            # commands — not as a raw traceback (ServiceError IS a
            # RuntimeError, so a bad --resume checkpoint is caught by
            # its own clause below)
            raise SystemExit(f"serve: {e}")
        except RuntimeError as e:
            raise SystemExit(f"serve: {e}")
        server = None
        exporter = None
        prev_term = None
        try:
            server = ServiceServer(
                service, host=args.host, port=args.port,
                max_inflight=args.max_inflight,
            )
            if args.metrics_port is not None:
                from pydcop_tpu_torch.telemetry.export import MetricsExporter

                srv = server

                def _health():
                    return {
                        **service.health(),
                        "inflight": srv.inflight(),
                    }

                exporter = MetricsExporter(
                    tel.metrics.snapshot,
                    _health,
                    host=args.host,
                    port=args.metrics_port,
                )
            import os

            # SIGTERM = "drain and go": the handler only flips the
            # shutdown event; this thread wakes from wait() and runs
            # the same graceful-drain path as a client `shutdown` op
            # or Ctrl-C
            prev_term = signal.signal(
                signal.SIGTERM,
                lambda *_: server.request_shutdown(),
            )
            head = {
                "serving": "%s:%d" % server.address,
                "pid": os.getpid(),
                "sessions_restored": service.stats()[
                    "sessions_restored"
                ],
            }
            if exporter is not None:
                head["metrics"] = "%s:%d" % exporter.address
            if session_checkpoint is not None:
                # the RESOLVED path (a directory target gets its
                # per-process suffix here) — the parent process /
                # test harness reads it back from this line
                head["session_checkpoint"] = session_checkpoint
            if flight_dump is not None:
                head["flight_dump"] = flight_dump
            print(json.dumps(head), flush=True)
            try:
                # the global -t/--timeout doubles as a serve
                # duration bound (handy for scripted benches/tests)
                server.wait(args.timeout)
            except KeyboardInterrupt:
                pass
        finally:
            # EVERY exit path funnels through the graceful drain and
            # emits the final stats line — an interrupted serve must
            # never vanish without flushing its aggregates (and its
            # session checkpoint, when configured).  Order matters
            # twice over: the service drains FIRST, while the wire
            # connections are still open, so queued requests' results
            # actually reach their clients ("finish and deliver") and
            # only then does the server tear the connections down;
            # and the SIGTERM handler stays installed UNTIL the drain
            # finishes, so a re-delivered TERM during it is absorbed
            # instead of killing the process mid-checkpoint.
            try:
                service.close()
            finally:
                try:
                    if server is not None:
                        server.close()
                finally:
                    if exporter is not None:
                        # last out: /healthz keeps answering
                        # "draining" for the whole graceful drain
                        # above, then the scrape endpoint goes away
                        exporter.close()
                    if prev_term is not None:
                        signal.signal(signal.SIGTERM, prev_term)
                    stats = service.stats()
                    print(
                        json.dumps({"stats": stats}, default=str),
                        file=sys.stderr,
                        flush=True,
                    )
    return 0
