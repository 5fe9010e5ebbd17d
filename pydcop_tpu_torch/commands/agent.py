"""``pydcop_tpu_torch agent`` (port of ``pydcop_tpu/commands/agent.py``;
reference: ``pydcop/commands/agent.py``).

Start one or more agent processes that register with an orchestrator,
receive their deployment, and run their placed computations over TCP
(``--runtime host``, ``infrastructure/hostnet.py``).  An accel agent
compiles its island on ``--device`` (default: the CUDA device).  With
several ``--names``, one OS subprocess is forked per agent (the
reference's multi-agent form).  ``--runtime spmd``, the JAX package's
default, is ROADMAP A15b.2 and raises ``NotImplementedError``.
"""

from __future__ import annotations

import json
import sys


def set_parser(subparsers) -> None:
    p = subparsers.add_parser(
        "agent",
        help="join an orchestrator-coordinated cross-process run",
    )
    p.add_argument(
        "--names", "-n", nargs="+", required=True,
        help="agent name(s); several names fork one process each",
    )
    p.add_argument(
        "--orchestrator", "-o", required=True, metavar="HOST:PORT",
        help="orchestrator management address",
    )
    p.add_argument(
        "--retry_for", type=float, default=30.0,
        help="seconds to keep retrying the initial connection",
    )
    p.add_argument(
        "--msg_log", default=None, metavar="FILE",
        help="(--runtime host) dump every delivered message's full "
        "content to FILE as JSON lines — the reference Messaging's "
        "per-message log; several --names get FILE.<agent> each",
    )
    p.add_argument(
        "--chaos", default=None, metavar="SPEC",
        help="(--runtime host) apply a local fault-injection plan to "
        "THIS agent's outbound message plane (overrides any plan the "
        "orchestrator ships; spec format: docs/faults.md)",
    )
    p.add_argument(
        "--chaos_seed", type=int, default=0,
        help="seed for the --chaos fault plan",
    )
    p.add_argument(
        "--runtime", choices=["spmd", "host"], default="spmd",
        help="must match the orchestrator's --runtime (host: "
        "message-driven computations over TCP; spmd, the sharded "
        "batched solve, is not ported yet: ROADMAP A15b.2)",
    )
    p.add_argument(
        "--device", default="cuda",
        help="where an accel agent's island compiles and steps: 'cuda' "
        "(default; the agent fails when there is none) or 'cpu'",
    )
    from pydcop_tpu_torch.commands._common import add_trace_arguments

    add_trace_arguments(p)
    p.set_defaults(func=run_cmd)


def run_cmd(args) -> int:
    if args.msg_log and args.runtime != "host":
        raise SystemExit(
            "--msg_log records delivered message contents — only the "
            "host runtime has per-message delivery (--runtime host); "
            "the spmd runtime runs the fused batched engine"
        )
    if args.chaos and args.runtime != "host":
        raise SystemExit(
            "--chaos injects message-plane faults — only the host "
            "runtime has a per-agent message plane (--runtime host)"
        )
    if args.chaos:
        from pydcop_tpu_torch.faults import FaultPlan, FaultSpecError

        try:
            plan = FaultPlan.from_spec(args.chaos, args.chaos_seed)
        except FaultSpecError as e:
            raise SystemExit(f"agent: {e}")
        if plan.wire_faults_configured:
            # a silently-inert clause would record the spec as
            # applied while injecting nothing
            raise SystemExit(
                "agent: wire-level chaos kinds (conn_drop/"
                "slow_client/frame_corrupt) inject at the solver "
                "service's frame loop — use `pydcop_tpu serve "
                "--chaos` (docs/serving.md)"
            )
        if plan.device_faults_configured:
            # same inert-clause rule for the device layer: a host
            # agent has no supervised device dispatch to inject into
            raise SystemExit(
                "agent: device-layer chaos kinds (device_oom/"
                "device_oom_bytes/device_transient/nan_inject) "
                "inject at the batched engine's supervised dispatch "
                "— use `solve`/`run --chaos` (docs/faults.md)"
            )
        if plan.fleet_faults_configured:
            raise SystemExit(
                "agent: fleet-level chaos kinds (replica_kill) act "
                "on a replicated serving fleet's processes — use "
                "`pydcop_tpu fleet --chaos` (docs/faults.md)"
            )
    if args.runtime != "host":
        raise NotImplementedError(
            "agent --runtime spmd (a sharded batched solve across agent "
            "processes) is not ported yet — see ROADMAP.md, A15b.2; use "
            "--runtime host"
        )
    if len(args.names) > 1:
        # one OS process per agent: fork real subprocesses
        import subprocess

        procs = [
            subprocess.Popen(
                [
                    sys.executable, "-m", "pydcop_tpu_torch", "agent",
                    "--names", name,
                    "--orchestrator", args.orchestrator,
                    "--retry_for", str(args.retry_for),
                    "--runtime", args.runtime,
                    "--device", args.device,
                ]
                + (
                    ["--msg_log", f"{args.msg_log}.{name}"]
                    if args.msg_log
                    else []
                )
                + (
                    [
                        "--chaos", args.chaos,
                        "--chaos_seed", str(args.chaos_seed),
                    ]
                    if args.chaos
                    else []
                )
                + (
                    [
                        "--trace", f"{args.trace}.{name}",
                        "--trace_format", args.trace_format,
                    ]
                    if args.trace
                    else []
                )
            )
            for name in args.names
        ]
        rc = 0
        for p in procs:
            rc = rc or p.wait()
        return rc

    # each agent process traces into its own file (the telemetry
    # session is process-local by design)
    from pydcop_tpu_torch.infrastructure.hostnet import run_host_agent
    from pydcop_tpu_torch.telemetry import session

    with session(args.trace, args.trace_format):
        result = run_host_agent(
            args.names[0], args.orchestrator,
            retry_for=args.retry_for,
            msg_log=args.msg_log,
            chaos=args.chaos, chaos_seed=args.chaos_seed,
            device=args.device,
        )
    print(json.dumps(result))
    return 0
