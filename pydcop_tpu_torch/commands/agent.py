"""``pydcop_tpu_torch agent`` (port of ``pydcop_tpu/commands/agent.py``;
reference: ``pydcop/commands/agent.py``).

Start one or more agent processes that register with an orchestrator
and receive their deployment.  ``--runtime spmd`` (the default): the
process joins the orchestrator's ``torch.distributed`` process group
and runs its shard of the sharded solve on ``--device``
(``infrastructure/orchestrator.py:run_agent``), or, on an elastic
deploy, supervises one worker process per epoch
(``infrastructure/elastic.py``).  ``--runtime host``: run the agent's
placed computations over TCP (``infrastructure/hostnet.py``); an accel
agent compiles its island on ``--device``.  ``--device`` defaults to
the CUDA device (the agent fails when there is none).  With several
``--names``, one OS subprocess is forked per agent (the reference's
multi-agent form).
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
        help="must match the orchestrator's --runtime (spmd: a shard "
        "of the sharded batched solve; host: message-driven "
        "computations over TCP)",
    )
    p.add_argument(
        "--device", default="cuda",
        help="spmd: where this process's shard (or, elastic, its "
        "workers' shards) runs — 'cuda' is the card process-id modulo "
        "the card count; host: where an accel agent's island compiles "
        "and steps.  'cuda' (default; the agent fails when there is "
        "none), 'cuda:<k>' or 'cpu'",
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
    from pydcop_tpu_torch.telemetry import session

    if args.runtime == "host":
        from pydcop_tpu_torch.infrastructure.hostnet import run_host_agent

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

    from pydcop_tpu_torch.infrastructure.orchestrator import run_agent

    with session(args.trace, args.trace_format):
        result = run_agent(
            args.orchestrator, args.names[0], retry_for=args.retry_for,
            device=args.device,
        )
    print(
        json.dumps(
            {
                "agent": args.names[0],
                # elastic-supervisor results carry no cost/cycle (the
                # orchestrator assembles those); static runs do
                "cost": result.get("cost"),
                "cycle": result.get("cycle"),
                "status": result.get("status"),
                "deploys": result.get("deploys"),
            }
        )
    )
    return 0
