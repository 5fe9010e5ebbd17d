"""``pydcop_tpu_torch orchestrator`` (port of
``pydcop_tpu/commands/orchestrator.py``; reference:
``pydcop/commands/orchestrator.py``).

Start the management plane for a cross-process run: wait for
``--nb_agents`` agent processes to register on ``--port``, deploy the
problem + algorithm to them, and print the assembled JSON (same shape
as ``solve``).  ``--runtime spmd`` (the default): run the sharded SPMD
solve as rank 0 of a ``torch.distributed`` process group, one process
a shard (``infrastructure/orchestrator.py``), and cross-check every
agent's replicated result; ``--elastic`` re-forms the group on agent
death (``infrastructure/elastic.py``), ``--scenario`` replays a
scenario across the processes.  ``--runtime host``: run the
message-driven computations over TCP to quiescence
(``infrastructure/hostnet.py``).

Example (two terminals)::

    pydcop_tpu_torch orchestrator coloring.yaml -a maxsum --port 9500
    pydcop_tpu_torch agent --names a1 --orchestrator localhost:9500
"""

from __future__ import annotations

from pydcop_tpu_torch.commands._common import (
    add_collect_arguments,
    add_trace_arguments,
    parse_algo_params,
    write_metrics,
    write_result,
)
from pydcop_tpu_torch.telemetry import session as telemetry_session


def set_parser(subparsers) -> None:
    p = subparsers.add_parser(
        "orchestrator",
        help="serve a cross-process run: deploy to agents, solve as "
        "process 0, assemble the result",
    )
    p.add_argument("dcop_files", nargs="+", help="dcop yaml file(s)")
    p.add_argument("-a", "--algo", required=True, help="algorithm name")
    p.add_argument(
        "-p", "--algo_params", action="append", default=[],
        metavar="NAME:VALUE", help="algorithm parameter (repeatable)",
    )
    p.add_argument("--port", type=int, default=9500)
    p.add_argument(
        "--nb_agents", type=int, default=1,
        help="agent processes to wait for before starting",
    )
    p.add_argument(
        "--advertise_host", default="localhost",
        help="hostname agents should use to reach the process group's "
        "store (multi-host runs: this machine's address)",
    )
    p.add_argument("--rounds", type=int, default=200)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--chunk_size", type=int, default=64)
    p.add_argument(
        "--scenario", default=None, metavar="FILE",
        help="scenario yaml to replay across all processes (dynamic "
        "run: remove/add agents, set external values)",
    )
    p.add_argument(
        "--ktarget", type=int, default=0,
        help="replication level (k-resilience): scenario and elastic "
        "runs; --runtime host migrates a dead agent's computations to "
        "replica holders",
    )
    p.add_argument(
        "--heartbeat_timeout", type=float, default=120.0,
        help="seconds an agent may miss the chunk barrier before the "
        "run is failed; also every collective's timeout",
    )
    p.add_argument(
        "--first_barrier_min", type=float, default=None,
        help="--elastic: minimum budget (seconds) for the FIRST chunk "
        "barrier of an epoch, which also covers torch import, the YAML "
        "parse and the compile on every worker (default 600, or the "
        "PYDCOP_TPU_ELASTIC_FIRST_BARRIER_MIN env var)",
    )
    p.add_argument(
        "--abort_grace", type=float, default=5.0,
        help="seconds to wait for a clean unwind after a peer death "
        "before force-exiting a wedged process",
    )
    p.add_argument(
        "--uiport", type=int, default=None,
        help="serve a live observability feed on this port during "
        "the run (SSE /events + /state, see infrastructure/ui.py)",
    )
    p.add_argument(
        "--elastic", action="store_true",
        help="resilient runtime: survive agent death mid-solve by "
        "re-forming the process group on the survivors (dead agents' "
        "variables migrate to replicas with --ktarget, else freeze "
        "at their last value) — see infrastructure/elastic.py",
    )
    p.add_argument(
        "--register_timeout", type=float, default=120.0,
        help="seconds to wait for all --nb_agents registrations",
    )
    p.add_argument(
        "-d", "--distribution", default=None,
        help="--runtime host placement: a distribution strategy name "
        "(oneagent/adhoc/heur_comhost/...) computed over the "
        "registered agents, or a yaml file with a `distribution:` "
        "mapping (the `distribute --output` format); default "
        "round-robin",
    )
    p.add_argument(
        "--accel_agents", nargs="+", default=None, metavar="AGENT",
        help="--runtime host only: agent name(s) whose placed "
        "computations run as ONE compiled island on the agent "
        "process's --device behind per-node proxies — the "
        "heterogeneous strong-host deployment.  Requires island "
        "support in the algorithm (maxsum/amaxsum, the dsa family, "
        "mgm, dba, gdba)",
    )
    p.add_argument(
        "--chaos", default=None, metavar="SPEC",
        help="--runtime host only: ship a deterministic fault-"
        "injection plan to every agent's message plane (drop/dup/"
        "reorder/delay probabilities, timed partitions, crash "
        "schedules; spec format: docs/faults.md)",
    )
    p.add_argument(
        "--chaos_seed", type=int, default=0,
        help="seed for the --chaos fault plan (same seed => identical "
        "fault sequence, recorded in the result for replay)",
    )
    p.add_argument(
        "--grace_period", type=float, default=5.0,
        help="--runtime host: transient-fault grace window (seconds) "
        "— failed sends are retried with backoff for this long before "
        "a link is declared dead; a permanent message-plane failure "
        "then degrades the run to the anytime-best result "
        "(status=degraded) instead of failing it",
    )
    p.add_argument(
        "--runtime", choices=["spmd", "host"], default="spmd",
        help="spmd (default): the batched engine over a torch."
        "distributed process group, one process a shard, every process "
        "computing its shard of the problem in lockstep.  host: "
        "message-driven agents over TCP — each agent runs only its "
        "placed computations, exchanging simple_repr JSON messages "
        "(the reference's heterogeneous deployment; only accel agents "
        "need a device)",
    )
    p.add_argument(
        "--device", default=None,
        help="--runtime spmd: where this process's shard runs (--elastic:"
        " its worker's); --runtime host --ktarget: where a migration "
        "solves its reparation DCOP.  Default: the CUDA device (the run "
        "fails when there is none); 'cpu' only when asked for.  The "
        "agents take their own --device",
    )
    add_collect_arguments(p)
    add_trace_arguments(p)
    p.set_defaults(func=run_cmd)


def run_cmd(args) -> int:
    from pydcop_tpu_torch.dcop.yamldcop import load_dcop_from_file

    # pure argument validation FIRST — before any problem parsing
    if args.distribution and args.runtime != "host":
        raise SystemExit(
            "orchestrator: --distribution applies to --runtime host "
            "(the SPMD runtime shards the whole compiled problem; "
            "placement is the mesh layout)"
        )
    if args.accel_agents and args.runtime != "host":
        raise SystemExit(
            "orchestrator: --accel_agents applies to --runtime host "
            "(the SPMD runtime is all-accelerator already)"
        )
    if args.chaos and args.runtime != "host":
        raise SystemExit(
            "orchestrator: --chaos applies to --runtime host (the "
            "SPMD runtime has no per-agent message plane; use "
            "--elastic + real kills, or `run --chaos` for scripted "
            "crashes on the batched engine)"
        )
    if args.chaos:
        from pydcop_tpu_torch.faults import FaultPlan, FaultSpecError

        try:
            plan = FaultPlan.from_spec(args.chaos, args.chaos_seed)
        except FaultSpecError as e:
            raise SystemExit(f"orchestrator: {e}")
        if plan.wire_faults_configured:
            # a silently-inert clause would record the spec as
            # applied while injecting nothing
            raise SystemExit(
                "orchestrator: wire-level chaos kinds (conn_drop/"
                "slow_client/frame_corrupt) inject at the solver "
                "service's frame loop — use `pydcop_tpu serve "
                "--chaos` (docs/serving.md)"
            )
        if plan.device_faults_configured:
            # same inert-clause rule for the device layer: the host
            # orchestrator runtime has no supervised device dispatch
            raise SystemExit(
                "orchestrator: device-layer chaos kinds (device_oom/"
                "device_oom_bytes/device_transient/nan_inject) "
                "inject at the batched engine's supervised dispatch "
                "— use `solve`/`run --chaos` (docs/faults.md)"
            )
        if plan.fleet_faults_configured:
            raise SystemExit(
                "orchestrator: fleet-level chaos kinds "
                "(replica_kill) act on a replicated serving fleet's "
                "processes — use `pydcop_tpu fleet --chaos` "
                "(docs/faults.md)"
            )
    if args.runtime == "spmd" and not args.elastic:
        # rank 0 runs here: no card fails before the problem is parsed
        from pydcop_tpu_torch.parallel.distributed import rank_device

        rank_device(args.device, 0)
    placement = None
    dist_name = None
    if args.distribution:
        import os

        if os.path.exists(args.distribution):
            import yaml

            with open(args.distribution) as f:
                spec = yaml.safe_load(f)
            if (
                not isinstance(spec, dict)
                or "distribution" not in spec
                or not isinstance(spec["distribution"], dict)
            ):
                raise SystemExit(
                    f"orchestrator: {args.distribution} is not a "
                    "placement file (expected a yaml `distribution:` "
                    "mapping of agent -> computation names, the "
                    "`distribute --output` format)"
                )
            placement = spec["distribution"]
            bad = {
                a: v
                for a, v in placement.items()
                if not isinstance(v, list)
                or not all(isinstance(c, str) for c in v)
            }
            if bad:
                raise SystemExit(
                    "orchestrator: placement entries must be lists of "
                    f"computation names; got {bad}"
                )
        else:
            from pydcop_tpu_torch.distribution import (
                load_distribution_module,
            )

            try:  # fail fast on a typo'd name, not after registration
                load_distribution_module(args.distribution)
            except Exception as e:
                raise SystemExit(f"orchestrator: {e}")
            dist_name = args.distribution

    # load (merging multi-file specs); the SPMD runtimes re-dump ONE
    # self-contained yaml text for their deploy messages below — the
    # host runtime serializes internally
    dcop = load_dcop_from_file(
        args.dcop_files if len(args.dcop_files) > 1 else args.dcop_files[0]
    )

    scenario_yaml = None
    if args.scenario:
        with open(args.scenario) as f:
            scenario_yaml = f.read()

    if args.runtime == "host":
        return _run_host(args, dcop, dist_name, placement)

    from pydcop_tpu_torch.dcop.yamldcop import dcop_yaml as dump_yaml

    dcop_yaml = dump_yaml(dcop)

    if args.elastic:
        from pydcop_tpu_torch.infrastructure.elastic import (
            run_elastic_orchestrator,
        )

        if args.scenario:
            raise SystemExit(
                "orchestrator: --elastic and --scenario are separate "
                "dynamics modes (reactive vs scripted); use one"
            )
        with telemetry_session(args.trace, args.trace_format) as tel:
            result = run_elastic_orchestrator(
                dcop_yaml,
                args.algo,
                parse_algo_params(args.algo_params),
                port=args.port,
                nb_agents=args.nb_agents,
                rounds=args.rounds,
                seed=args.seed,
                chunk_size=args.chunk_size,
                timeout=args.timeout,
                advertise_host=args.advertise_host,
                heartbeat_timeout=args.heartbeat_timeout,
                k_target=args.ktarget,
                ui_port=args.uiport,
                abort_grace=args.abort_grace,
                first_barrier_min=args.first_barrier_min,
                device="cuda" if args.device is None else args.device,
            )
            result["telemetry"] = tel.summary()
        write_result(args, result)
        return 0

    from pydcop_tpu_torch.infrastructure.orchestrator import run_orchestrator

    with telemetry_session(args.trace, args.trace_format) as tel:
        result = run_orchestrator(
            dcop_yaml,
            args.algo,
            parse_algo_params(args.algo_params),
            port=args.port,
            nb_agents=args.nb_agents,
            rounds=args.rounds,
            seed=args.seed,
            chunk_size=args.chunk_size,
            timeout=args.timeout,
            advertise_host=args.advertise_host,
            heartbeat_timeout=args.heartbeat_timeout,
            abort_grace=args.abort_grace,
            scenario_yaml=scenario_yaml,
            k_target=args.ktarget,
            ui_port=args.uiport,
            device=args.device,
        )
        result["telemetry"] = tel.summary()
    _write(args, result)
    return 0


def _write(args, result) -> None:
    write_metrics(args, result)
    result.pop("cost_trace", None)  # keep the printed JSON compact
    result.pop("trace_subsampled", None)
    result.pop("trace_msgs", None)
    write_result(args, result)


def _run_host(args, dcop, dist_name, placement) -> int:
    """``--runtime host``: the message-driven computations over TCP."""
    from pydcop_tpu_torch.infrastructure.hostnet import (
        PlacementError,
        run_host_orchestrator,
    )

    if args.elastic or args.scenario:
        raise SystemExit(
            "orchestrator: --runtime host does not support "
            "--elastic/--scenario (the SPMD runtime carries the "
            "scripted-dynamics modes); --ktarget IS supported: "
            "replica-based migration on agent death"
        )
    # algo/params usage errors fail fast and cleanly, before any
    # agent registration
    from pydcop_tpu_torch.algorithms import (
        load_algorithm_module,
        prepare_algo_params,
        require_island_support,
    )

    try:
        _mod = load_algorithm_module(args.algo)
        prepare_algo_params(
            parse_algo_params(args.algo_params), _mod.algo_params
        )
        if not hasattr(_mod, "build_computation"):
            raise ValueError(
                f"{args.algo} has no host (message-driven) "
                "implementation — use the SPMD runtime for "
                "batched-only algorithms"
            )
        if args.accel_agents:
            require_island_support(_mod, args.algo)
    except ValueError as e:
        raise SystemExit(f"orchestrator: {e}")
    try:
        with telemetry_session(args.trace, args.trace_format) as tel:
            result = run_host_orchestrator(
                dcop,
                args.algo,
                parse_algo_params(args.algo_params),
                nb_agents=args.nb_agents,
                port=args.port,
                rounds=args.rounds,
                timeout=args.timeout,
                seed=args.seed,
                register_timeout=args.register_timeout,
                distribution=dist_name,
                placement=placement,
                ui_port=args.uiport,
                accel_agents=args.accel_agents,
                k_target=args.ktarget or 0,
                chaos=args.chaos,
                chaos_seed=args.chaos_seed,
                grace_period=args.grace_period,
                device=args.device,
            )
            result["telemetry"] = tel.summary()
    except PlacementError as e:  # usage errors: clean exit
        raise SystemExit(f"orchestrator: {e}")
    _write(args, result)
    return 0
