"""``pydcop_tpu_torch run`` (port of ``pydcop_tpu/commands/run.py``;
reference: ``pydcop/commands/run.py``).

Solve a DCOP while playing a scenario of dynamic events (agent
departures/arrivals, external-variable changes), with optional
k-resilient replication + repair (``engine/dynamic.py``), on the CUDA
device or, with ``--device cpu``, on the CPU.  Prints the result JSON
including the event log, in the JAX command's shape with its
``telemetry`` block; ``--run_metrics``/``--end_metrics`` write its
metric CSVs.
"""

from __future__ import annotations

from pydcop_tpu_torch.commands._common import (
    add_compile_cache_argument,
    add_collect_arguments,
    add_supervisor_arguments,
    add_trace_arguments,
    parse_algo_params,
    refuse_compile_cache,
    write_metrics,
    write_result,
)


def set_parser(subparsers) -> None:
    p = subparsers.add_parser(
        "run", help="solve a DCOP while playing a dynamic scenario"
    )
    p.add_argument("dcop_files", nargs="+", help="dcop yaml file(s)")
    p.add_argument("-a", "--algo", required=True, help="algorithm name")
    p.add_argument(
        "-p", "--algo_params", action="append", default=[],
        metavar="NAME:VALUE", help="algorithm parameter (repeatable)",
    )
    p.add_argument(
        "-s", "--scenario", default=None,
        help="scenario yaml file (or use --chaos crash schedules)",
    )
    p.add_argument(
        "--chaos", default=None, metavar="SPEC",
        help="inject deterministic faults: crash=AGENT@T clauses "
        "generate the scenario — each becomes a deterministic "
        "remove_agent event at T seconds — and the device-layer kinds "
        "(device_oom, device_transient, nan_inject) inject at the "
        "supervised device dispatch of every segment "
        "(engine/supervisor.py); message-plane fault clauses are "
        "rejected here (the batched engine has no message plane).  "
        "Device-only specs compose with -s/--scenario",
    )
    p.add_argument(
        "--chaos_seed", type=int, default=0,
        help="seed recorded with the --chaos plan (crash schedules "
        "are explicit, so this only tags the replay record)",
    )
    p.add_argument(
        "-d", "--distribution", default="oneagent",
        help="distribution strategy for the initial placement",
    )
    p.add_argument(
        "-k", "--ktarget", type=int, default=1,
        help="replicas per computation (0 disables replication)",
    )
    p.add_argument(
        "--rounds_per_second", type=float, default=20.0,
        help="scenario delay seconds → engine rounds scale",
    )
    p.add_argument(
        "--final_rounds", type=int, default=100,
        help="rounds before the first and after the last event",
    )
    p.add_argument(
        "--repair_algo", default="mgm",
        help="algorithm solving the reparation DCOP",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--pad_policy", default="none", metavar="POLICY",
        help="bucket each segment's compiled shapes ('pow2' or "
        "'pow2:<floor>'); default: none",
    )
    add_compile_cache_argument(p)
    p.add_argument(
        "--device", default=None,
        help="'cpu' to run on the CPU; default: the CUDA device (the "
        "command fails when there is none)",
    )
    add_supervisor_arguments(p)
    add_collect_arguments(p)
    add_trace_arguments(p)
    p.set_defaults(func=run_cmd)


def run_cmd(args) -> int:
    from pydcop_tpu_torch.dcop.yamldcop import (
        load_dcop_from_file,
        load_scenario_from_file,
    )
    from pydcop_tpu_torch.distribution import ImpossibleDistributionException
    from pydcop_tpu_torch.engine.dynamic import run_dynamic

    refuse_compile_cache(args)
    dcop = load_dcop_from_file(
        args.dcop_files if len(args.dcop_files) > 1 else args.dcop_files[0]
    )
    chaos_plan = None
    if args.chaos:
        from pydcop_tpu_torch.dcop.scenario import (
            EventAction,
            Scenario,
            ScenarioEvent,
        )
        from pydcop_tpu_torch.faults import FaultPlan, FaultSpecError

        try:
            chaos_plan = FaultPlan.from_spec(args.chaos, args.chaos_seed)
        except FaultSpecError as e:
            raise SystemExit(f"run: {e}")
        if chaos_plan.message_faults_configured:
            raise SystemExit(
                "run: the batched dynamic engine has no message plane "
                "— only crash=AGENT@T clauses and the device-layer "
                "kinds (device_oom/device_transient/nan_inject) apply "
                "here; message-plane faults (drop/dup/reorder/delay/"
                "partition) need the host runtimes (solve --mode "
                "thread/process, orchestrator --runtime host)"
            )
        if chaos_plan.wire_faults_configured:
            raise SystemExit(
                "run: wire-level chaos kinds (conn_drop/slow_client/"
                "frame_corrupt) inject at the solver service's frame "
                "loop — use `pydcop_tpu serve --chaos` "
                "(docs/serving.md)"
            )
        if chaos_plan.fleet_faults_configured:
            raise SystemExit(
                "run: fleet-level chaos kinds (replica_kill) act on "
                "a replicated serving fleet's processes — use "
                "`pydcop_tpu fleet --chaos` (docs/faults.md)"
            )
        if not chaos_plan.crashes and not chaos_plan.device_faults_configured:
            raise SystemExit(
                "run: --chaos without crash=AGENT@T or device-layer "
                "clauses schedules nothing for the batched engine"
            )
        if chaos_plan.crashes and args.scenario:
            raise SystemExit(
                "run: --scenario and --chaos crash schedules are two "
                "sources of scripted dynamics; use one (device-only "
                "--chaos specs DO compose with --scenario)"
            )
        unknown = set(chaos_plan.crashes) - set(dcop.agents)
        if unknown:
            raise SystemExit(
                f"run: --chaos crashes unknown agent(s) "
                f"{sorted(unknown)} (declared: {sorted(dcop.agents)})"
            )
        # crash schedules → deterministic remove_agent events, in
        # (time, name) order so equal-time crashes replay identically
        events = []
        t_prev = 0.0
        for name, t in sorted(
            chaos_plan.crashes.items(), key=lambda kv: (kv[1], kv[0])
        ):
            if t > t_prev:
                events.append(ScenarioEvent(delay=t - t_prev))
                t_prev = t
            events.append(
                ScenarioEvent(
                    id=f"chaos_crash_{name}",
                    actions=[EventAction("remove_agent", agent=name)],
                )
            )
        if chaos_plan.crashes:
            scenario = Scenario(events)
        elif args.scenario:
            scenario = load_scenario_from_file(args.scenario)
        else:
            raise SystemExit(
                "run: a dynamics source is required — -s/--scenario "
                "FILE or --chaos 'crash=AGENT@T,...' (a device-only "
                "--chaos spec injects faults but scripts no dynamics)"
            )
    elif args.scenario:
        scenario = load_scenario_from_file(args.scenario)
    else:
        raise SystemExit(
            "run: a dynamics source is required — -s/--scenario FILE "
            "or --chaos 'crash=AGENT@T,...'"
        )
    params = parse_algo_params(args.algo_params)
    from pydcop_tpu_torch.engine.supervisor import (
        make_supervisor,
        supervision,
    )
    from pydcop_tpu_torch.telemetry import session

    # per-call supervisor: retry/degradation knobs + the plan's
    # device-layer fault kinds inject at every segment's supervised
    # chunk dispatches (engine/supervisor.py)
    sup = make_supervisor(
        retry_budget=args.retry_budget,
        chunk_floor=args.chunk_floor,
        on_numeric_fault=args.on_numeric_fault,
        plan=(
            chaos_plan
            if chaos_plan is not None
            and chaos_plan.device_faults_configured
            else None
        ),
    )

    try:
        with session(args.trace, args.trace_format) as tel, supervision(sup):
            result = run_dynamic(
                dcop,
                args.algo,
                params,
                scenario=scenario,
                distribution=args.distribution,
                k_target=args.ktarget,
                rounds_per_second=args.rounds_per_second,
                final_rounds=args.final_rounds,
                seed=args.seed,
                timeout=args.timeout,
                repair_algo=args.repair_algo,
                pad_policy=args.pad_policy,
                device=args.device,
            )
            result["telemetry"] = tel.summary()
    except (ValueError, ImpossibleDistributionException) as e:
        raise SystemExit(f"run: {e}")
    if chaos_plan is not None:  # replay record: spec + seed
        result["chaos"] = chaos_plan.to_meta()
    write_metrics(args, result)
    result.pop("cost_trace", None)
    result.pop("trace_subsampled", None)
    result.pop("trace_msgs", None)
    return write_result(args, result)
