"""``pydcop_tpu_torch solve`` — port of ``pydcop_tpu/commands/solve.py``.

One-shot solve of a DCOP yaml on the batched engine, or with ``-a dpop``
on the exact path (``-p util_device:always``, ``-p util_batch:node``,
``--pad_policy pow2``, ``--table_dtype bf16``, ``--table_format sparse``,
``--max_util_bytes N``, …) and with ``-a syncbb`` on the host; prints the
result as JSON in the shape
``python -m pydcop_tpu solve`` prints, ``telemetry`` block included;
``--trace FILE`` writes the run's trace.  ``--restarts K`` runs K
restarts and reports the best; ``--checkpoint FILE`` saves the batched
engine's run state every ``--checkpoint_every`` chunks and ``--resume``
continues from it; ``--chaos SPEC --chaos_seed N`` injects the
device-layer fault kinds at the supervised dispatch, with the
``--retry_budget``/``--chunk_floor``/``--on_numeric_fault`` knobs;
``--collect_on``/``--period``/``--run_metrics``/``--end_metrics`` write
the JAX package's metric CSVs from the run's cost trace; ``--many``
solves each file as its own instance through ``api.solve_many`` and
prints a JSON array (without the ``telemetry`` blocks, as the JAX
package prints it).  ``--profile DIR`` writes a ``torch.profiler``
Chrome trace of the single solve into DIR (:func:`profile`);
``--compile_cache`` takes only its default (the port compiles no XLA
programs).  ``-m sim|thread|process`` runs the host message-driven
runtime (``-m tpu``, the default, is the batched engine; ``process``
forks ``--nb_agents`` agent processes over TCP), with ``-d`` placing the
computations, ``--accel_agents A ...`` hosting those agents' subgraphs
as compiled islands on ``--device``, ``--msg_log FILE`` logging every
delivered message and, in thread and process mode, message-plane
``--chaos``.  ``--uiport N`` serves the live feed of a batched or
process run.
"""

from __future__ import annotations

import contextlib

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
        "solve",
        help="solve a static DCOP on the batched engine, or exactly "
        "with dpop or syncbb",
    )
    p.add_argument("dcop_files", nargs="+", help="dcop yaml file(s)")
    p.add_argument("-a", "--algo", required=True, help="algorithm name")
    p.add_argument(
        "-p", "--algo_params", action="append", default=[],
        metavar="NAME:VALUE", help="algorithm parameter (repeatable)",
    )
    p.add_argument(
        "-d", "--distribution", default=None,
        help="distribution strategy name or `distribute --output` yaml "
        "file: shapes the host modes' placement (thread agent grouping, "
        "process-per-agent, island subgraphs); the batched engine solves "
        "regardless of placement",
    )
    p.add_argument(
        "-m", "--mode", choices=["thread", "sim", "process", "tpu"],
        default="tpu",
        help="execution mode: tpu = batched engine (default, on the "
        "card); thread = host thread-per-agent runtime; sim = "
        "deterministic async event loop; process = one local OS process "
        "per agent over the TCP host runtime (the reference's "
        "run_local_process_dcop)",
    )
    p.add_argument(
        "--nb_agents", type=int, default=None,
        help="process count for --mode process (default: one per "
        "declared agent, capped at the CPU count)",
    )
    p.add_argument(
        "--accel_agents", nargs="+", default=None, metavar="NAME",
        help="(thread/sim/process modes) agents whose placed subgraph "
        "runs as ONE compiled island on --device instead of "
        "per-computation host code (maxsum/amaxsum, the dsa family, "
        "mgm, dba, gdba)",
    )
    p.add_argument(
        "--msg_log", default=None, metavar="FILE",
        help="(thread/sim/process modes) dump every delivered message's "
        "full content to FILE as JSON lines (process mode writes "
        "FILE.<agent> per agent)",
    )
    p.add_argument(
        "--uiport", type=int, default=None,
        help="serve a live observability feed on this port while solving "
        "(SSE /events + /state + built-in page, see "
        "infrastructure/ui.py)",
    )
    p.add_argument("--rounds", type=int, default=200, help="round budget")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--restarts", type=int, default=1,
        help="run this many independent solver instances batched in one "
        "device program and report the best — parallel restarts",
    )
    p.add_argument(
        "--many", action="store_true",
        help="treat each DCOP file as a separate instance and solve them "
        "together (api.solve_many): same-shaped instances run as one "
        "group, dpop instances as one merged UTIL sweep; pass "
        "--pad_policy pow2 so similarly-sized files share a shape.  "
        "Prints a JSON array of per-instance results",
    )
    p.add_argument(
        "--convergence_chunks", type=int, default=0,
        help="stop after N unchanged chunks (0 = run all rounds)",
    )
    p.add_argument(
        "--checkpoint", default=None,
        help="write the run state to this .npz file as the run proceeds",
    )
    p.add_argument(
        "--checkpoint_every", type=int, default=1,
        help="chunks between checkpoint writes",
    )
    p.add_argument(
        "--resume", action="store_true",
        help="restore --checkpoint (if present) and continue the run",
    )
    p.add_argument(
        "--profile", default=None, metavar="DIR",
        help="capture a torch.profiler trace of the solve (host and, on "
        "the card, CUDA activity) into DIR as a Chrome trace (inspect "
        "with Perfetto, chrome://tracing or TensorBoard)",
    )
    add_compile_cache_argument(p)
    p.add_argument(
        "--pad_policy", default="none", metavar="POLICY",
        help="bucket the compiled problem's shapes on the pow-2 lattice "
        "('pow2' or 'pow2:<floor>'), so similarly-sized problems share "
        "one shape; for dpop it buckets the UTIL level dispatches "
        "instead (results bit-identical); default: none",
    )
    p.add_argument(
        "--device", default=None,
        help="'cpu' to run on the CPU; default: the CUDA device (the "
        "command fails when there is none)",
    )
    p.add_argument(
        "--max_util_bytes", type=int, default=None, metavar="N",
        help="(dpop) cap every UTIL table at N device bytes: the "
        "memory-bounded planner (ops/membound.py) conditions a cut set "
        "whose assignments ride the level-pack stack as extra lanes — "
        "exact results, a device OOM re-plans at half the budget, and "
        "the result carries a 'membound' block",
    )
    p.add_argument(
        "--bnb", choices=["auto", "on", "off"], default=None,
        help="branch-and-bound pruned contraction kernels (dpop, maxsum): "
        "'auto' (the algorithm's default) prunes dispatches large enough "
        "to pay, 'on' every one, 'off' none — results bit-identical",
    )
    p.add_argument(
        "--table_dtype", choices=["f32", "bf16", "int8"], default=None,
        help="(dpop) storage precision of the device UTIL parts: 'bf16' "
        "halves and 'int8' quarters the bytes shipped while the join "
        "stays f32 and the certificate repairs uncertain cells on the "
        "host — results bit-identical to f32",
    )
    p.add_argument(
        "--table_format", choices=["dense", "sparse"], default=None,
        help="(dpop) storage layout of the device UTIL parts: 'sparse' "
        "COO-packs the feasible tuples of hard-constraint-dominated "
        "tables and joins them by gather/segment reduce — results "
        "bit-identical to dense",
    )
    p.add_argument(
        "--chaos", default=None, metavar="SPEC",
        help="inject deterministic faults (same --chaos_seed => "
        "identical fault sequence).  thread/process modes: message-plane "
        "kinds — drop/dup/reorder/delay probabilities, timed partitions, "
        "crash schedules.  tpu "
        "mode (incl. --many): device-layer kinds — device_oom=W[:R], "
        "device_transient=P[:AFTER], nan_inject=P[:I] — injected at the "
        "supervised device dispatch (engine/supervisor.py)",
    )
    p.add_argument(
        "--chaos_seed", type=int, default=0,
        help="seed for the --chaos fault plan (determinism/replay)",
    )
    add_supervisor_arguments(p)
    add_collect_arguments(p)
    add_trace_arguments(p)
    p.set_defaults(func=run_cmd)


@contextlib.contextmanager
def profile(directory: str, device):
    """Record a ``torch.profiler`` trace of the enclosed work into
    ``directory`` (one Chrome trace file, written through
    ``tensorboard_trace_handler``): host activity, and CUDA activity
    when ``device`` is a CUDA device.  The trace is written when the
    block exits, also when it raises: a profile of a failing run is
    exactly when you want the data."""
    import torch
    from torch.profiler import (
        ProfilerActivity,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=tensorboard_trace_handler(directory),
    ):
        yield


def run_cmd(args) -> int:
    from pydcop_tpu_torch.api import solve, solve_many

    refuse_compile_cache(args)
    params = parse_algo_params(args.algo_params)
    if args.bnb is not None:
        # algo params (dpop declares them): the flags are the
        # discoverable spellings
        params = {**params, "bnb": args.bnb}
    if args.table_dtype is not None:
        params = {**params, "table_dtype": args.table_dtype}
    if args.table_format is not None:
        params = {**params, "table_format": args.table_format}
    sup_kw = dict(
        chaos=args.chaos, chaos_seed=args.chaos_seed,
        retry_budget=args.retry_budget, chunk_floor=args.chunk_floor,
        on_numeric_fault=args.on_numeric_fault,
    )
    if args.many:
        if args.mode != "tpu":
            raise SystemExit(
                "--many batches instances on the batched engine; "
                f"--mode {args.mode} does not apply"
            )
        for flag, name in (
            (args.checkpoint, "--checkpoint"),
            (args.resume, "--resume"),
            (args.uiport, "--uiport"),
            (args.msg_log, "--msg_log"),
            (args.accel_agents, "--accel_agents"),
            (args.distribution, "--distribution"),
            (args.nb_agents, "--nb_agents"),
            (args.profile, "--profile"),
        ):
            if flag:
                raise SystemExit(
                    f"{name} is a single-run option; it does not compose "
                    "with --many (solve the instances individually for it)"
                )
        if args.max_util_bytes is not None:
            # solve_many takes it through the per-algorithm params
            params = {**params, "max_util_bytes": args.max_util_bytes}
        results = solve_many(
            list(args.dcop_files),
            args.algo,
            params,
            rounds=args.rounds,
            timeout=args.timeout,
            seed=args.seed,
            convergence_chunks=args.convergence_chunks,
            n_restarts=args.restarts,
            pad_policy=args.pad_policy,
            device=args.device,
            trace=args.trace,
            trace_format=args.trace_format,
            **sup_kw,
        )
        for r in results:
            r.pop("cost_trace", None)  # keep the printed JSON compact
            r.pop("telemetry", None)
        return write_result(args, results)
    profiling = contextlib.nullcontext()
    if args.profile:
        from pydcop_tpu_torch.device import resolve_device

        profiling = profile(args.profile, resolve_device(args.device))
    with profiling:
        result = solve(
            args.dcop_files if len(args.dcop_files) > 1
            else args.dcop_files[0],
            args.algo,
            params,
            rounds=args.rounds,
            timeout=args.timeout,
            seed=args.seed,
            n_restarts=args.restarts,
            convergence_chunks=args.convergence_chunks,
            checkpoint_path=args.checkpoint,
            checkpoint_every=args.checkpoint_every,
            resume=args.resume,
            mode="batched" if args.mode == "tpu" else args.mode,
            ui_port=args.uiport,
            nb_agents=args.nb_agents,
            msg_log=args.msg_log,
            accel_agents=args.accel_agents,
            distribution=args.distribution,
            pad_policy=args.pad_policy,
            device=args.device,
            trace=args.trace,
            trace_format=args.trace_format,
            max_util_bytes=args.max_util_bytes,
            **sup_kw,
        )
    write_metrics(args, result)
    result.pop("cost_trace", None)  # keep the printed JSON compact
    result.pop("trace_subsampled", None)
    result.pop("trace_msgs", None)
    return write_result(args, result)
