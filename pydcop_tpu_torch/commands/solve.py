"""``pydcop_tpu_torch solve`` — the batched-mode subset of
``pydcop_tpu/commands/solve.py``, with DPOP's exact host path.

One-shot solve of a DCOP yaml on the batched engine, or with ``-a dpop``
on the exact path (``-p util_device:always``, ``-p util_batch:node``,
``--pad_policy pow2``, …); prints the result as JSON in the shape
``python -m pydcop_tpu solve`` prints, ``telemetry`` block included;
``--trace FILE`` writes the run's trace.  ``--restarts K`` runs K
restarts and reports the best; ``--many`` solves each file as its own
instance through ``api.solve_many`` and prints a JSON array (without
the ``telemetry`` blocks, as the JAX package prints it).
"""

from __future__ import annotations

from typing import Dict, List

from pydcop_tpu_torch.commands._common import (
    add_trace_arguments,
    write_result,
)


def parse_algo_params(items: List[str]) -> Dict[str, str]:
    """Parse repeated ``name:value`` CLI parameters."""
    out: Dict[str, str] = {}
    for item in items:
        if ":" not in item:
            raise SystemExit(
                f"--algo_params expects name:value, got {item!r}"
            )
        name, value = item.split(":", 1)
        out[name.strip()] = value.strip()
    return out


def set_parser(subparsers) -> None:
    p = subparsers.add_parser(
        "solve",
        help="solve a static DCOP on the batched engine, or exactly "
        "with dpop",
    )
    p.add_argument("dcop_files", nargs="+", help="dcop yaml file(s)")
    p.add_argument("-a", "--algo", required=True, help="algorithm name")
    p.add_argument(
        "-p", "--algo_params", action="append", default=[],
        metavar="NAME:VALUE", help="algorithm parameter (repeatable)",
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
        "-t", "--timeout", type=float, default=None,
        help="wall-clock timeout (seconds)",
    )
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
        "--output", type=str, default=None,
        help="write the result JSON to this file as well as stdout",
    )
    add_trace_arguments(p)
    p.set_defaults(func=run_cmd)


def run_cmd(args) -> int:
    from pydcop_tpu_torch.api import solve, solve_many

    if args.many:
        results = solve_many(
            list(args.dcop_files),
            args.algo,
            parse_algo_params(args.algo_params),
            rounds=args.rounds,
            timeout=args.timeout,
            seed=args.seed,
            convergence_chunks=args.convergence_chunks,
            n_restarts=args.restarts,
            pad_policy=args.pad_policy,
            device=args.device,
            trace=args.trace,
            trace_format=args.trace_format,
        )
        for r in results:
            r.pop("cost_trace", None)  # keep the printed JSON compact
            r.pop("telemetry", None)
        return write_result(args, results)
    result = solve(
        args.dcop_files if len(args.dcop_files) > 1 else args.dcop_files[0],
        args.algo,
        parse_algo_params(args.algo_params),
        rounds=args.rounds,
        timeout=args.timeout,
        seed=args.seed,
        n_restarts=args.restarts,
        convergence_chunks=args.convergence_chunks,
        pad_policy=args.pad_policy,
        device=args.device,
        trace=args.trace,
        trace_format=args.trace_format,
    )
    result.pop("cost_trace", None)  # keep the printed JSON compact
    return write_result(args, result)
