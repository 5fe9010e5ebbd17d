"""``pydcop_tpu_torch infer`` — exact probabilistic inference over a
DCOP's cost model (port of ``pydcop_tpu/commands/infer.py``).

One file prints one result JSON; several files are MANY instances whose
contraction sweeps merge (``api.infer_many``) and print a JSON array.
``--device`` keeps the JAX command's meaning (the offload policy);
``--torch_device cpu`` runs the contractions on the CPU instead of the
CUDA device.  ``--table_dtype``, ``--table_format`` and
``--max_util_bytes`` pick the storage of the device tables and the
memory-bounded sweep.
"""

from __future__ import annotations

from pydcop_tpu_torch.commands._common import (
    add_compile_cache_argument,
    add_trace_arguments,
    refuse_compile_cache,
    write_result,
)


def set_parser(subparsers) -> None:
    p = subparsers.add_parser(
        "infer",
        help="exact inference (marginals / log Z / MAP / K-best / "
        "marginal MAP / E[cost]) over the Gibbs distribution "
        "p(x) ~ exp(-beta * cost(x)) via the semiring contraction "
        "sweep (ops/semiring.py)",
    )
    p.add_argument(
        "dcop_files", nargs="+",
        help="dcop yaml file(s); several files = several instances "
        "batched into one merged contraction sweep (api.infer_many)",
    )
    p.add_argument(
        "-q", "--query", default="marginals", metavar="QUERY",
        help="marginals: per-variable distributions p(x_v) (+ log_z); "
        "log_z: the log partition function; map: the exact MAP "
        "assignment; kbest:<k>: the k best assignments in cost order; "
        "marginal_map: maximize --map_vars over the summed weight of "
        "the rest; expectation: E[cost] under the Gibbs distribution "
        "(+ --external_dists for stochastic externals).  Unknown names "
        "fail with the nearest query suggested",
    )
    p.add_argument(
        "--map_vars", default=None, metavar="V1,V2,...",
        help="marginal_map only: comma-separated names of the variables "
        "maximized over (every other variable is summed out)",
    )
    p.add_argument(
        "--external_dists", default=None, metavar="JSON",
        help="expectation only: JSON mapping external-variable names to "
        "{value: prob} distributions, e.g. "
        "'{\"sensor\": {\"0\": 0.7, \"1\": 0.3}}' (values are matched "
        "against the domain, with a string fallback)",
    )
    p.add_argument(
        "--order", choices=["pseudo_tree", "min_fill"],
        default="pseudo_tree",
        help="elimination-order heuristic: pseudo_tree (the DPOP DFS "
        "order) or min_fill (greedy width heuristic)",
    )
    p.add_argument(
        "--beta", type=float, default=1.0,
        help="inverse temperature of p(x) ~ exp(-beta * cost(x))",
    )
    p.add_argument(
        "--tol", type=float, default=1e-6,
        help="log-domain error budget for device (f32) logsumexp "
        "contractions: a contraction whose accumulated bound would "
        "exceed this runs on host f64 instead; default 1e-6",
    )
    p.add_argument(
        "--device", choices=["auto", "never", "always"],
        default="auto",
        help="device offload of large contractions (auto: tables >= "
        "--device_min_cells cells)",
    )
    p.add_argument(
        "--device_min_cells", type=int, default=1 << 14,
        help="smallest contraction table worth a device dispatch",
    )
    p.add_argument(
        "--torch_device", default=None,
        help="where the device contractions run: 'cpu', or by default "
        "the CUDA device (the command fails when there is none)",
    )
    p.add_argument(
        "--pad_policy", default=None, metavar="POLICY",
        help="bucket the contraction dispatches on the pow-2 level-pack "
        "lattice ('pow2' or 'pow2:<floor>'); default: none for one "
        "file, pow2 for several",
    )
    add_compile_cache_argument(p)
    p.add_argument(
        "--max_util_bytes", type=int, default=None, metavar="N",
        help="run the sweep memory-bounded (ops/membound.py): every "
        "contraction table stays under N device bytes by conditioning "
        "a cut set whose assignments ride the level-pack stack as "
        "extra lanes — exact per the query's ⊕ contract; the result "
        "carries a 'membound' block",
    )
    p.add_argument(
        "--bnb", choices=["auto", "on", "off"], default="auto",
        help="branch-and-bound pruned contraction kernels: rows a cheap "
        "bound proves irrelevant are masked — map/kbest stay "
        "bit-identical, the mass queries add the discarded mass to "
        "error_bound.  'auto' (default) prunes only dispatches whose "
        "per-row table clears a size threshold",
    )
    p.add_argument(
        "--table_dtype", choices=["f32", "bf16", "int8"], default="f32",
        help="storage precision of the device tables: 'bf16' halves and "
        "'int8' quarters the bytes while the join stays f32 — map/kbest "
        "stay bit-identical through the certificate, log_z/marginals "
        "carry a widened error_bound",
    )
    p.add_argument(
        "--table_format", choices=["dense", "sparse"], default="dense",
        help="storage layout of the device tables: 'sparse' COO-packs "
        "the feasible tuples of hard-constraint-dominated tables — "
        "map/kbest bit-identical to dense, mass queries within "
        "error_bound",
    )
    p.add_argument(
        "--retry_budget", type=int, default=None, metavar="N",
        help="transient device failures retry up to N times per "
        "dispatch (engine/supervisor.py; default 2)",
    )
    add_trace_arguments(p)
    p.set_defaults(func=run_cmd)


def run_cmd(args) -> int:
    import json

    from pydcop_tpu_torch.api import infer, infer_many

    refuse_compile_cache(args)
    external_dists = None
    if args.external_dists:
        try:
            external_dists = json.loads(args.external_dists)
        except ValueError as e:
            raise SystemExit(f"--external_dists is not valid JSON: {e}")
        if not isinstance(external_dists, dict) or not all(
            isinstance(d, dict) for d in external_dists.values()
        ):
            raise SystemExit(
                "--external_dists must be a JSON object mapping "
                "external names to {value: prob} objects"
            )
    kw = dict(
        order=args.order,
        beta=args.beta,
        tol=args.tol,
        device=args.device,
        device_min_cells=args.device_min_cells,
        timeout=args.timeout,
        trace=args.trace,
        trace_format=args.trace_format,
        map_vars=(
            [v.strip() for v in args.map_vars.split(",") if v.strip()]
            if args.map_vars
            else None
        ),
        external_dists=external_dists,
        max_util_bytes=args.max_util_bytes,
        bnb=args.bnb,
        table_dtype=args.table_dtype,
        table_format=args.table_format,
        torch_device=args.torch_device,
        retry_budget=args.retry_budget,
    )
    try:
        if len(args.dcop_files) == 1:
            result = infer(
                args.dcop_files[0], args.query,
                pad_policy=args.pad_policy or "none", **kw,
            )
            return write_result(args, result)
        results = infer_many(
            list(args.dcop_files), args.query,
            pad_policy=args.pad_policy or "pow2", **kw,
        )
    except ValueError as e:
        # bad query / map_vars / dists: the message already carries the
        # nearest-name suggestion — surface it, not a traceback
        raise SystemExit(f"infer: {e}")
    for r in results:
        r.pop("telemetry", None)  # keep the printed JSON compact
    return write_result(args, results)
