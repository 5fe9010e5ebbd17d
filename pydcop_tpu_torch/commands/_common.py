"""Shared CLI helpers (a port of ``pydcop_tpu/commands/_common.py``):
DCOP and graph loading, algo-param parsing, the trace, supervisor and
metric-collection flags, metrics/result output."""

from __future__ import annotations

import csv
import json
from typing import Any, Dict, List


def load_dcop_and_graph(args):
    """Shared --graph/--algo resolution + dcop loading for the graph
    and distribute commands.  Returns (dcop, graph, graph model name,
    algo_module)."""
    from pydcop_tpu_torch.dcop.yamldcop import load_dcop_from_file
    from pydcop_tpu_torch.graphs import load_graph_module

    if not args.graph and not args.algo:
        raise SystemExit(f"{args.command}: provide --graph or --algo")
    algo_module = None
    graph_model = args.graph
    if args.algo:
        from pydcop_tpu_torch.algorithms import load_algorithm_module

        algo_module = load_algorithm_module(args.algo)
        if graph_model is None:
            graph_model = algo_module.GRAPH_TYPE
    dcop = load_dcop_from_file(
        args.dcop_files if len(args.dcop_files) > 1 else args.dcop_files[0]
    )
    graph = load_graph_module(graph_model).build_computation_graph(dcop)
    return dcop, graph, graph_model, algo_module


def add_trace_arguments(parser) -> None:
    """``--trace``/``--trace_format``: structured telemetry trace output
    (``pydcop_tpu_torch.telemetry``)."""
    parser.add_argument(
        "--trace", type=str, default=None, metavar="FILE",
        help="write a structured telemetry trace (cycle/phase spans, "
        "contraction and UTIL phases, counters) to FILE; the JAX "
        "package's `trace-summary` reads it",
    )
    parser.add_argument(
        "--trace_format", choices=["jsonl", "chrome"], default="jsonl",
        help="trace file format: jsonl (one record per line, the "
        "trace-summary input) or chrome (trace_event JSON for "
        "chrome://tracing / Perfetto)",
    )


def add_compile_cache_argument(parser) -> None:
    """``--compile_cache``: the JAX package's flag, accepted and refused
    (:func:`refuse_compile_cache`)."""
    parser.add_argument(
        "--compile_cache", default=None, metavar="DIR",
        help="the JAX package's persistent XLA compilation cache: the "
        "port compiles no XLA programs, so the flag is refused",
    )


def refuse_compile_cache(args) -> None:
    """Exit with the API's refusal when ``--compile_cache`` was given."""
    from pydcop_tpu_torch.api import _no_compile_cache

    try:
        _no_compile_cache(args.compile_cache)
    except NotImplementedError as e:
        raise SystemExit(f"{args.command}: {e}")


def write_result(args, result) -> int:
    """Print the result as indented JSON (and write ``--output``)."""
    out = json.dumps(result, indent=2, default=str)
    print(out)
    if getattr(args, "output", None):
        with open(args.output, "w") as f:
            f.write(out)
    return 0


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


def add_supervisor_arguments(parser) -> None:
    """``--retry_budget``/``--chunk_floor``/``--on_numeric_fault``:
    the supervised device-dispatch knobs of the batched engine
    (``engine/supervisor.py``)."""
    parser.add_argument(
        "--retry_budget", type=int, default=None, metavar="N",
        help="transient device failures retry up to N times per "
        "dispatch (seeded deterministic backoff; default 2, 0 turns "
        "retries off) — batched engine only",
    )
    parser.add_argument(
        "--chunk_floor", type=int, default=None, metavar="ROUNDS",
        help="smallest chunk size the device-OOM degradation ladder "
        "may halve down to before the run is declared over capacity "
        "(default 8) — batched engine only",
    )
    parser.add_argument(
        "--on_numeric_fault", choices=["quarantine", "raise"],
        default=None,
        help="NaN-poisoned run/instance handling: quarantine (report "
        "the last-finite anytime best with status=degraded — for "
        "solve --many only the poisoned instance degrades, the rest "
        "of its group finishes untouched; default) or raise (fail "
        "the call) — batched engine only",
    )


def add_collect_arguments(parser) -> None:
    parser.add_argument(
        "--collect_on",
        choices=["cycle_change", "value_change", "period"],
        default="cycle_change",
        help="metric collection mode",
    )
    parser.add_argument(
        "--period", type=float, default=None,
        help="collection period (seconds), for --collect_on period",
    )
    parser.add_argument(
        "--run_metrics", type=str, default=None,
        help="write per-cycle metrics to this CSV file",
    )
    parser.add_argument(
        "--end_metrics", type=str, default=None,
        help="append end-of-run metrics to this CSV file",
    )


def write_metrics(args, result: Dict[str, Any]) -> None:
    """Write the run/end metric CSVs (reference ``--collect_on`` modes).

    - ``cycle_change``: one row per engine round (cycle).
    - ``value_change``: only rounds whose cost differs from the
      previous one (the anytime-improvement stream).
    - ``period``: rows sampled every ``--period`` seconds; the batched
      engine fuses rounds into chunks, so per-round timestamps are
      interpolated uniformly over the measured wall-clock time.
    """
    trace = result.get("cost_trace") or []
    if getattr(args, "run_metrics", None):
        n = len(trace)
        total_time = float(result.get("time", 0.0) or 0.0)
        msgs_total = int(result.get("msg_count", 0) or 0)
        cycles_total = int(result.get("cycle", n) or n)
        # on --resume, the trace covers only the new rounds: label
        # cycles from where the checkpoint left off and keep msg_count
        # cumulative over the WHOLE run (cycle and msg_count in the
        # printed JSON are whole-run too)
        first_cycle = cycles_total - n
        per_round_msgs = msgs_total / cycles_total if cycles_total else 0
        # the host runtimes SUBSAMPLE their anytime trace (one entry
        # per snapshot, not per cycle): label those proportionally or
        # the whole history reads as the run's final n cycles
        subsampled = bool(result.get("trace_subsampled"))
        # host runtimes record the ACTUAL delivered count per snapshot
        # (trace_msgs); only fall back to the proportional
        # reconstruction for traces that predate it
        msgs_at = result.get("trace_msgs") or []
        exact = len(msgs_at) == n

        def row(i):
            if exact:
                # host cycle == delivered messages (async analogue of
                # rounds), so both columns come straight off the record
                cyc, msgs = msgs_at[i], msgs_at[i]
            elif subsampled:
                cyc = max(1, round(cycles_total * (i + 1) / n)) if n else 0
                msgs = int(per_round_msgs * cyc)
            else:
                cyc = first_cycle + i + 1
                msgs = int(per_round_msgs * cyc)
            return [
                round(total_time * (i + 1) / n, 6) if n else 0.0,
                cyc,
                trace[i],
                msgs,
            ]

        mode = getattr(args, "collect_on", "cycle_change")
        rows = []
        if mode == "value_change":
            prev = None
            for i, c in enumerate(trace):
                if prev is None or c != prev:
                    rows.append(row(i))
                prev = c
        elif mode == "period":
            period = getattr(args, "period", None) or 1.0
            if period <= 0:
                raise SystemExit("--period must be > 0")
            next_t = period
            for i in range(n):
                t = total_time * (i + 1) / n
                if t >= next_t or i == n - 1:
                    rows.append(row(i))
                    # advance past t, not by one period: one long
                    # interval must not make later rows fire every round
                    while next_t <= t:
                        next_t += period
        else:  # cycle_change
            rows = [row(i) for i in range(n)]
        with open(args.run_metrics, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["time", "cycle", "cost", "msg_count"])
            w.writerows(rows)
    if getattr(args, "end_metrics", None):
        import os

        # NOTE the run/end asymmetry (as in the JAX package):
        # --run_metrics describes ONE run and truncates ("w"); in
        # contrast --end_metrics accumulates one row per run across
        # invocations ("a").  The header goes in only when the file is
        # being created (or is empty) — never into the middle of an
        # existing file, so legacy header-less files keep appending
        # data rows instead of getting a header wedged mid-stream.
        needs_header = (
            not os.path.exists(args.end_metrics)
            or os.path.getsize(args.end_metrics) == 0
        )
        with open(args.end_metrics, "a", newline="") as f:
            w = csv.writer(f)
            if needs_header:
                w.writerow(
                    ["status", "cost", "cycle", "msg_count", "time"]
                )
            w.writerow(
                [
                    result.get("status"),
                    result.get("cost"),
                    result.get("cycle"),
                    result.get("msg_count"),
                    result.get("time"),
                ]
            )
