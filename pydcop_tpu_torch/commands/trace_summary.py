"""``pydcop_tpu_torch trace-summary`` — aggregate a telemetry trace (a
copy of ``pydcop_tpu/commands/trace_summary.py``).

Reads a ``--trace`` file (JSONL or Chrome ``trace_event`` format,
auto-detected) and prints per-phase span totals, event counts,
injected-fault counts, per-agent activity, and the embedded metrics
snapshot.  The JAX package's ``docs/observability.md`` describes the
records.
"""

from __future__ import annotations

import json


def set_parser(subparsers) -> None:
    p = subparsers.add_parser(
        "trace-summary",
        help="aggregate a --trace telemetry file (per-phase / "
        "per-agent totals); --requests stitches several files into "
        "per-request timelines by wire-propagated trace id",
    )
    p.add_argument(
        "trace_file", nargs="+",
        help="trace file(s) (jsonl or chrome); the default summary "
        "reads the first, --requests correlates ALL of them (e.g. a "
        "client-side trace plus the server's)",
    )
    p.add_argument(
        "--requests", action="store_true", dest="as_requests",
        help="stitch one correlated timeline per request across the "
        "given trace files: client attempt spans and server "
        "queue/dispatch/phase spans joined on the trace id the wire "
        "protocol propagates (docs/observability.md, 'Serving "
        "observability')",
    )
    p.add_argument(
        "--json", action="store_true", dest="as_json",
        help="print the aggregates as JSON instead of a table",
    )
    p.set_defaults(func=run_cmd)


def run_cmd(args) -> int:
    from pydcop_tpu_torch.telemetry.summary import (
        format_requests,
        format_summary,
        load_trace,
        stitch_requests,
        summarize,
    )

    try:
        tracesets = [load_trace(p) for p in args.trace_file]
    except (OSError, ValueError) as e:
        raise SystemExit(f"trace-summary: {e}")
    if args.as_requests:
        stitched = stitch_requests(tracesets)
        out = (
            json.dumps(stitched, indent=2, default=str)
            if args.as_json
            else format_requests(stitched)
        )
    else:
        if len(tracesets) > 1:
            raise SystemExit(
                "trace-summary: several trace files only combine "
                "under --requests (the aggregate summary is "
                "per-process — run it per file)"
            )
        s = summarize(tracesets[0])
        out = (
            json.dumps(s, indent=2, default=str)
            if args.as_json
            else format_summary(s)
        )
    print(out)
    if getattr(args, "output", None):
        with open(args.output, "w") as f:
            f.write(out + "\n")
    return 0
