"""Shared CLI helpers (the parts of ``pydcop_tpu/commands/_common.py``
the port's commands use)."""

from __future__ import annotations

import json


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


def write_result(args, result) -> int:
    """Print the result as indented JSON (and write ``--output``)."""
    out = json.dumps(result, indent=2, default=str)
    print(out)
    if getattr(args, "output", None):
        with open(args.output, "w") as f:
            f.write(out)
    return 0
