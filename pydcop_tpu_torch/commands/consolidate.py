"""``pydcop_tpu_torch consolidate`` (a copy of
``pydcop_tpu/commands/consolidate.py``; reference:
``pydcop/commands/consolidate.py``).

Merge result CSVs from batch runs into one file, optionally aggregating
numeric columns (mean/min/max) grouped by key columns.
"""

from __future__ import annotations

import csv
import glob as globmod
import json
import statistics
from typing import Dict, List


def set_parser(subparsers) -> None:
    p = subparsers.add_parser(
        "consolidate", help="merge/aggregate batch result CSVs"
    )
    p.add_argument(
        "csv_files", nargs="+", help="result CSV files (globs allowed)"
    )
    p.add_argument(
        "--result_file", default="consolidated.csv", help="merged CSV"
    )
    p.add_argument(
        "--group_by", nargs="*", default=None,
        help="aggregate numeric columns grouped by these columns",
    )
    p.add_argument(
        "--aggregate", choices=["mean", "min", "max"], default="mean"
    )
    p.set_defaults(func=run_cmd)


def run_cmd(args) -> int:
    files: List[str] = []
    for pattern in args.csv_files:
        matches = sorted(globmod.glob(pattern))
        files.extend(matches if matches else [pattern])

    rows: List[Dict[str, str]] = []
    fields: List[str] = []
    for path in files:
        with open(path, newline="") as f:
            reader = csv.DictReader(f)
            for name in reader.fieldnames or []:
                if name not in fields:
                    fields.append(name)
            rows.extend(reader)

    if args.group_by:
        missing = [c for c in args.group_by if c not in fields]
        if missing:
            raise SystemExit(f"consolidate: unknown column(s) {missing}")
        numeric = [
            c
            for c in fields
            if c not in args.group_by and _is_numeric_col(rows, c)
        ]
        agg_fn = {
            "mean": statistics.fmean,
            "min": min,
            "max": max,
        }[args.aggregate]
        groups: Dict[tuple, List[Dict[str, str]]] = {}
        for row in rows:
            groups.setdefault(
                tuple(row.get(c, "") for c in args.group_by), []
            ).append(row)
        out_fields = list(args.group_by) + numeric + ["n_runs", "n_errors"]
        out_rows = []
        for gkey, grows in sorted(groups.items()):
            out = dict(zip(args.group_by, gkey))
            # error rows are excluded from the aggregates and surfaced
            # in n_errors, so a mean never silently hides failed runs
            ok_rows = [
                r
                for r in grows
                if not r.get("status", "").startswith("error")
            ]
            for c in numeric:
                vals = [
                    float(r[c])
                    for r in ok_rows
                    if r.get(c) not in (None, "")
                ]
                out[c] = agg_fn(vals) if vals else ""
            out["n_runs"] = len(ok_rows)
            out["n_errors"] = len(grows) - len(ok_rows)
            out_rows.append(out)
        fields, rows = out_fields, out_rows

    with open(args.result_file, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=fields)
        writer.writeheader()
        for row in rows:
            writer.writerow(row)
    print(
        json.dumps(
            {
                "files": len(files),
                "rows": len(rows),
                "result_file": args.result_file,
            }
        )
    )
    return 0


def _is_numeric_col(rows: List[Dict[str, str]], col: str) -> bool:
    seen = False
    for r in rows:
        v = r.get(col)
        if v in (None, ""):
            continue
        seen = True
        try:
            float(v)
        except ValueError:
            return False
    return seen
