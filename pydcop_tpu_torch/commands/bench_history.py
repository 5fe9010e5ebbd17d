"""``pydcop_tpu_torch bench-history`` — render the performance trajectory.

The port's counterpart of ``pydcop_tpu bench-history``, with the same
flags, output and exit codes: it drives the same tool
(``tools/benchkeeper``, stdlib only) over the normalized ledger
(default ``benchdata/ledger.jsonl``) and prints per-stage sparkline
trends with ratio-chain normalization across environment fingerprints,
the per-round status line, and per-backend staleness (``--stale_hours``,
default 72h).  The rows in the default ledger are the JAX package's
bench runs; the port adds none before it has a benchmark of its own.

``--rebuild`` regenerates the ledger from the historic artifacts
(``BENCH_r*.json`` + ``BENCH_TPU_LOG.jsonl`` under ``--root``).

The tool lives under ``tools/``, so this command needs a source
checkout: by default the one that holds the ``pydcop_tpu_torch``
package.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path


def set_parser(subparsers) -> None:
    p = subparsers.add_parser(
        "bench-history",
        help="render the bench trajectory: sparkline trends, round "
        "status, per-backend staleness",
    )
    p.add_argument(
        "--ledger", default=None, metavar="FILE",
        help="ledger path (default: <root>/benchdata/ledger.jsonl)",
    )
    p.add_argument(
        "--stage", default=None, metavar="STAGE",
        help="show only this stage, with per-point detail",
    )
    p.add_argument(
        "--stale_hours", type=float, default=72.0, metavar="H",
        help="flag a backend STALE when its newest row is older than "
        "this many hours (default 72)",
    )
    p.add_argument(
        "--now", default=None, metavar="TS",
        help="compute staleness against this UTC timestamp "
        "(%%Y-%%m-%%dT%%H:%%M:%%SZ) instead of the wall clock — for "
        "reproducible output in tests",
    )
    p.add_argument(
        "--rebuild", action="store_true",
        help="regenerate the ledger from BENCH_r*.json + "
        "BENCH_TPU_LOG.jsonl before rendering",
    )
    p.add_argument(
        "--json", action="store_true", dest="as_json",
        help="machine-readable report (rows, rounds, freshness)",
    )
    p.add_argument(
        "--root", default=None, metavar="DIR",
        help="project root (default: the checkout containing the "
        "pydcop_tpu_torch package)",
    )
    p.set_defaults(func=run_cmd)


def find_root(explicit) -> Path:
    """``--root``, or the checkout that holds this package."""
    if explicit:
        return Path(explicit).resolve()
    return Path(__file__).resolve().parent.parent.parent


def import_benchkeeper(root: Path):
    """Put ``<root>/tools`` on the path and import benchkeeper — shared
    by bench-history and bench-compare so the lookup cannot drift."""
    tools_dir = root / "tools"
    if not (tools_dir / "benchkeeper" / "__init__.py").is_file():
        raise SystemExit(
            f"bench-history: {tools_dir}/benchkeeper not found — the "
            "bench tooling runs from a source checkout (pass --root, "
            "or run from the repository)"
        )
    if str(tools_dir) not in sys.path:
        sys.path.insert(0, str(tools_dir))
    import benchkeeper.history
    import benchkeeper.ledger

    return benchkeeper.ledger, benchkeeper.history


def run_cmd(args) -> int:
    root = find_root(args.root)
    bk_ledger, bk_history = import_benchkeeper(root)
    path = args.ledger or str(root / bk_ledger.LEDGER_RELPATH)
    if args.rebuild:
        rows = bk_ledger.seed_rows(str(root))
        n = bk_ledger.write_ledger(path, rows)
        print(f"rebuilt {path}: {n} rows", file=sys.stderr)
    rows = bk_ledger.read_ledger(path)
    if not rows:
        print(
            f"bench-history: no ledger rows at {path} "
            "(run with --rebuild to seed it from BENCH_r*.json)",
            file=sys.stderr,
        )
        return 1
    now_epoch = bk_ledger.parse_ts(args.now) if args.now else time.time()
    if args.as_json:
        doc = {
            "ledger": path,
            "n_rows": len(rows),
            "rounds": bk_history.rounds_summary(rows),
            "freshness": bk_history.stale_backends(
                rows, now_epoch=now_epoch, stale_hours=args.stale_hours
            ),
        }
        text = json.dumps(doc, indent=2, sort_keys=True)
        print(text)
        if getattr(args, "output", None):
            with open(args.output, "w") as f:
                f.write(text + "\n")
        return 0
    print(bk_history.history_report(
        rows,
        now_epoch=now_epoch,
        stale_hours=args.stale_hours,
        stage=args.stage,
    ))
    return 0
