"""``pydcop_tpu_torch bench-compare`` — statistical comparison of
measurements.

The port's counterpart of ``pydcop_tpu bench-compare``, with the same
flags, output and exit codes, over the same tool (``tools/benchkeeper``):

- ``--pairs FILE``: a JSON doc of paired interleaved samples
  (``{"baseline": [...], "candidate": [...], "higher_is_better":
  true}``) gets the seeded comparator's ``regression|improvement|noise``
  verdict (sign test + bootstrap CI on the paired ratios; two runs over
  the same file are bit-identical).  Exit 1 on ``regression``.
- ``--baseline rNN --candidate rMM``: ledger rounds compared as
  fingerprint-checked point ratios only; a fingerprint mismatch refuses
  the comparison.  Exit 2 when nothing compares.
"""

from __future__ import annotations

import json
import sys

from pydcop_tpu_torch.commands.bench_history import (
    find_root,
    import_benchkeeper,
)


def set_parser(subparsers) -> None:
    p = subparsers.add_parser(
        "bench-compare",
        help="compare measurements: paired-sample verdicts "
        "(regression|improvement|noise) or fingerprint-checked round "
        "ratios",
    )
    p.add_argument(
        "--pairs", default=None, metavar="FILE",
        help="JSON doc with paired interleaved samples: "
        '{"baseline": [...], "candidate": [...], '
        '"higher_is_better": true} — full statistical verdict',
    )
    p.add_argument(
        "--baseline", default=None, metavar="ROUND",
        help="ledger round to compare from (e.g. r08)",
    )
    p.add_argument(
        "--candidate", default=None, metavar="ROUND",
        help="ledger round to compare to (e.g. r09)",
    )
    p.add_argument(
        "--stage", default=None, metavar="STAGE",
        help="restrict round comparison to one stage",
    )
    p.add_argument(
        "--metric", default=None, metavar="METRIC",
        help="restrict round comparison to one metric",
    )
    p.add_argument(
        "--ledger", default=None, metavar="FILE",
        help="ledger path (default: <root>/benchdata/ledger.jsonl)",
    )
    p.add_argument(
        "--seed", type=int, default=None,
        help="bootstrap seed (default: the comparator's pinned seed)",
    )
    p.add_argument(
        "--alpha", type=float, default=None,
        help="sign-test significance level (default 0.05)",
    )
    p.add_argument(
        "--noise_floor", type=float, default=None,
        help="practical-significance floor on |median ratio - 1| "
        "(default 0.05)",
    )
    p.add_argument(
        "--n_boot", type=int, default=None,
        help="bootstrap resamples (default 2000)",
    )
    p.add_argument(
        "--json", action="store_true", dest="as_json",
        help="machine-readable result",
    )
    p.add_argument(
        "--root", default=None, metavar="DIR",
        help="project root (default: the checkout containing the "
        "pydcop_tpu_torch package)",
    )
    p.set_defaults(func=run_cmd)


def _emit(args, doc: dict, text: str) -> None:
    out = json.dumps(doc, indent=2, sort_keys=True) if args.as_json else text
    print(out)
    if getattr(args, "output", None):
        with open(args.output, "w") as f:
            f.write(json.dumps(doc, indent=2, sort_keys=True) + "\n")


def run_cmd(args) -> int:
    root = find_root(args.root)
    bk_ledger, bk_history = import_benchkeeper(root)

    if args.pairs and (args.baseline or args.candidate):
        print(
            "bench-compare: --pairs and --baseline/--candidate are "
            "mutually exclusive", file=sys.stderr,
        )
        return 2

    if args.pairs:
        try:
            with open(args.pairs) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            print(f"bench-compare: cannot read {args.pairs}: {e}",
                  file=sys.stderr)
            return 2
        kwargs = {
            k: v for k, v in (
                ("seed", args.seed), ("alpha", args.alpha),
                ("noise_floor", args.noise_floor), ("n_boot", args.n_boot),
            ) if v is not None
        }
        try:
            result = bk_history.compare_pairs_doc(doc, **kwargs)
        except ValueError as e:
            print(f"bench-compare: {e}", file=sys.stderr)
            return 2
        _emit(args, result, bk_history.format_verdict(result))
        return 1 if result["verdict"] == "regression" else 0

    if not (args.baseline and args.candidate):
        print(
            "bench-compare: need either --pairs FILE or "
            "--baseline ROUND --candidate ROUND", file=sys.stderr,
        )
        return 2

    path = args.ledger or str(root / bk_ledger.LEDGER_RELPATH)
    rows = bk_ledger.read_ledger(path)
    if not rows:
        print(
            f"bench-compare: no ledger rows at {path} "
            "(run bench-history --rebuild to seed it)", file=sys.stderr,
        )
        return 2
    result = bk_history.compare_rounds(
        rows, args.baseline, args.candidate,
        stage=args.stage, metric=args.metric,
    )
    _emit(args, result, bk_history.format_compare_rounds(result))
    return 2 if not result["entries"] else 0
