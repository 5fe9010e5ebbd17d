"""``flight-dump`` — render a flight-recorder dump (a copy of
``pydcop_tpu/commands/flight_dump.py``; the dump format is shared).

Reads the atomic dump a serving process wrote on a degraded / shed /
unrecoverable / drain / SIGTERM trigger (``telemetry/flightrec.py``,
``serve --flight_dump``) and prints the trigger, the triggering
request's trace id, and the recent span/event/counter timeline — the
triggering request's own records flagged with ``*``.  See
``docs/observability.md``, "Serving observability".
"""

from __future__ import annotations

import json


def set_parser(subparsers) -> None:
    p = subparsers.add_parser(
        "flight-dump",
        help="render a flight-recorder dump file (written by serve "
        "--flight_dump on degraded/shed/drain triggers) as a "
        "timeline, the triggering request flagged "
        "(docs/observability.md)",
    )
    p.add_argument("dump_file", help="flight dump file (JSON)")
    p.add_argument(
        "--tail", type=int, default=0, metavar="N",
        help="only show the newest N ring records (0 = all)",
    )
    p.add_argument(
        "--json", action="store_true", dest="as_json",
        help="print the raw dump document as JSON instead of the "
        "rendered timeline",
    )
    p.set_defaults(func=run_cmd)


def run_cmd(args) -> int:
    from pydcop_tpu_torch.telemetry.flightrec import format_dump, load_dump

    try:
        doc = load_dump(args.dump_file)
    except (OSError, ValueError) as e:
        raise SystemExit(f"flight-dump: {e}")
    out = (
        json.dumps(doc, indent=2, default=str)
        if args.as_json
        else format_dump(doc, tail=args.tail)
    )
    print(out)
    if getattr(args, "output", None):
        with open(args.output, "w") as f:
            f.write(out + "\n")
    return 0
