"""Agents-file generator (a copy of
``pydcop_tpu/commands/generators/agents.py``).

Role-equivalent to the reference's ``generators/agents.py``: emit a
standalone yaml ``agents:`` section (agent definitions with capacity
and optional random hosting/route costs) to combine with a separately
generated problem file.
"""

from __future__ import annotations

import random


def set_parser(subparsers) -> None:
    p = subparsers.add_parser("agents", help="generate an agents yaml")
    p.add_argument("--count", "-n", type=int, required=True)
    p.add_argument("--capacity", type=float, default=100.0)
    p.add_argument(
        "--hosting_default", type=float, default=None,
        help="default hosting cost (omitted if not set)",
    )
    p.add_argument(
        "--routes_default", type=float, default=None,
        help="default route cost (omitted if not set)",
    )
    p.add_argument(
        "--hosting_range", type=float, default=0.0,
        help="draw default hosting costs from U(0, range) per agent",
    )
    p.add_argument("--agent_prefix", default="a")
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(func=run_cmd)


def run_cmd(args) -> int:
    import yaml  # lazy: the CLI builds its parser without PyYAML

    rnd = random.Random(args.seed)
    width = len(str(max(args.count - 1, 1)))
    agents = {}
    for i in range(args.count):
        ad = {"capacity": args.capacity}
        hosting = args.hosting_default
        if args.hosting_range:
            hosting = round(rnd.uniform(0, args.hosting_range), 3)
        if hosting is not None:
            ad["hosting"] = {"default": hosting}
        if args.routes_default is not None:
            ad["routes"] = {"default": args.routes_default}
        agents[f"{args.agent_prefix}{i:0{width}d}"] = ad
    text = yaml.safe_dump({"agents": agents}, sort_keys=False)
    if getattr(args, "output", None):
        with open(args.output, "w") as f:
            f.write(text)
    else:
        print(text)
    return 0
