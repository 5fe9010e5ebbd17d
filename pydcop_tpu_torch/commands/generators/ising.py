"""Ising-model problem generator.

A copy of ``pydcop_tpu/commands/generators/ising.py`` (the same instance
from the same arguments and seed).

Role-equivalent to the reference's ``generators/ising.py``: a
``row_count × col_count`` torus of binary spins; each edge carries a
coupling sampled from ``U(-k, k)`` (cost ``J`` when spins agree, ``-J``
when they differ) and each spin a random external field from
``U(-r, r)`` expressed as a unary extensional constraint.
"""

from __future__ import annotations

import random

import numpy as np

from pydcop_tpu_torch.commands.generators._common import write_dcop


def set_parser(subparsers) -> None:
    p = subparsers.add_parser("ising", help="generate an Ising-grid DCOP")
    p.add_argument("--row_count", type=int, required=True)
    p.add_argument("--col_count", type=int, default=None)
    p.add_argument(
        "--bin_range", "-k", type=float, default=1.6,
        help="coupling strengths drawn from U(-k, k)",
    )
    p.add_argument(
        "--un_range", "-r", type=float, default=0.05,
        help="external fields drawn from U(-r, r)",
    )
    p.add_argument(
        "--no_agents", action="store_true",
        help="do not generate agent definitions",
    )
    p.add_argument("--capacity", type=float, default=100.0)
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(func=run_cmd)


def run_cmd(args) -> int:
    return write_dcop(args, generate(args))


def generate(args):
    from pydcop_tpu_torch.dcop.dcop import DCOP
    from pydcop_tpu_torch.dcop.objects import AgentDef, Domain, Variable
    from pydcop_tpu_torch.dcop.relations import NAryMatrixRelation

    rows = args.row_count
    cols = args.col_count or rows
    rnd = random.Random(args.seed)

    dcop = DCOP(
        f"ising_{rows}x{cols}",
        objective="min",
        description=f"Ising torus {rows}x{cols}, couplings U(±{args.bin_range}),"
        f" fields U(±{args.un_range}), seed {args.seed}",
    )
    spin = Domain("spin", "binary", [0, 1])

    grid = {}
    for r in range(rows):
        for c in range(cols):
            v = Variable(f"v_{r}_{c}", spin)
            grid[(r, c)] = v
            dcop.add_variable(v)

    # torus edges: right and down neighbors (wrapping); on grids of
    # width/height <= 2 the wrap revisits pairs, so dedupe on the
    # canonical (sorted) pair
    seen = set()
    for r in range(rows):
        for c in range(cols):
            v = grid[(r, c)]
            for dr, dc in ((0, 1), (1, 0)):
                r2, c2 = (r + dr) % rows, (c + dc) % cols
                if (r2, c2) == (r, c):
                    continue  # degenerate 1-wide torus
                u = grid[(r2, c2)]
                pair = tuple(sorted((v.name, u.name)))
                if pair in seen:
                    continue
                seen.add(pair)
                coupling = rnd.uniform(-args.bin_range, args.bin_range)
                matrix = np.array(
                    [[coupling, -coupling], [-coupling, coupling]],
                    dtype=np.float32,
                )
                dcop.add_constraint(
                    NAryMatrixRelation(
                        [v, u], matrix, name=f"c_{pair[0]}_{pair[1]}"
                    )
                )

    for v in grid.values():
        field = rnd.uniform(-args.un_range, args.un_range)
        matrix = np.array([field, -field], dtype=np.float32)
        dcop.add_constraint(
            NAryMatrixRelation([v], matrix, name=f"u_{v.name}")
        )

    if not args.no_agents:
        dcop.add_agents(
            [
                AgentDef(f"a_{r}_{c}", capacity=args.capacity)
                for r in range(rows)
                for c in range(cols)
            ]
        )
    return dcop
