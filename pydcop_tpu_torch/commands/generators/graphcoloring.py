"""Graph-coloring problem generator.

A copy of ``pydcop_tpu/commands/generators/graphcoloring.py`` (the same instance
from the same arguments and seed).

Role-equivalent to the reference's
``pydcop/commands/generators/graphcoloring.py``: soft graph coloring on
random (Erdős–Rényi), grid, or scale-free (Barabási–Albert) graphs.
Each edge is a binary constraint penalizing equal colors; with
``--soft`` the penalty is a random weight, and ``--noise`` adds small
per-variable value preferences (``VariableNoisyCostFunc``) to break
symmetry, as in the reference's benchmark instances.
"""

from __future__ import annotations

import random

from pydcop_tpu_torch.commands.generators._common import (
    grid_edges,
    random_graph_edges,
    scalefree_edges,
    write_dcop,
)


def set_parser(subparsers) -> None:
    p = subparsers.add_parser(
        "graph_coloring", help="generate a graph-coloring DCOP"
    )
    p.add_argument(
        "--graph", choices=["random", "grid", "scalefree"], default="random"
    )
    p.add_argument("--variables_count", "-n", type=int, required=True)
    p.add_argument("--colors_count", "-c", type=int, default=3)
    p.add_argument(
        "--p_edge", "-p", type=float, default=0.2,
        help="edge probability (random graphs)",
    )
    p.add_argument(
        "--m_edge", "-m", type=int, default=2,
        help="edges per new vertex (scale-free graphs)",
    )
    p.add_argument(
        "--soft", action="store_true",
        help="random violation weights instead of unit penalties",
    )
    p.add_argument(
        "--noise", type=float, default=0.0,
        help="add per-variable noisy value preferences of this level",
    )
    p.add_argument(
        "--intentional", action="store_true",
        help="emit intentional (expression) constraints instead of "
        "extensional cost tables",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--agents_count", type=int, default=None,
        help="also generate this many agents (default: one per variable)",
    )
    p.add_argument("--capacity", type=float, default=100.0)
    p.set_defaults(func=run_cmd)


def run_cmd(args) -> int:
    return write_dcop(args, generate(args))


def generate(args):
    import numpy as np

    from pydcop_tpu_torch.dcop.dcop import DCOP
    from pydcop_tpu_torch.dcop.objects import (
        AgentDef,
        Domain,
        Variable,
        VariableNoisyCostFunc,
    )
    from pydcop_tpu_torch.dcop.relations import (
        NAryMatrixRelation,
        relation_from_str,
    )
    from pydcop_tpu_torch.utils.expressionfunction import ExpressionFunction

    rnd = random.Random(args.seed)
    n = args.variables_count
    if args.graph == "random":
        edges = random_graph_edges(rnd, n, args.p_edge)
    elif args.graph == "grid":
        side = int(round(n ** 0.5))
        if side * side != n:
            raise SystemExit(
                f"grid graphs need a square variables_count, got {n}"
            )
        edges = grid_edges(side, side)
    else:
        edges = scalefree_edges(rnd, n, args.m_edge)

    dcop = DCOP(
        f"graph_coloring_{args.graph}_{n}",
        objective="min",
        description=f"soft graph coloring, {len(edges)} edges, "
        f"{args.colors_count} colors, seed {args.seed}",
    )
    colors = Domain("colors", "color", list(range(args.colors_count)))
    variables = []
    for i in range(n):
        if args.noise > 0:
            name = f"v{i:05d}"
            v = VariableNoisyCostFunc(
                name,
                colors,
                ExpressionFunction(f"0 * {name}"),  # pure symmetry noise
                noise_level=args.noise,
            )
        else:
            v = Variable(f"v{i:05d}", colors)
        variables.append(v)
        dcop.add_variable(v)

    d = args.colors_count
    for i, j in edges:
        w = rnd.uniform(0.0, 1.0) if args.soft else 1.0
        vi, vj = variables[i], variables[j]
        name = f"c_{vi.name}_{vj.name}"
        if args.intentional:
            dcop.add_constraint(
                relation_from_str(
                    name,
                    f"{w} if {vi.name} == {vj.name} else 0",
                    [vi, vj],
                )
            )
        else:
            matrix = np.where(np.eye(d, dtype=bool), np.float32(w), 0.0)
            dcop.add_constraint(
                NAryMatrixRelation([vi, vj], matrix, name=name)
            )

    n_agents = args.agents_count if args.agents_count else n
    dcop.add_agents(
        [
            AgentDef(f"a{i:05d}", capacity=args.capacity)
            for i in range(n_agents)
        ]
    )
    return dcop
