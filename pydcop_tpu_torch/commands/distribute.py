"""``pydcop_tpu_torch distribute`` (a copy of
``pydcop_tpu/commands/distribute.py``; reference:
``pydcop/commands/distribute.py``).

Compute a computation → agent placement offline and print it as JSON
with its cost under the strategy's objective.  With ``--output`` the
reference-style ``distribution:`` yaml mapping is written to the file
(the JSON result still goes to stdout).
"""

from __future__ import annotations

import json

from pydcop_tpu_torch.commands._common import load_dcop_and_graph


def set_parser(subparsers) -> None:
    p = subparsers.add_parser(
        "distribute",
        help="compute a computation→agent placement "
        "(--output writes the yaml mapping, JSON goes to stdout)",
    )
    p.add_argument("dcop_files", nargs="+", help="dcop yaml file(s)")
    p.add_argument(
        "-d", "--distribution", required=True,
        help="distribution strategy (oneagent | adhoc | heur_comhost | "
        "ilp_fgdp | ilp_compref)",
    )
    p.add_argument(
        "-g", "--graph",
        help="graph model; required unless --algo is given",
    )
    p.add_argument(
        "-a", "--algo",
        help="algorithm name; picks the graph model and provides the "
        "memory/communication footprint callbacks",
    )
    p.set_defaults(func=run_cmd)


def run_cmd(args) -> int:
    import yaml

    from pydcop_tpu_torch.distribution import (
        ImpossibleDistributionException,
        load_distribution_module,
    )

    try:
        dcop, graph, _model, algo_module = load_dcop_and_graph(args)
        dist_module = load_distribution_module(args.distribution)

        computation_memory = getattr(algo_module, "computation_memory", None)
        communication_load = getattr(algo_module, "communication_load", None)
        from pydcop_tpu_torch.distribution import compute_distribution

        distribution = compute_distribution(
            dist_module,
            graph,
            dcop.agents.values(),
            hints=dcop.dist_hints,
            computation_memory=computation_memory,
            communication_load=communication_load,
        )
    except (ValueError, ImpossibleDistributionException) as e:
        raise SystemExit(f"distribute: {e}")

    result = {"distribution": distribution.mapping}
    if hasattr(dist_module, "distribution_cost"):
        total, comm, hosting = dist_module.distribution_cost(
            distribution,
            graph,
            dcop.agents.values(),
            computation_memory,
            communication_load,
        )
        result["cost"] = total
        result["communication_cost"] = comm
        result["hosting_cost"] = hosting

    if args.output:
        with open(args.output, "w") as f:
            yaml.safe_dump({"distribution": distribution.mapping}, f)
    print(json.dumps(result, indent=2, default=str))
    return 0
