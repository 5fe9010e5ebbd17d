"""``pydcop_tpu_torch replica_dist`` (a copy of
``pydcop_tpu/commands/replica_dist.py``; reference:
``pydcop/commands/replica_dist.py``).

Compute a k-resilient replica placement offline: place the computations
with a distribution strategy, then place k replicas of each via
uniform-cost search over hosting + route costs.
"""

from __future__ import annotations


def set_parser(subparsers) -> None:
    p = subparsers.add_parser(
        "replica_dist", help="compute k-resilient replica placement"
    )
    p.add_argument("dcop_files", nargs="+", help="dcop yaml file(s)")
    p.add_argument("-k", "--ktarget", type=int, required=True)
    p.add_argument(
        "-a", "--algo", required=True,
        help="algorithm (graph model + footprints)",
    )
    p.add_argument(
        "-d", "--distribution", default="oneagent",
        help="distribution strategy or distribution yaml for the "
        "primary placement",
    )
    p.set_defaults(func=run_cmd)


def run_cmd(args) -> int:
    import os

    import yaml

    from pydcop_tpu_torch.algorithms import load_algorithm_module
    from pydcop_tpu_torch.commands._common import write_result
    from pydcop_tpu_torch.dcop.yamldcop import load_dcop_from_file
    from pydcop_tpu_torch.distribution.objects import Distribution
    from pydcop_tpu_torch.graphs import load_graph_module
    from pydcop_tpu_torch.replication import replica_distribution

    module = load_algorithm_module(args.algo)
    dcop = load_dcop_from_file(
        args.dcop_files if len(args.dcop_files) > 1 else args.dcop_files[0]
    )
    graph = load_graph_module(module.GRAPH_TYPE).build_computation_graph(dcop)
    computation_memory = getattr(module, "computation_memory", None)
    nodes = {n.name: n for n in graph.nodes}

    if os.path.isfile(args.distribution):
        with open(args.distribution) as f:
            dist = Distribution(yaml.safe_load(f)["distribution"])
    else:
        from pydcop_tpu_torch.distribution import compute_distribution

        dist = compute_distribution(
            args.distribution,
            graph,
            dcop.agents.values(),
            hints=dcop.dist_hints,
            algo_module=module,
            computation_memory=computation_memory,
        )

    def footprint(comp: str) -> float:
        if computation_memory is None or comp not in nodes:
            return 1.0
        return float(computation_memory(nodes[comp]))

    replicas = replica_distribution(
        dist, dcop.agents.values(), args.ktarget, footprint=footprint
    )
    write_result(
        args,
        {
            "distribution": dist.mapping,
            "replica_distribution": replicas.mapping,
            "ktarget": args.ktarget,
        },
    )
    return 0
