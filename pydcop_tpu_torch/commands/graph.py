"""``pydcop_tpu_torch graph`` (a copy of ``pydcop_tpu/commands/graph.py``;
reference: ``pydcop/commands/graph.py``).

Build the computation graph for a DCOP and print node/edge/density
statistics as JSON.
"""

from __future__ import annotations

from pydcop_tpu_torch.commands._common import write_result


def set_parser(subparsers) -> None:
    p = subparsers.add_parser(
        "graph", help="compute computation-graph statistics for a dcop"
    )
    p.add_argument("dcop_files", nargs="+", help="dcop yaml file(s)")
    p.add_argument(
        "-g", "--graph",
        help="graph model (constraints_hypergraph | factor_graph | "
        "pseudotree | ordered_graph)",
    )
    p.add_argument(
        "-a", "--algo",
        help="algorithm name (used to pick the graph model if -g absent)",
    )
    p.add_argument(
        "--display", action="store_true",
        help="also dump the full node/link lists",
    )
    p.set_defaults(func=run_cmd)


def run_cmd(args) -> int:
    from pydcop_tpu_torch.commands._common import load_dcop_and_graph

    _dcop, g, graph_model, _algo = load_dcop_and_graph(args)
    result = {
        "graph": graph_model,
        "nodes": len(g.nodes),
        "links": len(g.links),
        "density": g.density(),
    }
    if args.display:
        result["node_list"] = [n.name for n in g.nodes]
        result["link_list"] = [
            {"type": l.type, "nodes": list(l.nodes)} for l in g.links
        ]
    write_result(args, result)
    return 0
