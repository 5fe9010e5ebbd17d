"""Ordered (chain) graph for SyncBB (a copy of
``pydcop_tpu/graphs/ordered_graph.py``).

A total ordering of the variables; each node links to its predecessor
and successor.  The branch-and-bound token walks this chain.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.dcop.objects import Variable
from pydcop_tpu_torch.dcop.relations import RelationProtocol
from pydcop_tpu_torch.graphs.objects import ComputationGraph, ComputationNode, Link

GRAPH_NODE_TYPE = "OrderedVariableNode"


class OrderedVariableNode(ComputationNode):
    def __init__(
        self,
        variable: Variable,
        constraints: Iterable[RelationProtocol],
        position: int,
    ):
        super().__init__(variable.name, node_type="OrderedVariableNode")
        self._variable = variable
        self._constraints = list(constraints)
        self._position = position
        # chain neighbors by DIRECTION (Link sorts its endpoints, so
        # the ordering cannot be recovered from links alone); set by
        # build_computation_graph, consumed by the SyncBB token walk
        self.prev: Optional[str] = None
        self.next: Optional[str] = None

    @property
    def variable(self) -> Variable:
        return self._variable

    @property
    def constraints(self) -> List[RelationProtocol]:
        return list(self._constraints)

    @property
    def position(self) -> int:
        return self._position


class OrderedGraph(ComputationGraph):
    def __init__(self, ordering: List[str]):
        super().__init__("ordered_graph")
        self.ordering = list(ordering)

    def next_node(self, name: str) -> Optional[str]:
        i = self.ordering.index(name)
        return self.ordering[i + 1] if i + 1 < len(self.ordering) else None

    def previous_node(self, name: str) -> Optional[str]:
        i = self.ordering.index(name)
        return self.ordering[i - 1] if i > 0 else None


def build_computation_graph(
    dcop: Optional[DCOP] = None,
    variables: Optional[Iterable[Variable]] = None,
    constraints: Optional[Iterable[RelationProtocol]] = None,
    ordering: Optional[List[str]] = None,
) -> OrderedGraph:
    """Chain the variables, by default in lexicographic name order."""
    if dcop is not None:
        variables = list(dcop.variables.values())
        constraints = list(dcop.constraints.values())
    else:
        variables = list(variables or [])
        constraints = list(constraints or [])

    by_name: Dict[str, Variable] = {v.name: v for v in variables}
    if ordering is None:
        ordering = sorted(by_name)
    else:
        missing = set(by_name) - set(ordering)
        if missing:
            raise ValueError(f"Ordering misses variable(s) {sorted(missing)}")
        unknown = set(ordering) - set(by_name)
        if unknown:
            raise ValueError(
                f"Ordering contains unknown variable(s) {sorted(unknown)}"
            )

    by_var: Dict[str, List[RelationProtocol]] = {n: [] for n in by_name}
    for c in constraints:
        for vname in c.scope_names:
            if vname in by_var:
                by_var[vname].append(c)

    graph = OrderedGraph(ordering)
    nodes = []
    for i, vname in enumerate(ordering):
        node = OrderedVariableNode(by_name[vname], by_var[vname], i)
        nodes.append(node)
        graph.add_node(node)
    for a, b in zip(nodes, nodes[1:]):
        link = Link([a.name, b.name], link_type="ordering")
        a.add_link(link)
        b.add_link(link)
        a.next = b.name
        b.prev = a.name
    return graph
