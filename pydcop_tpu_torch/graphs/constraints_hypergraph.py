"""Constraints hypergraph: one computation per variable, one hyperedge
per constraint (reference: ``computations_graph/constraints_hypergraph.py``).

Used by the local-search family: DSA/A-DSA, MGM/MGM-2, DBA/GDBA.  A copy
of ``pydcop_tpu/graphs/constraints_hypergraph.py``.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.dcop.objects import Variable
from pydcop_tpu_torch.dcop.relations import RelationProtocol
from pydcop_tpu_torch.graphs.objects import ComputationGraph, ComputationNode, Link

GRAPH_NODE_TYPE = "VariableComputationNode"


class VariableComputationNode(ComputationNode):
    """A computation responsible for one decision variable, knowing the
    constraints whose scope contains it."""

    def __init__(
        self,
        variable: Variable,
        constraints: Iterable[RelationProtocol],
    ):
        super().__init__(variable.name, node_type="VariableComputationNode")
        self._variable = variable
        self._constraints = list(constraints)

    @property
    def variable(self) -> Variable:
        return self._variable

    @property
    def constraints(self) -> List[RelationProtocol]:
        return list(self._constraints)


class ConstraintLink(Link):
    """Hyperedge for one constraint, connecting its scope's computations."""

    def __init__(self, constraint_name: str, nodes):
        super().__init__(nodes, link_type="constraint_link")
        self._constraint_name = constraint_name

    @property
    def constraint_name(self) -> str:
        return self._constraint_name

    def __eq__(self, other):
        return (
            isinstance(other, ConstraintLink)
            and super().__eq__(other)
            and other._constraint_name == self._constraint_name
        )

    def __hash__(self):
        return hash((self.nodes, self.type, self._constraint_name))


def build_computation_graph(
    dcop: Optional[DCOP] = None,
    variables: Optional[Iterable[Variable]] = None,
    constraints: Optional[Iterable[RelationProtocol]] = None,
) -> ComputationGraph:
    """Build the hypergraph from a DCOP (or explicit variables+constraints)."""
    if dcop is not None:
        variables = list(dcop.variables.values())
        constraints = list(dcop.constraints.values())
    else:
        variables = list(variables or [])
        constraints = list(constraints or [])

    by_var = {v.name: [] for v in variables}
    for c in constraints:
        for vname in c.scope_names:
            if vname in by_var:
                by_var[vname].append(c)

    graph = ComputationGraph("constraints_hypergraph")
    nodes = {}
    for v in variables:
        node = VariableComputationNode(v, by_var[v.name])
        nodes[v.name] = node
        graph.add_node(node)

    for c in constraints:
        scope = [n for n in c.scope_names if n in nodes]
        link = ConstraintLink(c.name, scope)
        for vname in scope:
            nodes[vname].add_link(link)
    return graph
