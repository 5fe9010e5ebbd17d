"""Factor graph: bipartite variable/factor computations
(reference: ``computations_graph/factor_graph.py``).

A copy of ``pydcop_tpu/graphs/factor_graph.py``.  Used by Max-Sum /
A-Max-Sum: the dynamic engine places its nodes on agents
(``engine/dynamic.py``), and in the batched engine the edges of this
graph are the directed-edge message arrays (``[d, E]``) the Max-Sum
kernels update each round.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.dcop.objects import Variable
from pydcop_tpu_torch.dcop.relations import RelationProtocol
from pydcop_tpu_torch.graphs.objects import ComputationGraph, ComputationNode, Link

GRAPH_NODE_TYPE = "factor_graph_node"


class VariableComputationNode(ComputationNode):
    def __init__(self, variable: Variable):
        super().__init__(variable.name, node_type="VariableComputationNode")
        self._variable = variable

    @property
    def variable(self) -> Variable:
        return self._variable


class FactorComputationNode(ComputationNode):
    def __init__(self, factor: RelationProtocol):
        super().__init__(factor.name, node_type="FactorComputationNode")
        self._factor = factor

    @property
    def factor(self) -> RelationProtocol:
        return self._factor

    @property
    def variables(self) -> List[Variable]:
        return self._factor.dimensions


class FactorGraphLink(Link):
    """Edge between one factor and one variable computation."""

    def __init__(self, factor_name: str, variable_name: str):
        super().__init__([factor_name, variable_name], link_type="factor_link")
        self._factor_name = factor_name
        self._variable_name = variable_name

    @property
    def factor_name(self) -> str:
        return self._factor_name

    @property
    def variable_name(self) -> str:
        return self._variable_name


def build_computation_graph(
    dcop: Optional[DCOP] = None,
    variables: Optional[Iterable[Variable]] = None,
    constraints: Optional[Iterable[RelationProtocol]] = None,
) -> ComputationGraph:
    if dcop is not None:
        variables = list(dcop.variables.values())
        constraints = list(dcop.constraints.values())
    else:
        variables = list(variables or [])
        constraints = list(constraints or [])

    graph = ComputationGraph("factor_graph")
    var_nodes = {}
    for v in variables:
        node = VariableComputationNode(v)
        var_nodes[v.name] = node
        graph.add_node(node)

    for c in constraints:
        fnode = FactorComputationNode(c)
        graph.add_node(fnode)
        for vname in c.scope_names:
            if vname not in var_nodes:
                continue
            link = FactorGraphLink(c.name, vname)
            fnode.add_link(link)
            var_nodes[vname].add_link(link)
    return graph
