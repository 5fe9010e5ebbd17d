"""Pseudo-tree construction for DPOP
(reference: ``computations_graph/pseudotree.py``; a copy of
``pydcop_tpu/graphs/pseudotree.py``).

A DFS traversal of the primal constraint graph yields a pseudo-tree:
tree edges (parent/children) plus back edges (pseudo-parents toward
ancestors, pseudo-children toward descendants).  Every constraint
connects variables on one root-to-leaf branch, which is what makes the
UTIL dynamic programming correct.

Construction is host-side (setup time); the DPOP UTIL/VALUE phases then
run as shaped tensor ops (see ``pydcop_tpu_torch.algorithms.dpop``).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Set, Tuple

from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.dcop.objects import Variable
from pydcop_tpu_torch.dcop.relations import RelationProtocol
from pydcop_tpu_torch.graphs.objects import ComputationGraph, ComputationNode, Link

GRAPH_NODE_TYPE = "PseudoTreeNode"


class PseudoTreeLink(Link):
    """Typed link: ``tree`` (parent↔child) or ``back`` (pseudo)."""

    def __init__(self, link_type: str, source: str, target: str):
        super().__init__([source, target], link_type=link_type)
        self._source = source
        self._target = target

    @property
    def source(self) -> str:
        return self._source

    @property
    def target(self) -> str:
        return self._target


class PseudoTreeNode(ComputationNode):
    """One variable's node in the pseudo-tree."""

    def __init__(
        self,
        variable: Variable,
        constraints: Iterable[RelationProtocol],
    ):
        super().__init__(variable.name, node_type="PseudoTreeNode")
        self._variable = variable
        self._constraints = list(constraints)
        self.parent: Optional[str] = None
        self.pseudo_parents: List[str] = []
        self.children: List[str] = []
        self.pseudo_children: List[str] = []

    @property
    def variable(self) -> Variable:
        return self._variable

    @property
    def constraints(self) -> List[RelationProtocol]:
        return list(self._constraints)

    @property
    def is_root(self) -> bool:
        return self.parent is None

    @property
    def is_leaf(self) -> bool:
        return not self.children


class PseudoTreeGraph(ComputationGraph):
    """ComputationGraph specialisation exposing roots and separators."""

    def __init__(self):
        super().__init__("pseudotree")
        self.roots: List[str] = []

    def node(self, name: str) -> PseudoTreeNode:  # narrowed type
        return super().node(name)  # type: ignore[return-value]

    def separator(self, name: str) -> List[str]:
        """Separator of a node: its parent plus pseudo-parents — the set
        of ancestors its UTIL message depends on.  UTIL table width is
        d^len(separator) (exponential in induced width)."""
        n = self.node(name)
        sep = ([] if n.parent is None else [n.parent]) + list(n.pseudo_parents)
        return sep

    def depth_first_order(self, root: str) -> List[str]:
        """Nodes of one tree in DFS pre-order (children order stable)."""
        order: List[str] = []
        stack = [root]
        while stack:
            cur = stack.pop()
            order.append(cur)
            stack.extend(reversed(self.node(cur).children))
        return order


def _primal_adjacency(
    variables: List[Variable], constraints: List[RelationProtocol]
) -> Dict[str, Set[str]]:
    adj: Dict[str, Set[str]] = {v.name: set() for v in variables}
    for c in constraints:
        scope = [n for n in c.scope_names if n in adj]
        for a in scope:
            for b in scope:
                if a != b:
                    adj[a].add(b)
    return adj


def build_computation_graph(
    dcop: Optional[DCOP] = None,
    variables: Optional[Iterable[Variable]] = None,
    constraints: Optional[Iterable[RelationProtocol]] = None,
    root: Optional[str] = None,
) -> PseudoTreeGraph:
    """DFS pseudo-tree build.

    Root selection: the given ``root``, else the highest-degree variable
    of each connected component (a standard heuristic that tends to
    reduce tree depth).  Disconnected problems produce a forest (one root
    per component), matching reference behavior.
    """
    if dcop is not None:
        variables = list(dcop.variables.values())
        constraints = list(dcop.constraints.values())
    else:
        variables = list(variables or [])
        constraints = list(constraints or [])

    by_var: Dict[str, List[RelationProtocol]] = {
        v.name: [] for v in variables
    }
    for c in constraints:
        for vname in c.scope_names:
            if vname in by_var:
                by_var[vname].append(c)

    adj = _primal_adjacency(variables, constraints)

    graph = PseudoTreeGraph()
    nodes: Dict[str, PseudoTreeNode] = {}
    for v in variables:
        node = PseudoTreeNode(v, by_var[v.name])
        nodes[v.name] = node
        graph.add_node(node)

    visited: Set[str] = set()
    # deterministic component iteration: sort by (-degree, name)
    candidates = sorted(adj, key=lambda n: (-len(adj[n]), n))
    if root is not None:
        if root not in adj:
            raise ValueError(f"Unknown root variable {root!r}")
        candidates = [root] + [c for c in candidates if c != root]

    for start in candidates:
        if start in visited:
            continue
        graph.roots.append(start)
        # iterative DFS with ancestor tracking
        visited.add(start)
        in_progress: Dict[str, List[str]] = {
            start: sorted(adj[start], key=lambda n: (-len(adj[n]), n))
        }
        ancestors: List[str] = [start]
        while ancestors:
            cur = ancestors[-1]
            todo = in_progress[cur]
            advanced = False
            while todo:
                nxt = todo.pop(0)
                if nxt not in visited:
                    # tree edge
                    visited.add(nxt)
                    nodes[nxt].parent = cur
                    nodes[cur].children.append(nxt)
                    link = PseudoTreeLink("tree", cur, nxt)
                    nodes[cur].add_link(link)
                    nodes[nxt].add_link(link)
                    in_progress[nxt] = sorted(
                        adj[nxt], key=lambda n: (-len(adj[n]), n)
                    )
                    ancestors.append(nxt)
                    advanced = True
                    break
                elif nxt in ancestors and nxt != nodes[cur].parent:
                    # back edge to a strict ancestor → pseudo relation
                    if nxt not in nodes[cur].pseudo_parents:
                        nodes[cur].pseudo_parents.append(nxt)
                        nodes[nxt].pseudo_children.append(cur)
                        link = PseudoTreeLink("back", cur, nxt)
                        nodes[cur].add_link(link)
                        nodes[nxt].add_link(link)
                # else: cross/forward edge already handled from the
                # other endpoint (it was on the stack then), or the
                # plain tree edge back to the parent — skip
            if not advanced:
                ancestors.pop()
    return graph
