"""Computation-graph abstraction: nodes, links, graph container.

A copy of ``pydcop_tpu/graphs/objects.py`` (the port imports nothing of
the JAX package).  Role-equivalent to
``pydcop/computations_graph/objects.py``: a ``ComputationGraph`` holds named ``ComputationNode``s connected by typed
``Link``s (links may be hyperedges).  Algorithm modules attach footprint
callbacks; the distribution layer consumes the topology.

DPOP (``pydcop_tpu_torch.algorithms.dpop``) walks the pseudo-tree built
on these classes (``graphs/pseudotree.py``).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Set

from pydcop_tpu_torch.utils.simple_repr import SimpleRepr


class Link(SimpleRepr):
    """A (hyper)edge between computation nodes, identified by names."""

    def __init__(self, nodes: Sequence[str], link_type: str = "link"):
        self._nodes = tuple(sorted(nodes))
        self._link_type = link_type

    @property
    def nodes(self) -> Sequence[str]:
        return self._nodes

    @property
    def type(self) -> str:
        return self._link_type

    def has_node(self, name: str) -> bool:
        return name in self._nodes

    def __eq__(self, other):
        return (
            isinstance(other, Link)
            and other._nodes == self._nodes
            and other._link_type == self._link_type
        )

    def __hash__(self):
        return hash((self._nodes, self._link_type))

    def __repr__(self) -> str:
        return f"Link({list(self._nodes)}, {self._link_type!r})"

    def _simple_repr(self) -> dict:
        from pydcop_tpu_torch.utils.simple_repr import _CLASS_KEY, _MODULE_KEY

        return {
            _CLASS_KEY: type(self).__qualname__,
            _MODULE_KEY: type(self).__module__,
            "nodes": list(self._nodes),
            "link_type": self._link_type,
        }

    @classmethod
    def _from_repr(cls, r: dict):
        return cls(r["nodes"], r.get("link_type", "link"))


class ComputationNode(SimpleRepr):
    """A named unit of computation in the graph.

    ``node_type`` distinguishes roles within one graph model (e.g.
    ``VariableComputationNode`` vs ``FactorComputationNode`` in a factor
    graph).  Subclasses carry model objects (variable, constraints).
    """

    def __init__(
        self,
        name: str,
        node_type: str = "computation",
        links: Optional[Iterable[Link]] = None,
    ):
        self._name = name
        self._node_type = node_type
        self._links = list(links) if links else []

    @property
    def name(self) -> str:
        return self._name

    @property
    def type(self) -> str:
        return self._node_type

    @property
    def links(self) -> List[Link]:
        return list(self._links)

    def add_link(self, link: Link) -> None:
        self._links.append(link)

    @property
    def neighbors(self) -> List[str]:
        out: List[str] = []
        seen: Set[str] = {self._name}
        for l in self._links:
            for n in l.nodes:
                if n not in seen:
                    seen.add(n)
                    out.append(n)
        return out

    def __eq__(self, other):
        return (
            isinstance(other, ComputationNode)
            and other._name == self._name
            and other._node_type == self._node_type
        )

    def __hash__(self):
        return hash((self._name, self._node_type))

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self._name!r})"


class ComputationGraph:
    """Container of nodes + links for one graph model instance."""

    def __init__(
        self,
        graph_type: str,
        nodes: Optional[Iterable[ComputationNode]] = None,
    ):
        self._graph_type = graph_type
        self._nodes: Dict[str, ComputationNode] = {}
        for n in nodes or ():
            self.add_node(n)

    @property
    def graph_type(self) -> str:
        return self._graph_type

    def add_node(self, node: ComputationNode) -> None:
        if node.name in self._nodes:
            raise ValueError(f"Duplicate computation node {node.name}")
        self._nodes[node.name] = node

    @property
    def nodes(self) -> List[ComputationNode]:
        return list(self._nodes.values())

    def node(self, name: str) -> ComputationNode:
        return self._nodes[name]

    def __contains__(self, name: str) -> bool:
        return name in self._nodes

    @property
    def links(self) -> List[Link]:
        seen: Set[Link] = set()
        out: List[Link] = []
        for n in self._nodes.values():
            for l in n.links:
                if l not in seen:
                    seen.add(l)
                    out.append(l)
        return out

    def computations(self) -> List[ComputationNode]:
        return self.nodes

    def density(self) -> float:
        """2·|links| / (|nodes|·(|nodes|−1)) — same definition the
        reference's ``pydcop graph`` command reports."""
        n = len(self._nodes)
        if n < 2:
            return 0.0
        return 2 * len(self.links) / (n * (n - 1))

    def __repr__(self) -> str:
        return (
            f"ComputationGraph({self._graph_type!r}, "
            f"{len(self._nodes)} nodes, {len(self.links)} links)"
        )
