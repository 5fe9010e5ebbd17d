"""Generic graph helpers (reference: ``pydcop/utils/graphs.py``); a copy
of ``pydcop_tpu/utils/graphs.py``.

Operates on the *primal constraint graph* of a DCOP — one vertex per
variable, one edge per pair of variables sharing a constraint — which
is what the reference's helpers (cycle detection, diameter, networkx
export) are used for by the graph builders and distribution layer.

All functions accept either a DCOP (its constraints define the edges)
or an explicit adjacency mapping ``{vertex: iterable-of-neighbors}``.
"""

from __future__ import annotations

from collections import deque
from itertools import combinations
from typing import Any, Dict, Hashable, Iterable, List, Mapping, Set


def as_adjacency(graph) -> Dict[Hashable, Set[Hashable]]:
    """Normalize a DCOP or an adjacency mapping to ``{v: set(nbrs)}``,
    symmetrized."""
    if hasattr(graph, "constraints") and hasattr(graph, "variables"):
        adj: Dict[Hashable, Set[Hashable]] = {
            name: set() for name in graph.variables
        }
        for c in graph.constraints.values():
            names = [n for n in c.scope_names if n in adj]
            for a, b in combinations(names, 2):
                adj[a].add(b)
                adj[b].add(a)
        return adj
    adj = {v: set(nbrs) for v, nbrs in graph.items()}
    for v, nbrs in list(adj.items()):
        for n in nbrs:
            adj.setdefault(n, set()).add(v)
    return adj


def has_cycle(graph) -> bool:
    """True iff the (undirected) graph contains a cycle."""
    adj = as_adjacency(graph)
    seen: Set[Hashable] = set()
    for start in adj:
        if start in seen:
            continue
        # BFS forest; a visited non-parent neighbor closes a cycle
        parent: Dict[Hashable, Any] = {start: None}
        queue = deque([start])
        seen.add(start)
        while queue:
            v = queue.popleft()
            for n in adj[v]:
                if n == parent[v]:
                    continue
                if n in seen:
                    return True
                seen.add(n)
                parent[n] = v
                queue.append(n)
    return False


def connected_components(graph) -> List[Set[Hashable]]:
    adj = as_adjacency(graph)
    seen: Set[Hashable] = set()
    comps: List[Set[Hashable]] = []
    for start in adj:
        if start in seen:
            continue
        comp: Set[Hashable] = set()
        queue = deque([start])
        seen.add(start)
        while queue:
            v = queue.popleft()
            comp.add(v)
            for n in adj[v]:
                if n not in seen:
                    seen.add(n)
                    queue.append(n)
        comps.append(comp)
    return comps


def _eccentricity(adj, start) -> int:
    dist = {start: 0}
    queue = deque([start])
    far = 0
    while queue:
        v = queue.popleft()
        for n in adj[v]:
            if n not in dist:
                dist[n] = dist[v] + 1
                far = max(far, dist[n])
                queue.append(n)
    if len(dist) != len(adj):
        raise ValueError(
            "diameter is undefined on a disconnected graph "
            f"({len(connected_components(adj))} components)"
        )
    return far


def graph_diameter(graph) -> int:
    """Longest shortest path (hop count); raises on disconnected input."""
    adj = as_adjacency(graph)
    if not adj:
        return 0
    return max(_eccentricity(adj, v) for v in adj)


def cycles_count(graph) -> int:
    """Independent cycles: |E| - |V| + #components (circuit rank)."""
    adj = as_adjacency(graph)
    n_edges = sum(len(nbrs) for nbrs in adj.values()) // 2
    return n_edges - len(adj) + len(connected_components(adj))


def as_networkx_graph(graph):
    """Export to a ``networkx.Graph`` (used for plotting/analysis)."""
    import networkx as nx

    adj = as_adjacency(graph)
    g = nx.Graph()
    g.add_nodes_from(adj)
    for v, nbrs in adj.items():
        for n in nbrs:
            g.add_edge(v, n)
    return g


def as_bipartite_networkx_graph(dcop):
    """Factor-graph export: variable and constraint vertices with
    bipartite labels (variables 0, constraints 1)."""
    import networkx as nx

    g = nx.Graph()
    for name in dcop.variables:
        g.add_node(name, bipartite=0)
    for cname, c in dcop.constraints.items():
        g.add_node(cname, bipartite=1)
        for vname in c.scope_names:
            g.add_edge(cname, vname)
    return g
