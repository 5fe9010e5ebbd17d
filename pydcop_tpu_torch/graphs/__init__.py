"""Computation-graph builders (copies of ``pydcop_tpu/graphs/``).

Only the pseudo-tree that DPOP walks is copied so far:
``graphs/objects.py`` (nodes, links, graph container) and
``graphs/pseudotree.py`` (``build_computation_graph``).  The other graph
models (factor graph, constraints hypergraph, ordered graph) serve the
host runtimes and the distribution layer, which are not ported yet
(ROADMAP.md, items 13 and 15).
"""
