"""Computation-graph builders (copies of ``pydcop_tpu/graphs/``).

Copied so far: ``graphs/objects.py`` (nodes, links, graph container),
``graphs/pseudotree.py`` (the pseudo-tree DPOP walks) and
``graphs/ordered_graph.py`` (the chain SyncBB's token walks).  The other
graph models (factor graph, constraints hypergraph) serve the host
runtimes and the distribution layer, which are not ported yet
(ROADMAP.md, items 13 and 15).
"""
