"""Computation-graph builders (copies of ``pydcop_tpu/graphs/``; reference:
``pydcop/computations_graph/``).

Each graph model module exports ``GRAPH_NODE_TYPE`` and
``build_computation_graph(dcop=None, variables=None, constraints=None)``:
``factor_graph`` (Max-Sum, A-Max-Sum), ``constraints_hypergraph`` (the
local-search family), ``pseudotree`` (DPOP) and ``ordered_graph``
(SyncBB).  Graph models are loaded by name through
:func:`load_graph_module`, which the dynamic engine
(``engine/dynamic.py``) and the distribution strategies use to place an
algorithm's computations (its ``GRAPH_TYPE``) on agents.
"""

import importlib

_GRAPH_MODULES = {
    "constraints_hypergraph",
    "factor_graph",
    "pseudotree",
    "ordered_graph",
}


def load_graph_module(name: str):
    """Load a computation-graph module by name."""
    if name not in _GRAPH_MODULES:
        raise ValueError(
            f"Unknown graph model {name!r}; available: {sorted(_GRAPH_MODULES)}"
        )
    return importlib.import_module(f"pydcop_tpu_torch.graphs.{name}")


def list_available_graph_models():
    return sorted(_GRAPH_MODULES)
