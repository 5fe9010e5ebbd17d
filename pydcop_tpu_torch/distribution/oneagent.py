"""One-computation-per-agent distribution.

Role-equivalent to ``pydcop/distribution/oneagent.py``: the trivial
default mapping — each computation is hosted on its own agent, in order.
Fails if there are fewer agents than computations.  Capacity, hints and
footprint callbacks are ignored, as in the reference.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

from pydcop_tpu_torch.distribution.objects import (
    Distribution,
    DistributionHints,
    ImpossibleDistributionException,
)


def distribute(
    computation_graph,
    agentsdef: Iterable,
    hints: Optional[DistributionHints] = None,
    computation_memory: Optional[Callable] = None,
    communication_load: Optional[Callable] = None,
) -> Distribution:
    agents = list(agentsdef)
    nodes = computation_graph.nodes
    if len(agents) < len(nodes):
        raise ImpossibleDistributionException(
            f"oneagent needs at least as many agents as computations: "
            f"{len(agents)} agents < {len(nodes)} computations"
        )
    mapping = {a.name: [] for a in agents}
    for agent, node in zip(agents, nodes):
        mapping[agent.name].append(node.name)
    return Distribution(mapping)


def distribution_cost(
    distribution: Distribution,
    computation_graph,
    agentsdef: Iterable,
    computation_memory: Optional[Callable] = None,
    communication_load: Optional[Callable] = None,
):
    """oneagent optimizes nothing; its cost is always 0 (reference
    behavior)."""
    return 0.0, 0.0, 0.0
