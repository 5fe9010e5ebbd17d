"""Shared distribution-cost evaluation.

The cost of a placement, as the reference's hosting-cost distributions
define it: ``comm + RATIO_HOST_COMM * hosting`` where ``comm`` sums
``communication_load(link) * route(agent_i, agent_j)`` over graph links
whose endpoints land on different agents, and ``hosting`` sums each
agent's hosting cost for the computations it hosts.
"""

from __future__ import annotations

from itertools import combinations
from typing import Callable, Iterable, Optional, Tuple

# Same trade-off ratio the reference uses between hosting and
# communication objectives in its hosting-cost-aware distributions.
RATIO_HOST_COMM = 0.8


def distribution_cost(
    distribution,
    computation_graph,
    agentsdef: Iterable,
    computation_memory: Optional[Callable] = None,
    communication_load: Optional[Callable] = None,
) -> Tuple[float, float, float]:
    """Return ``(total, communication, hosting)`` for a placement."""
    agents = {a.name: a for a in agentsdef}
    nodes = {n.name: n for n in computation_graph.nodes}

    comm = 0.0
    if communication_load is not None:
        for link in computation_graph.links:
            members = [n for n in link.nodes if n in nodes]
            for c1, c2 in combinations(members, 2):
                if not (
                    distribution.has_computation(c1)
                    and distribution.has_computation(c2)
                ):
                    continue
                a1 = distribution.agent_for(c1)
                a2 = distribution.agent_for(c2)
                if a1 == a2:
                    continue
                load = float(communication_load(nodes[c1], c2))
                comm += load * agents[a1].route(a2)

    hosting = 0.0
    for comp in distribution.computations:
        agent = agents[distribution.agent_for(comp)]
        hosting += agent.hosting_cost(comp)

    total = comm + RATIO_HOST_COMM * hosting
    return total, comm, hosting
