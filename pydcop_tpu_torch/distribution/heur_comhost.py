"""Greedy communication/hosting-cost distribution heuristic.

Role-equivalent to ``pydcop/distribution/heur_comhost.py`` (the SECP
heuristic): computations are placed one at a time, highest-degree
first; each goes to the agent minimizing

    hosting_cost(agent, comp)
    + sum over already-placed neighbors n of
        communication_load(comp, n) * route(agent, agent_of(n))

subject to remaining capacity.  Deterministic (ties broken by agent
name) so placements are reproducible.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

from pydcop_tpu_torch.distribution._cost import (
    RATIO_HOST_COMM,
    distribution_cost as _dc,
)
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
    agents = {a.name: a for a in agentsdef}
    if not agents:
        raise ImpossibleDistributionException("No agents")
    nodes = {n.name: n for n in computation_graph.nodes}
    remaining: Dict[str, float] = {n: a.capacity for n, a in agents.items()}
    placed: Dict[str, str] = {}
    hints = hints or DistributionHints()

    for agent_name, comps in hints.must_host_map.items():
        for comp in comps:
            if comp in nodes and comp not in placed:
                placed[comp] = agent_name
                if computation_memory is not None:
                    remaining[agent_name] -= float(
                        computation_memory(nodes[comp])
                    )

    order = sorted(
        (c for c in nodes if c not in placed),
        key=lambda c: (-len(nodes[c].neighbors), c),
    )
    for comp in order:
        node = nodes[comp]
        foot = (
            float(computation_memory(node))
            if computation_memory is not None
            else 0.0
        )
        best_agent, best_cost = None, None
        for aname in sorted(agents):
            if remaining[aname] < foot:
                continue
            agent = agents[aname]
            cost = RATIO_HOST_COMM * agent.hosting_cost(comp)
            for nb in node.neighbors:
                if nb in placed:
                    load = (
                        float(communication_load(node, nb))
                        if communication_load is not None
                        else 1.0
                    )
                    cost += load * agent.route(placed[nb])
            if best_cost is None or cost < best_cost:
                best_agent, best_cost = aname, cost
        if best_agent is None:
            raise ImpossibleDistributionException(
                f"No agent has capacity {foot:.1f} left for {comp}"
            )
        placed[comp] = best_agent
        remaining[best_agent] -= foot

    mapping: Dict[str, list] = {a: [] for a in agents}
    for comp, agent in placed.items():
        mapping[agent].append(comp)
    return Distribution(mapping)


def distribution_cost(
    distribution,
    computation_graph,
    agentsdef,
    computation_memory=None,
    communication_load=None,
):
    return _dc(
        distribution,
        computation_graph,
        agentsdef,
        computation_memory,
        communication_load,
    )
