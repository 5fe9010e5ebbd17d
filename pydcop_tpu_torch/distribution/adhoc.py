"""Greedy capacity-aware distribution with hints.

Role-equivalent to ``pydcop/distribution/adhoc.py``: a fast heuristic
that honors ``DistributionHints`` (``must_host``, ``host_with``) and
agent capacities, and otherwise balances load: hint-pinned computations
are placed first, then each remaining computation group goes to the
agent with the most remaining capacity that can take it.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional

from pydcop_tpu_torch.distribution.objects import (
    Distribution,
    DistributionHints,
    ImpossibleDistributionException,
)


def _footprint(node, computation_memory: Optional[Callable]) -> float:
    if computation_memory is None:
        return 0.0
    return float(computation_memory(node))


def distribute(
    computation_graph,
    agentsdef: Iterable,
    hints: Optional[DistributionHints] = None,
    computation_memory: Optional[Callable] = None,
    communication_load: Optional[Callable] = None,
) -> Distribution:
    agents = list(agentsdef)
    if not agents:
        raise ImpossibleDistributionException("No agents")
    hints = hints or DistributionHints()
    nodes = {n.name: n for n in computation_graph.nodes}
    remaining_cap: Dict[str, float] = {a.name: a.capacity for a in agents}
    placed: Dict[str, str] = {}  # computation -> agent
    mapping: Dict[str, List[str]] = {a.name: [] for a in agents}

    def place(comp: str, agent: str) -> None:
        foot = _footprint(nodes[comp], computation_memory)
        if remaining_cap[agent] < foot:
            raise ImpossibleDistributionException(
                f"Agent {agent} lacks capacity for {comp} "
                f"({remaining_cap[agent]:.1f} < {foot:.1f})"
            )
        remaining_cap[agent] -= foot
        placed[comp] = agent
        mapping[agent].append(comp)

    # 1. must_host pins
    for agent_name, comps in hints.must_host_map.items():
        if agent_name not in mapping:
            raise ImpossibleDistributionException(
                f"must_host references unknown agent {agent_name}"
            )
        for comp in comps:
            if comp in placed:
                if placed[comp] != agent_name:
                    raise ImpossibleDistributionException(
                        f"{comp} must_host on both {placed[comp]} and "
                        f"{agent_name}"
                    )
                continue
            if comp in nodes:
                place(comp, agent_name)

    # 2. host_with groups: any member already placed pins the group
    for comp in list(nodes):
        if comp in placed:
            continue
        group = [c for c in hints.host_with(comp) if c in nodes]
        if not group:
            continue
        anchor = next((placed[c] for c in group if c in placed), None)
        if anchor is not None:
            place(comp, anchor)

    # 3. everything else: largest-footprint first onto the emptiest agent
    loose = sorted(
        (c for c in nodes if c not in placed),
        key=lambda c: -_footprint(nodes[c], computation_memory),
    )
    for comp in loose:
        foot = _footprint(nodes[comp], computation_memory)
        # group mates that must follow this computation
        group = [
            c
            for c in hints.host_with(comp)
            if c in nodes and c not in placed
        ]
        group_foot = foot + sum(
            _footprint(nodes[c], computation_memory) for c in group
        )
        # most remaining capacity, then fewest hosted computations (so
        # zero-footprint problems still spread), then name for determinism
        best = max(
            remaining_cap,
            key=lambda a: (remaining_cap[a], -len(mapping[a]), a),
        )
        if remaining_cap[best] < group_foot:
            raise ImpossibleDistributionException(
                f"No agent has capacity {group_foot:.1f} for {comp} "
                f"and its host_with group"
            )
        place(comp, best)
        for c in group:
            place(c, best)

    return Distribution({a: cs for a, cs in mapping.items()})


def distribution_cost(
    distribution: Distribution,
    computation_graph,
    agentsdef: Iterable,
    computation_memory: Optional[Callable] = None,
    communication_load: Optional[Callable] = None,
):
    from pydcop_tpu_torch.distribution._cost import distribution_cost as _dc

    return _dc(
        distribution,
        computation_graph,
        agentsdef,
        computation_memory,
        communication_load,
    )
