"""k-resilient replica placement by uniform-cost search over the agent
graph.

Role-equivalent to ``pydcop/replication/dist_ucs_hostingcosts.py``
(DRPM): for each active computation, place ``k`` replicas on agents
other than its host, minimizing ``route-path cost from the host`` +
``hosting cost on the target``, subject to agent capacity.

The reference runs this as a *distributed* uniform-cost search (each
agent expands its cheapest frontier edge and forwards the search token).
A uniform-cost search explores states in nondecreasing path-cost order
regardless of which process expands them, so the distributed run and
this host-side Dijkstra visit the same agents at the same costs and
select the same replica sites (ties broken by agent name, as the
reference breaks them by lexical computation/agent order).  The control
plane is host-side, so we keep the semantics and drop the token
protocol.  A copy of ``pydcop_tpu/replication/ucs_hostingcosts.py``.
"""

from __future__ import annotations

import heapq
from typing import Callable, Dict, Iterable, List, Mapping, Optional

from pydcop_tpu_torch.utils.simple_repr import SimpleRepr


class ReplicaDistribution(SimpleRepr):
    """Mapping computation name → list of agents hosting its replicas."""

    def __init__(self, mapping: Mapping[str, Iterable[str]]):
        self._mapping: Dict[str, List[str]] = {
            c: list(agents) for c, agents in mapping.items()
        }

    def replicas(self, computation: str) -> List[str]:
        return list(self._mapping.get(computation, []))

    def agents_for(self, computation: str) -> List[str]:
        return self.replicas(computation)

    @property
    def mapping(self) -> Dict[str, List[str]]:
        return {c: list(a) for c, a in self._mapping.items()}

    @property
    def computations(self) -> List[str]:
        return list(self._mapping)

    def __eq__(self, other):
        return (
            isinstance(other, ReplicaDistribution)
            and other._mapping == self._mapping
        )

    def __repr__(self) -> str:
        return f"ReplicaDistribution({self._mapping})"

    def _simple_repr(self) -> dict:
        from pydcop_tpu_torch.utils.simple_repr import _CLASS_KEY, _MODULE_KEY, simple_repr

        return {
            _CLASS_KEY: type(self).__qualname__,
            _MODULE_KEY: type(self).__module__,
            "mapping": simple_repr(self._mapping),
        }

    @classmethod
    def _from_repr(cls, r: dict):
        from pydcop_tpu_torch.utils.simple_repr import from_repr

        return cls(from_repr(r["mapping"]))


def _route_dijkstra(
    source: str, agents: Mapping[str, "AgentDef"]
) -> Dict[str, float]:
    """Cheapest route-path cost from ``source`` to every other agent
    (routes may make multi-hop paths cheaper than the direct edge)."""
    dist = {source: 0.0}
    heap = [(0.0, source)]
    done = set()
    while heap:
        d, a = heapq.heappop(heap)
        if a in done:
            continue
        done.add(a)
        for b, agent_b in agents.items():
            if b == a or b in done:
                continue
            nd = d + agents[a].route(b)
            if nd < dist.get(b, float("inf")):
                dist[b] = nd
                heapq.heappush(heap, (nd, b))
    return dist


def replica_distribution(
    distribution,
    agentsdef: Iterable,
    k: int,
    computations: Optional[Iterable[str]] = None,
    footprint: Optional[Callable[[str], float]] = None,
) -> ReplicaDistribution:
    """Place ``k`` replicas of each computation.

    Parameters
    ----------
    distribution:
        The active :class:`~pydcop_tpu_torch.distribution.objects.Distribution`
        (gives each computation's current host).
    agentsdef:
        Live agents (hosting costs / routes / capacity).
    k:
        Resilience level: replicas per computation (k-resilience means
        the system survives any k simultaneous agent departures).
    computations:
        Which computations to replicate (default: all placed ones).
    footprint:
        Optional ``computation name -> memory`` callable; replicas
        consume capacity left after the agent's own hosted computations.
    """
    agents = {a.name: a for a in agentsdef}
    comps = sorted(
        computations if computations is not None else distribution.computations
    )
    foot = footprint or (lambda c: 0.0)

    remaining: Dict[str, float] = {}
    for name, agent in agents.items():
        hosted = (
            distribution.computations_hosted(name)
            if name in distribution.agents
            else []
        )
        remaining[name] = agent.capacity - sum(foot(c) for c in hosted)

    path_costs: Dict[str, Dict[str, float]] = {}
    mapping: Dict[str, List[str]] = {}
    for comp in comps:
        host = (
            distribution.agent_for(comp)
            if distribution.has_computation(comp)
            else None
        )
        if host not in agents:
            # hostless computation: replicate from the cheapest agent
            host = min(agents) if agents else None
        if host is None:
            mapping[comp] = []
            continue
        if host not in path_costs:
            path_costs[host] = _route_dijkstra(host, agents)
        dists = path_costs[host]
        candidates = sorted(
            (
                (
                    dists.get(a, float("inf"))
                    + agents[a].hosting_cost(comp),
                    a,
                )
                for a in agents
                if a != host and remaining[a] >= foot(comp)
            ),
        )
        chosen = [a for _, a in candidates[:k]]
        for a in chosen:
            remaining[a] -= foot(comp)
        mapping[comp] = chosen
    return ReplicaDistribution(mapping)
