"""Distribution (computation → agent placement) data objects.

Role-equivalent to ``pydcop/distribution/objects.py``: ``Distribution``
(the mapping), ``DistributionHints`` (yaml ``distribution_hints``), and
the exception raised when no valid placement exists.  A copy of
``pydcop_tpu/distribution/objects.py``; ``dcop/yamldcop.py`` reads
``distribution_hints`` sections into ``DistributionHints``.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Optional

from pydcop_tpu_torch.utils.simple_repr import SimpleRepr


class ImpossibleDistributionException(Exception):
    pass


class DistributionHints(SimpleRepr):
    """Placement hints from the problem yaml: ``must_host`` (agent →
    computations it must host) and ``host_with`` (computation →
    computations that must share its agent)."""

    def __init__(
        self,
        must_host: Optional[Mapping[str, List[str]]] = None,
        host_with: Optional[Mapping[str, List[str]]] = None,
    ):
        self._must_host = {k: list(v) for k, v in (must_host or {}).items()}
        self._host_with = {k: list(v) for k, v in (host_with or {}).items()}

    def must_host(self, agent_name: str) -> List[str]:
        return list(self._must_host.get(agent_name, []))

    def host_with(self, computation_name: str) -> List[str]:
        """Transitive closure of the host_with relation for a computation."""
        group = {computation_name}
        frontier = [computation_name]
        while frontier:
            c = frontier.pop()
            for other, mates in self._host_with.items():
                linked = set(mates) | {other}
                if c in linked:
                    new = linked - group
                    group |= new
                    frontier.extend(new)
        group.discard(computation_name)
        return sorted(group)

    @property
    def must_host_map(self) -> Dict[str, List[str]]:
        return {k: list(v) for k, v in self._must_host.items()}

    @property
    def host_with_map(self) -> Dict[str, List[str]]:
        return {k: list(v) for k, v in self._host_with.items()}

    def _simple_repr(self) -> dict:
        from pydcop_tpu_torch.utils.simple_repr import _CLASS_KEY, _MODULE_KEY, simple_repr

        return {
            _CLASS_KEY: type(self).__qualname__,
            _MODULE_KEY: type(self).__module__,
            "must_host": simple_repr(self._must_host),
            "host_with": simple_repr(self._host_with),
        }

    @classmethod
    def _from_repr(cls, r: dict):
        from pydcop_tpu_torch.utils.simple_repr import from_repr

        return cls(
            from_repr(r.get("must_host", {})) or {},
            from_repr(r.get("host_with", {})) or {},
        )


class Distribution(SimpleRepr):
    """A mapping computation name → agent name.

    >>> d = Distribution({'a1': ['v1', 'v2'], 'a2': ['v3']})
    >>> d.agent_for('v3')
    'a2'
    """

    def __init__(self, mapping: Mapping[str, Iterable[str]]):
        self._mapping: Dict[str, List[str]] = {
            a: list(comps) for a, comps in mapping.items()
        }
        self._agent_for: Dict[str, str] = {}
        for agent, comps in self._mapping.items():
            for c in comps:
                if c in self._agent_for:
                    raise ValueError(
                        f"Computation {c} assigned to both "
                        f"{self._agent_for[c]} and {agent}"
                    )
                self._agent_for[c] = agent

    @property
    def agents(self) -> List[str]:
        return list(self._mapping)

    @property
    def computations(self) -> List[str]:
        return list(self._agent_for)

    def agent_for(self, computation: str) -> str:
        try:
            return self._agent_for[computation]
        except KeyError:
            raise KeyError(f"No agent hosts computation {computation}")

    def computations_hosted(self, agent: str) -> List[str]:
        return list(self._mapping.get(agent, []))

    def has_computation(self, computation: str) -> bool:
        return computation in self._agent_for

    @property
    def mapping(self) -> Dict[str, List[str]]:
        return {a: list(cs) for a, cs in self._mapping.items()}

    def host_on_agent(self, agent: str, computations: List[str]) -> None:
        already = [c for c in computations if c in self._agent_for]
        if already:
            raise ValueError(f"Computation(s) {already} already hosted")
        for c in computations:
            self._agent_for[c] = agent
        self._mapping.setdefault(agent, []).extend(computations)

    def remove_computation(self, computation: str) -> None:
        agent = self._agent_for.pop(computation)
        self._mapping[agent].remove(computation)

    def is_hosted(
        self, computations: Iterable[str]
    ) -> bool:
        return all(c in self._agent_for for c in computations)

    def __eq__(self, other):
        return (
            isinstance(other, Distribution)
            and other._agent_for == self._agent_for
        )

    def __repr__(self) -> str:
        return f"Distribution({self._mapping})"

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
