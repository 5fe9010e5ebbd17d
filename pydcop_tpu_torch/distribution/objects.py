"""Placement hints read from a problem yaml.

The port solves on one device and places no computations; it keeps
this one class so that ``dcop/yamldcop.py`` loads every yaml the JAX
package loads (``distribution_hints`` sections included).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

from pydcop_tpu_torch.utils.simple_repr import SimpleRepr


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
