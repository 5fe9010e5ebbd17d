"""The DCOP problem container.

Role-equivalent to ``pydcop/dcop/dcop.py`` in the reference: objective,
domains, variables, constraints, agents, plus solution-cost evaluation.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple, Union

from pydcop_tpu_torch.dcop.objects import AgentDef, Domain, Variable
from pydcop_tpu_torch.dcop.relations import (
    RelationProtocol,
    assignment_cost,
)
from pydcop_tpu_torch.utils.simple_repr import SimpleRepr


class DCOP(SimpleRepr):
    """A Distributed Constraint Optimization Problem.

    >>> dcop = DCOP('test', objective='min')
    >>> d = Domain('d', '', [0, 1])
    >>> from pydcop_tpu_torch.dcop.objects import Variable
    >>> dcop.add_variable(Variable('x', d))
    >>> 'x' in dcop.variables
    True
    """

    def __init__(
        self,
        name: str = "",
        objective: str = "min",
        description: str = "",
    ):
        if objective not in ("min", "max"):
            raise ValueError(f"objective must be 'min' or 'max', got {objective!r}")
        self._name = name
        self._objective = objective
        self._description = description
        self.domains: Dict[str, Domain] = {}
        self.variables: Dict[str, Variable] = {}
        self.external_variables: Dict[str, Variable] = {}
        self._constraints: Dict[str, RelationProtocol] = {}
        self._agents_def: Dict[str, AgentDef] = {}
        self.dist_hints = None  # DistributionHints, set by yaml loader

    # -- identity ------------------------------------------------------

    @property
    def name(self) -> str:
        return self._name

    @property
    def objective(self) -> str:
        return self._objective

    @property
    def description(self) -> str:
        return self._description

    # -- variables -----------------------------------------------------

    def add_variable(self, v: Variable) -> None:
        from pydcop_tpu_torch.dcop.objects import ExternalVariable

        if v.domain.name not in self.domains:
            self.domains[v.domain.name] = v.domain
        if isinstance(v, ExternalVariable):
            self.external_variables[v.name] = v
        else:
            self.variables[v.name] = v

    def variable(self, name: str) -> Variable:
        return self.variables[name]

    @property
    def all_variables(self) -> List[Variable]:
        return list(self.variables.values()) + list(
            self.external_variables.values()
        )

    # -- constraints ---------------------------------------------------

    def add_constraint(self, c: RelationProtocol) -> None:
        from pydcop_tpu_torch.dcop.objects import ExternalVariable

        for v in c.dimensions:
            if (
                v.name not in self.variables
                and v.name not in self.external_variables
            ):
                self.add_variable(v)
        self._constraints[c.name] = c

    def __iadd__(self, c: RelationProtocol) -> "DCOP":
        self.add_constraint(c)
        return self

    @property
    def constraints(self) -> Dict[str, RelationProtocol]:
        return dict(self._constraints)

    def constraint(self, name: str) -> RelationProtocol:
        return self._constraints[name]

    # -- agents --------------------------------------------------------

    def add_agents(self, agents: Union[Iterable[AgentDef], Mapping[Any, AgentDef]]) -> None:
        if isinstance(agents, Mapping):
            agents = agents.values()
        for a in agents:
            self._agents_def[a.name] = a

    @property
    def agents(self) -> Dict[str, AgentDef]:
        return dict(self._agents_def)

    def agent(self, name: str) -> AgentDef:
        return self._agents_def[name]

    # -- evaluation ----------------------------------------------------

    def solution_cost(
        self, assignment: Mapping[str, Any], infinity: float = float("inf")
    ) -> float:
        """Cost of a full assignment: constraint costs + variable costs."""
        missing = set(self.variables) - set(assignment)
        if missing:
            raise ValueError(f"Assignment misses variable(s) {sorted(missing)}")
        if self.external_variables:
            full = {
                name: ev.value
                for name, ev in self.external_variables.items()
            }
            full.update(assignment)
            assignment = full
        cost = assignment_cost(assignment, self._constraints.values())
        for v in self.variables.values():
            if v.has_cost:
                cost += v.cost_for_val(assignment[v.name])
        return cost

    # -- misc ----------------------------------------------------------

    def __repr__(self) -> str:
        return (
            f"DCOP({self._name!r}, {len(self.variables)} vars, "
            f"{len(self._constraints)} constraints, "
            f"{len(self._agents_def)} agents)"
        )

    def _simple_repr(self) -> dict:
        from pydcop_tpu_torch.utils.simple_repr import _CLASS_KEY, _MODULE_KEY, simple_repr

        return {
            _CLASS_KEY: type(self).__qualname__,
            _MODULE_KEY: type(self).__module__,
            "name": self._name,
            "objective": self._objective,
            "description": self._description,
            "domains": {k: simple_repr(v) for k, v in self.domains.items()},
            "variables": {
                k: simple_repr(v) for k, v in self.variables.items()
            },
            "external_variables": {
                k: simple_repr(v)
                for k, v in self.external_variables.items()
            },
            "dist_hints": simple_repr(self.dist_hints)
            if self.dist_hints is not None
            else None,
            "constraints": {
                k: simple_repr(v) for k, v in self._constraints.items()
            },
            "agents": {
                k: simple_repr(v) for k, v in self._agents_def.items()
            },
        }

    @classmethod
    def _from_repr(cls, r: dict):
        from pydcop_tpu_torch.utils.simple_repr import from_repr

        dcop = cls(r["name"], r["objective"], r.get("description", ""))
        for v in r["variables"].values():
            dcop.add_variable(from_repr(v))
        for v in r.get("external_variables", {}).values():
            dcop.add_variable(from_repr(v))
        for c in r["constraints"].values():
            dcop.add_constraint(from_repr(c))
        dcop.add_agents([from_repr(a) for a in r["agents"].values()])
        if r.get("dist_hints") is not None:
            dcop.dist_hints = from_repr(r["dist_hints"])
        return dcop


def solution_cost(
    dcop: DCOP, assignment: Mapping[str, Any]
) -> float:
    return dcop.solution_cost(assignment)
