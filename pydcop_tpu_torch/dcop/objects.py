"""Problem-model objects: domains, variables, agent definitions.

Role-equivalent to ``pydcop/dcop/objects.py`` in the reference (Domain,
Variable and its cost-carrying variants, AgentDef, bulk helpers), designed
fresh for the TPU build:

- Domains are finite and ordered; every value has a stable integer index.
  The problem compiler (``pydcop_tpu_torch.ops.compile``) uses those indices to
  tabulate costs into device arrays, so *everything* downstream of the
  model is integer-indexed — host objects keep the human-readable values.
- Variables are immutable value objects (hashable by name) so they can be
  dict keys and set members; mutation happens only in solver state arrays.
"""

from __future__ import annotations

import random
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, Tuple, Union

from pydcop_tpu_torch.utils.expressionfunction import ExpressionFunction
from pydcop_tpu_torch.utils.simple_repr import SimpleRepr, SimpleReprException


class Domain(SimpleRepr):
    """A named, ordered, finite set of values.

    >>> d = Domain('colors', 'color', ['R', 'G', 'B'])
    >>> len(d), d.index('G'), d[2]
    (3, 1, 'B')
    """

    def __init__(self, name: str, domain_type: str = "", values: Iterable = ()):
        self._name = name
        self._domain_type = domain_type
        self._values = tuple(values)
        self._index: Dict[Any, int] = {v: i for i, v in enumerate(self._values)}

    @property
    def name(self) -> str:
        return self._name

    @property
    def type(self) -> str:
        return self._domain_type

    @property
    def domain_type(self) -> str:
        return self._domain_type

    @property
    def values(self) -> Tuple:
        return self._values

    def index(self, value: Any) -> int:
        try:
            return self._index[value]
        except KeyError:
            raise ValueError(f"{value!r} is not in domain {self._name}")

    def to_domain_value(self, value: Any):
        """Map a raw (possibly str-parsed) value onto the domain value.

        Used when parsing YAML or CLI input: accepts either the value
        itself or its string form.
        """
        if value in self._index:
            return value
        for v in self._values:
            if str(v) == str(value):
                return v
        raise ValueError(f"{value!r} is not in domain {self._name}")

    def __len__(self) -> int:
        return len(self._values)

    def __iter__(self):
        return iter(self._values)

    def __getitem__(self, i: int):
        return self._values[i]

    def __contains__(self, v: Any) -> bool:
        return v in self._index

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, Domain)
            and other._name == self._name
            and other._values == self._values
            and other._domain_type == self._domain_type
        )

    def __hash__(self) -> int:
        return hash((self._name, self._values, self._domain_type))

    def __repr__(self) -> str:
        return f"Domain({self._name!r}, {self._domain_type!r}, {list(self._values)})"

    def _simple_repr(self) -> dict:
        from pydcop_tpu_torch.utils.simple_repr import _CLASS_KEY, _MODULE_KEY, simple_repr

        return {
            _CLASS_KEY: type(self).__qualname__,
            _MODULE_KEY: type(self).__module__,
            "name": self._name,
            "domain_type": self._domain_type,
            "values": [simple_repr(v) for v in self._values],
        }

    @classmethod
    def _from_repr(cls, r: dict):
        return cls(r["name"], r.get("domain_type", ""), r["values"])


# Reference alias (pyDcop calls it VariableDomain in places).
VariableDomain = Domain


class Variable(SimpleRepr):
    """A decision variable with a finite domain."""

    has_cost = False

    def __init__(
        self, name: str, domain: Domain, initial_value: Any = None
    ):
        self._name = name
        if not isinstance(domain, Domain):
            # convenience: accept a raw list of values
            domain = Domain(f"d_{name}", "", domain)
        self._domain = domain
        if initial_value is not None and initial_value not in domain:
            raise ValueError(
                f"Initial value {initial_value!r} not in domain "
                f"{domain.name} of variable {name}"
            )
        self._initial_value = initial_value

    @property
    def name(self) -> str:
        return self._name

    @property
    def domain(self) -> Domain:
        return self._domain

    @property
    def initial_value(self):
        return self._initial_value

    def cost_for_val(self, val: Any) -> float:
        return 0.0

    def clone(self) -> "Variable":
        return Variable(self._name, self._domain, self._initial_value)

    def __eq__(self, other: object) -> bool:
        return (
            type(other) is type(self)
            and other.name == self.name  # type: ignore[union-attr]
            and other.domain == self.domain  # type: ignore[union-attr]
        )

    def __hash__(self) -> int:
        return hash((type(self).__name__, self._name))

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self._name!r}, {self._domain.name})"


class VariableWithCostDict(Variable):
    """Variable with an explicit per-value cost table."""

    has_cost = True

    def __init__(
        self,
        name: str,
        domain: Domain,
        costs: Mapping[Any, float],
        initial_value: Any = None,
    ):
        super().__init__(name, domain, initial_value)
        self._costs = dict(costs)

    @property
    def costs(self) -> Dict[Any, float]:
        return dict(self._costs)

    def cost_for_val(self, val: Any) -> float:
        return float(self._costs.get(val, 0.0))

    def clone(self) -> "VariableWithCostDict":
        return VariableWithCostDict(
            self._name, self._domain, self._costs, self._initial_value
        )


class VariableWithCostFunc(Variable):
    """Variable whose per-value cost comes from a function of the value.

    The cost function participates in the objective: the compiler
    tabulates ``cost_for_val`` over the domain into a unary cost row.
    """

    has_cost = True

    def __init__(
        self,
        name: str,
        domain: Domain,
        cost_func: Union[Callable[[Any], float], ExpressionFunction],
        initial_value: Any = None,
    ):
        super().__init__(name, domain, initial_value)
        if isinstance(cost_func, ExpressionFunction):
            var_names = list(cost_func.variable_names)
            if len(var_names) != 1:
                raise ValueError(
                    f"Cost function for variable {name} must have exactly "
                    f"one free variable, got {var_names}"
                )
            self._cost_var = var_names[0]
        else:
            self._cost_var = None
        self._cost_func = cost_func

    @property
    def cost_func(self):
        return self._cost_func

    def cost_for_val(self, val: Any) -> float:
        if self._cost_var is not None:
            return float(self._cost_func(**{self._cost_var: val}))
        return float(self._cost_func(val))

    def clone(self) -> "VariableWithCostFunc":
        return VariableWithCostFunc(
            self._name, self._domain, self._cost_func, self._initial_value
        )

    def _simple_repr(self) -> dict:
        from pydcop_tpu_torch.utils.simple_repr import _CLASS_KEY, _MODULE_KEY, simple_repr

        if not isinstance(self._cost_func, ExpressionFunction):
            raise SimpleReprException(
                "Cannot serialize a VariableWithCostFunc built from an "
                "arbitrary callable; use an ExpressionFunction"
            )
        return {
            _CLASS_KEY: type(self).__qualname__,
            _MODULE_KEY: type(self).__module__,
            "name": self._name,
            "domain": simple_repr(self._domain),
            "cost_func": simple_repr(self._cost_func),
            "initial_value": simple_repr(self._initial_value),
        }

    @classmethod
    def _from_repr(cls, r: dict):
        from pydcop_tpu_torch.utils.simple_repr import from_repr

        return cls(
            r["name"],
            from_repr(r["domain"]),
            from_repr(r["cost_func"]),
            from_repr(r.get("initial_value")),
        )


class VariableNoisyCostFunc(VariableWithCostFunc):
    """Cost-function variable with additive uniform noise (deterministic
    per (variable, value) pair, seeded) — used to break symmetry in
    benchmarks, as in the reference."""

    has_cost = True

    def __init__(
        self,
        name: str,
        domain: Domain,
        cost_func,
        initial_value: Any = None,
        noise_level: float = 0.02,
    ):
        super().__init__(name, domain, cost_func, initial_value)
        self._noise_level = noise_level
        rnd = random.Random(name)  # deterministic per variable name
        self._noise = {v: rnd.uniform(0, noise_level) for v in domain}

    @property
    def noise_level(self) -> float:
        return self._noise_level

    def cost_for_val(self, val: Any) -> float:
        return super().cost_for_val(val) + self._noise[val]

    def clone(self) -> "VariableNoisyCostFunc":
        return VariableNoisyCostFunc(
            self._name,
            self._domain,
            self._cost_func,
            self._initial_value,
            self._noise_level,
        )

    def _simple_repr(self) -> dict:
        r = super()._simple_repr()
        r["noise_level"] = self._noise_level
        return r

    @classmethod
    def _from_repr(cls, r: dict):
        from pydcop_tpu_torch.utils.simple_repr import from_repr

        return cls(
            r["name"],
            from_repr(r["domain"]),
            from_repr(r["cost_func"]),
            from_repr(r.get("initial_value")),
            r.get("noise_level", 0.02),
        )


_BINARY_DOMAIN = Domain("binary", "binary", [0, 1])


class BinaryVariable(Variable):
    """A 0/1 variable (used by the repair DCOP and SECP models)."""

    def __init__(self, name: str, initial_value: int = 0):
        super().__init__(name, _BINARY_DOMAIN, initial_value)

    def clone(self) -> "BinaryVariable":
        return BinaryVariable(self._name, self._initial_value)

    def _simple_repr(self) -> dict:
        from pydcop_tpu_torch.utils.simple_repr import _CLASS_KEY, _MODULE_KEY

        return {
            _CLASS_KEY: type(self).__qualname__,
            _MODULE_KEY: type(self).__module__,
            "name": self._name,
            "initial_value": self._initial_value,
        }

    @classmethod
    def _from_repr(cls, r: dict):
        return cls(r["name"], r.get("initial_value", 0))


class ExternalVariable(Variable):
    """A read-only variable whose value is set by the environment (a
    sensor), not by any solver; algorithms treat it as a constant that can
    change between rounds.  Subscribers are notified on change."""

    def __init__(self, name: str, domain: Domain, value: Any = None):
        super().__init__(name, domain, value)
        self._value = value if value is not None else domain[0]
        self._subscribers: List[Callable[[Any], None]] = []

    @property
    def value(self):
        return self._value

    @value.setter
    def value(self, val):
        if val == self._value:
            return
        if val not in self._domain:
            raise ValueError(
                f"Value {val!r} not in domain of external variable {self._name}"
            )
        self._value = val
        for cb in self._subscribers:
            cb(val)

    def subscribe(self, callback: Callable[[Any], None]) -> None:
        self._subscribers.append(callback)

    def unsubscribe(self, callback: Callable[[Any], None]) -> None:
        self._subscribers.remove(callback)

    def clone(self) -> "ExternalVariable":
        return ExternalVariable(self._name, self._domain, self._value)

    def _simple_repr(self) -> dict:
        from pydcop_tpu_torch.utils.simple_repr import _CLASS_KEY, _MODULE_KEY, simple_repr

        return {
            _CLASS_KEY: type(self).__qualname__,
            _MODULE_KEY: type(self).__module__,
            "name": self._name,
            "domain": simple_repr(self._domain),
            "value": simple_repr(self._value),
        }

    @classmethod
    def _from_repr(cls, r: dict):
        from pydcop_tpu_torch.utils.simple_repr import from_repr

        return cls(r["name"], from_repr(r["domain"]), from_repr(r.get("value")))


class AgentDef(SimpleRepr):
    """Definition of an agent: capacity, hosting costs, route costs.

    Hosting and route costs drive the distribution (placement) layer and
    the k-resilient replica placement, as in the reference.
    """

    def __init__(
        self,
        name: str,
        capacity: float = 100.0,
        default_hosting_cost: float = 0.0,
        hosting_costs: Optional[Mapping[str, float]] = None,
        default_route: float = 1.0,
        routes: Optional[Mapping[str, float]] = None,
        **kwargs: Any,
    ):
        self._name = name
        self._capacity = capacity
        self._default_hosting_cost = default_hosting_cost
        self._hosting_costs = dict(hosting_costs or {})
        self._default_route = default_route
        self._routes = dict(routes or {})
        self._extra = dict(kwargs)

    @property
    def name(self) -> str:
        return self._name

    @property
    def capacity(self) -> float:
        return self._capacity

    @property
    def default_hosting_cost(self) -> float:
        return self._default_hosting_cost

    @property
    def hosting_costs(self) -> Dict[str, float]:
        return dict(self._hosting_costs)

    @property
    def default_route(self) -> float:
        return self._default_route

    @property
    def routes(self) -> Dict[str, float]:
        return dict(self._routes)

    @property
    def extra_attrs(self) -> Dict[str, Any]:
        return dict(self._extra)

    def hosting_cost(self, computation: str) -> float:
        return self._hosting_costs.get(computation, self._default_hosting_cost)

    def route(self, other_agent: str) -> float:
        if other_agent == self._name:
            return 0.0
        return self._routes.get(other_agent, self._default_route)

    def __getattr__(self, item: str):
        # expose extra yaml attributes (e.g. "foo: bar" under an agent)
        try:
            return self.__dict__["_extra"][item]
        except KeyError:
            raise AttributeError(item)

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, AgentDef)
            and other._name == self._name
            and other._capacity == self._capacity
            and other._hosting_costs == self._hosting_costs
            and other._routes == self._routes
            and other._default_hosting_cost == self._default_hosting_cost
            and other._default_route == self._default_route
        )

    def __hash__(self) -> int:
        return hash(("AgentDef", self._name))

    def __repr__(self) -> str:
        return f"AgentDef({self._name!r})"

    def _simple_repr(self) -> dict:
        from pydcop_tpu_torch.utils.simple_repr import _CLASS_KEY, _MODULE_KEY, simple_repr

        return {
            _CLASS_KEY: type(self).__qualname__,
            _MODULE_KEY: type(self).__module__,
            "name": self._name,
            "capacity": self._capacity,
            "default_hosting_cost": self._default_hosting_cost,
            "hosting_costs": simple_repr(self._hosting_costs),
            "default_route": self._default_route,
            "routes": simple_repr(self._routes),
            "extra": simple_repr(self._extra),
        }

    @classmethod
    def _from_repr(cls, r: dict):
        from pydcop_tpu_torch.utils.simple_repr import from_repr

        extra = from_repr(r.get("extra", {})) or {}
        return cls(
            r["name"],
            r.get("capacity", 100.0),
            r.get("default_hosting_cost", 0.0),
            from_repr(r.get("hosting_costs", {})) or {},
            r.get("default_route", 1.0),
            from_repr(r.get("routes", {})) or {},
            **extra,
        )


# ---------------------------------------------------------------------------
# Bulk creation helpers (reference: create_variables / create_agents)
# ---------------------------------------------------------------------------


def create_variables(
    name_prefix: str,
    indexes,
    domain: Domain,
    separator: str = "_",
) -> Dict[Union[str, Tuple[str, ...]], Variable]:
    """Create a dict of variables with systematic names.

    >>> vs = create_variables('v', range(3), Domain('d', '', [0, 1]))
    >>> sorted(vs)
    ['v0', 'v1', 'v2']
    """
    variables: Dict[Any, Variable] = {}
    if isinstance(indexes, range):
        indexes = list(indexes)
    if indexes and isinstance(indexes[0], (list, tuple, range)):
        import itertools

        pools = [list(p) for p in indexes]
        for combo in itertools.product(*pools):
            name = name_prefix + separator.join(str(c) for c in combo)
            variables[tuple(str(c) for c in combo)] = Variable(name, domain)
    else:
        for i in indexes:
            name = f"{name_prefix}{i}"
            variables[name] = Variable(name, domain)
    return variables


def create_binary_variables(
    name_prefix: str, indexes, separator: str = "_"
) -> Dict[Any, BinaryVariable]:
    out: Dict[Any, BinaryVariable] = {}
    if isinstance(indexes, range):
        indexes = list(indexes)
    if indexes and isinstance(indexes[0], (list, tuple, range)):
        import itertools

        pools = [list(p) for p in indexes]
        for combo in itertools.product(*pools):
            name = name_prefix + separator.join(str(c) for c in combo)
            out[tuple(str(c) for c in combo)] = BinaryVariable(name)
    else:
        for i in indexes:
            name = f"{name_prefix}{i}"
            out[name] = BinaryVariable(name)
    return out


def create_agents(
    name_prefix: str,
    indexes,
    default_route: float = 1.0,
    routes: Optional[Mapping[str, float]] = None,
    default_hosting_costs: float = 0.0,
    hosting_costs: Optional[Mapping[str, float]] = None,
    capacity: float = 100.0,
) -> Dict[Union[str, Tuple[str, ...]], AgentDef]:
    agents: Dict[Any, AgentDef] = {}
    if isinstance(indexes, range):
        indexes = list(indexes)
    for i in indexes:
        name = f"{name_prefix}{i}"
        agents[name] = AgentDef(
            name,
            capacity=capacity,
            default_hosting_cost=default_hosting_costs,
            hosting_costs=hosting_costs,
            default_route=default_route,
            routes=routes,
        )
    return agents
