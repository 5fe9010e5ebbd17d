"""Constraints (relations) over finite-domain variables.

Role-equivalent to ``pydcop/dcop/relations.py`` in the reference
(`RelationProtocol`, `NAryMatrixRelation`, `NAryFunctionRelation`,
`constraint_from_str`, assignment/optimal-cost helpers), designed fresh:

- ``NAryMatrixRelation`` is the canonical *host-side* form: an n-dim
  ``numpy`` array indexed by the domain indices of its dimension
  variables.  ``Constraint.as_matrix()`` tabulates any constraint into
  it; the problem compiler then ships those tables to the device as
  torch tensors (see ``pydcop_tpu_torch.ops.compile``).  The host algebra
  (slice / join / project) exists for setup-time work and parity tests;
  the *solve-time* algebra runs on the GPU.
- Function-backed relations (`NAryFunctionRelation`,
  `UnaryFunctionRelation`, `constraint_from_str`) evaluate arbitrary
  Python on the host only.
"""

from __future__ import annotations

import itertools
from typing import (
    Any,
    Callable,
    Dict,
    Iterable,
    List,
    Mapping,
    Optional,
    Sequence,
    Tuple,
    Union,
)

import numpy as np

from pydcop_tpu_torch.dcop.objects import Domain, Variable
from pydcop_tpu_torch.utils.expressionfunction import ExpressionFunction
from pydcop_tpu_torch.utils.simple_repr import SimpleRepr, SimpleReprException

DEFAULT_TYPE = np.float32


class RelationProtocol:
    """The minimal protocol every constraint implements.

    Properties: ``name``, ``dimensions`` (list of Variable), ``arity``,
    ``scope_names``, ``shape``.  Calling conventions: positional values in
    dimension order, keyword values by variable name, or a single
    assignment dict.
    """

    @property
    def name(self) -> str:
        raise NotImplementedError

    @property
    def dimensions(self) -> List[Variable]:
        raise NotImplementedError

    @property
    def arity(self) -> int:
        return len(self.dimensions)

    @property
    def scope_names(self) -> List[str]:
        return [v.name for v in self.dimensions]

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(len(v.domain) for v in self.dimensions)

    def __call__(self, *args, **kwargs) -> float:
        raise NotImplementedError

    def get_value_for_assignment(self, assignment) -> float:
        raise NotImplementedError

    def slice(self, partial_assignment: Mapping[str, Any]) -> "Constraint":
        raise NotImplementedError


class AbstractBaseRelation(RelationProtocol, SimpleRepr):
    """Shared plumbing for all constraint implementations."""

    def __init__(self, name: str, variables: Sequence[Variable]):
        self._name = name
        self._variables = list(variables)
        names = [v.name for v in self._variables]
        if len(set(names)) != len(names):
            raise ValueError(
                f"Duplicate variables in constraint {name}: {names}"
            )

    @property
    def name(self) -> str:
        return self._name

    @property
    def dimensions(self) -> List[Variable]:
        return list(self._variables)

    def _resolve_args(self, args, kwargs) -> Dict[str, Any]:
        if args and isinstance(args[0], dict) and len(args) == 1 and not kwargs:
            kwargs = args[0]
            args = ()
        assignment: Dict[str, Any] = {}
        if args:
            if len(args) != len(self._variables):
                raise ValueError(
                    f"Constraint {self._name} expects {len(self._variables)} "
                    f"positional values, got {len(args)}"
                )
            assignment = dict(zip(self.scope_names, args))
        assignment.update(
            {k: v for k, v in kwargs.items() if k in set(self.scope_names)}
        )
        missing = set(self.scope_names) - set(assignment)
        if missing:
            raise ValueError(
                f"Missing value(s) for {missing} in call to constraint "
                f"{self._name}"
            )
        return assignment

    def __call__(self, *args, **kwargs) -> float:
        return self.get_value_for_assignment(self._resolve_args(args, kwargs))

    def value_at(self, assignment: Mapping[str, Any]) -> float:
        return self.get_value_for_assignment(dict(assignment))

    def as_matrix(self) -> "NAryMatrixRelation":
        """Tabulate this constraint into a dense matrix relation.

        This is the bridge to the TPU compiler: every constraint becomes
        a dense cost table over domain indices.
        """
        if isinstance(self, NAryMatrixRelation):
            return self
        shape = self.shape
        arr = np.zeros(shape, dtype=DEFAULT_TYPE)
        domains = [v.domain for v in self._variables]
        names = self.scope_names
        for idx in itertools.product(*(range(s) for s in shape)):
            assignment = {
                names[k]: domains[k][idx[k]] for k in range(len(names))
            }
            arr[idx] = self.get_value_for_assignment(assignment)
        return NAryMatrixRelation(self._variables, arr, name=self._name)

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self._name!r}, {self.scope_names})"


Constraint = AbstractBaseRelation  # public alias, as in the reference docs


class NAryMatrixRelation(AbstractBaseRelation):
    """Constraint backed by an n-dimensional cost array.

    Axis ``k`` of the array is indexed by the domain index of the k-th
    dimension variable.  This is the host twin of the device cost tables.

    >>> from pydcop_tpu_torch.dcop.objects import Domain, Variable
    >>> d = Domain('d', '', [0, 1])
    >>> x, y = Variable('x', d), Variable('y', d)
    >>> r = NAryMatrixRelation([x, y], [[0, 1], [1, 0]], name='neq')
    >>> r(0, 1)
    1.0
    """

    def __init__(
        self,
        variables: Sequence[Variable],
        matrix: Optional[Union[np.ndarray, list]] = None,
        name: str = "",
    ):
        super().__init__(name, variables)
        shape = tuple(len(v.domain) for v in variables)
        if matrix is None:
            self._m = np.zeros(shape, dtype=DEFAULT_TYPE)
        else:
            self._m = np.asarray(matrix, dtype=DEFAULT_TYPE)
            if self._m.shape != shape:
                raise ValueError(
                    f"Matrix shape {self._m.shape} does not match domain "
                    f"shape {shape} for constraint {name}"
                )

    @property
    def matrix(self) -> np.ndarray:
        return self._m

    @property
    def shape(self) -> Tuple[int, ...]:
        return self._m.shape

    def _indices(self, assignment: Mapping[str, Any]) -> Tuple[int, ...]:
        return tuple(
            v.domain.index(assignment[v.name]) for v in self._variables
        )

    def get_value_for_assignment(self, assignment) -> float:
        if isinstance(assignment, (list, tuple)):
            assignment = dict(zip(self.scope_names, assignment))
        return float(self._m[self._indices(assignment)])

    def set_value_for_assignment(
        self, assignment: Mapping[str, Any], value: float
    ) -> "NAryMatrixRelation":
        """Return a new relation with one cell changed (immutable style)."""
        m = self._m.copy()
        m[self._indices(assignment)] = value
        return NAryMatrixRelation(self._variables, m, name=self._name)

    def slice(self, partial_assignment: Mapping[str, Any]) -> "NAryMatrixRelation":
        """Condition on a partial assignment: fix those axes, keep the rest."""
        if not partial_assignment:
            return self
        unknown = set(partial_assignment) - set(self.scope_names)
        if unknown:
            raise ValueError(
                f"slice: variables {unknown} not in constraint {self._name}"
            )
        index: List[Any] = []
        remaining: List[Variable] = []
        for v in self._variables:
            if v.name in partial_assignment:
                index.append(v.domain.index(partial_assignment[v.name]))
            else:
                index.append(slice(None))
                remaining.append(v)
        sub = self._m[tuple(index)]
        return NAryMatrixRelation(remaining, sub, name=self._name)

    # -- join / projection (DPOP host algebra; device version in ops) ---

    def join(self, other: "Constraint") -> "NAryMatrixRelation":
        """Sum-join: result scope = union of scopes, costs add.

        Implemented as broadcast-add over aligned axes — the same
        formulation the device kernel uses (reference does an explicit
        loop over joint assignments; broadcasting is the array-native
        equivalent).
        """
        other_m = (
            other if isinstance(other, NAryMatrixRelation) else other.as_matrix()
        )
        self_vars = {v.name: v for v in self._variables}
        joined_vars = list(self._variables) + [
            v for v in other_m.dimensions if v.name not in self_vars
        ]
        name_to_axis = {v.name: i for i, v in enumerate(joined_vars)}
        n = len(joined_vars)

        def expand(m: np.ndarray, dims: List[Variable]) -> np.ndarray:
            # Transpose m so its axes are ordered by their position in the
            # joined scope, then reshape with size-1 axes for the missing
            # variables — broadcasting does the rest.
            src_axes = [name_to_axis[v.name] for v in dims]
            shape = [1] * n
            for ax, v in zip(src_axes, dims):
                shape[ax] = len(v.domain)
            order = np.argsort(src_axes)
            m_t = np.transpose(m, order) if m.ndim > 1 else m
            return m_t.reshape(shape)

        a = expand(self._m, self._variables)
        b = expand(other_m.matrix, other_m.dimensions)
        return NAryMatrixRelation(
            joined_vars, a + b, name=f"{self._name}_join_{other_m.name}"
        )

    def project_out(
        self, variable: Union[str, Variable], mode: str = "min"
    ) -> "NAryMatrixRelation":
        """Eliminate one variable by min (or max) over its axis."""
        vname = variable if isinstance(variable, str) else variable.name
        axis = None
        for i, v in enumerate(self._variables):
            if v.name == vname:
                axis = i
                break
        if axis is None:
            raise ValueError(
                f"Cannot project out {vname}: not in scope of {self._name}"
            )
        reducer = np.min if mode == "min" else np.max
        m = reducer(self._m, axis=axis)
        remaining = [v for v in self._variables if v.name != vname]
        return NAryMatrixRelation(remaining, m, name=self._name)

    def argbest_for(
        self, variable: Union[str, Variable], mode: str = "min"
    ) -> Tuple[Any, float]:
        """Best value of ``variable`` after the other axes were eliminated."""
        if self.arity != 1:
            raise ValueError("argbest_for requires a unary relation")
        vals = self._m
        idx = int(np.argmin(vals) if mode == "min" else np.argmax(vals))
        return self._variables[0].domain[idx], float(vals[idx])

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, NAryMatrixRelation)
            and other.scope_names == self.scope_names
            and np.array_equal(other._m, self._m)
        )

    def __hash__(self) -> int:
        # name excluded: __eq__ compares scope + matrix only
        return hash(tuple(self.scope_names))

    def _simple_repr(self) -> dict:
        from pydcop_tpu_torch.utils.simple_repr import _CLASS_KEY, _MODULE_KEY, simple_repr

        return {
            _CLASS_KEY: type(self).__qualname__,
            _MODULE_KEY: type(self).__module__,
            "name": self._name,
            "variables": [simple_repr(v) for v in self._variables],
            "matrix": self._m.tolist(),
        }

    @classmethod
    def _from_repr(cls, r: dict):
        from pydcop_tpu_torch.utils.simple_repr import from_repr

        variables = [from_repr(v) for v in r["variables"]]
        return cls(variables, np.asarray(r["matrix"]), name=r["name"])

    @classmethod
    def from_func_relation(cls, rel: "Constraint") -> "NAryMatrixRelation":
        return rel.as_matrix()


class NAryFunctionRelation(AbstractBaseRelation):
    """Constraint defined by a Python callable (intentional constraint)."""

    def __init__(
        self,
        f: Union[Callable[..., float], ExpressionFunction],
        variables: Sequence[Variable],
        name: str = "",
        f_kwargs: bool = False,
    ):
        super().__init__(name, variables)
        self._f = f
        self._f_kwargs = f_kwargs or isinstance(f, ExpressionFunction)

    @property
    def function(self):
        return self._f

    @property
    def expression(self) -> Optional[str]:
        if isinstance(self._f, ExpressionFunction):
            return self._f.expression
        return None

    def get_value_for_assignment(self, assignment) -> float:
        if isinstance(assignment, (list, tuple)):
            assignment = dict(zip(self.scope_names, assignment))
        if self._f_kwargs:
            return float(
                self._f(**{n: assignment[n] for n in self.scope_names})
            )
        return float(self._f(*(assignment[n] for n in self.scope_names)))

    def slice(self, partial_assignment: Mapping[str, Any]) -> "Constraint":
        if not partial_assignment:
            return self
        if isinstance(self._f, ExpressionFunction):
            fixed = self._f.partial(**dict(partial_assignment))
            remaining = [
                v
                for v in self._variables
                if v.name not in partial_assignment
            ]
            return NAryFunctionRelation(fixed, remaining, name=self._name)
        # generic callable: close over the fixed values
        fixed_vals = dict(partial_assignment)
        remaining = [
            v for v in self._variables if v.name not in partial_assignment
        ]

        def g(**kwargs):
            scope = dict(fixed_vals)
            scope.update(kwargs)
            if self._f_kwargs:
                return self._f(**scope)
            return self._f(*(scope[n] for n in self.scope_names))

        return NAryFunctionRelation(g, remaining, name=self._name, f_kwargs=True)

    def _simple_repr(self) -> dict:
        from pydcop_tpu_torch.utils.simple_repr import _CLASS_KEY, _MODULE_KEY, simple_repr

        if not isinstance(self._f, ExpressionFunction):
            raise SimpleReprException(
                f"Cannot serialize NAryFunctionRelation {self._name} backed "
                "by an arbitrary callable; use an ExpressionFunction"
            )
        return {
            _CLASS_KEY: type(self).__qualname__,
            _MODULE_KEY: type(self).__module__,
            "name": self._name,
            "f": simple_repr(self._f),
            "variables": [simple_repr(v) for v in self._variables],
        }

    @classmethod
    def _from_repr(cls, r: dict):
        from pydcop_tpu_torch.utils.simple_repr import from_repr

        return cls(
            from_repr(r["f"]),
            [from_repr(v) for v in r["variables"]],
            name=r["name"],
        )


class UnaryFunctionRelation(NAryFunctionRelation):
    """Single-variable intentional constraint."""

    def __init__(
        self,
        name: str,
        variable: Variable,
        rel_function: Union[Callable[[Any], float], ExpressionFunction],
    ):
        if isinstance(rel_function, ExpressionFunction):
            f = rel_function
        else:
            vname = variable.name

            def f(**kwargs):
                return rel_function(kwargs[vname])

        super().__init__(f, [variable], name=name, f_kwargs=True)
        self._raw_function = rel_function

    def get_value_for_assignment(self, assignment) -> float:
        if isinstance(assignment, (list, tuple)):
            assignment = dict(zip(self.scope_names, assignment))
        if isinstance(self._raw_function, ExpressionFunction):
            return float(self._f(**assignment))
        return float(self._raw_function(assignment[self.scope_names[0]]))

    def _simple_repr(self) -> dict:
        from pydcop_tpu_torch.utils.simple_repr import _CLASS_KEY, _MODULE_KEY, simple_repr

        if not isinstance(self._raw_function, ExpressionFunction):
            raise SimpleReprException(
                f"Cannot serialize UnaryFunctionRelation {self._name} backed "
                "by an arbitrary callable; use an ExpressionFunction"
            )
        return {
            _CLASS_KEY: type(self).__qualname__,
            _MODULE_KEY: type(self).__module__,
            "name": self._name,
            "variable": simple_repr(self._variables[0]),
            "rel_function": simple_repr(self._raw_function),
        }

    @classmethod
    def _from_repr(cls, r: dict):
        from pydcop_tpu_torch.utils.simple_repr import from_repr

        return cls(r["name"], from_repr(r["variable"]), from_repr(r["rel_function"]))


# ---------------------------------------------------------------------------
# Factory / helper functions (reference-parity API)
# ---------------------------------------------------------------------------


def relation_from_str(
    name: str, expression: str, all_variables: Iterable[Variable]
) -> NAryFunctionRelation:
    """Build an intentional constraint from a Python expression string.

    The constraint's scope is the subset of ``all_variables`` whose names
    appear free in the expression.
    """
    f = ExpressionFunction(expression)
    by_name = {v.name: v for v in all_variables}
    scope: List[Variable] = []
    missing: List[str] = []
    for vname in sorted(f.variable_names):
        if vname in by_name:
            scope.append(by_name[vname])
        else:
            missing.append(vname)
    if missing:
        raise ValueError(
            f"Expression for constraint {name} uses unknown variable(s) "
            f"{missing}: {expression!r}"
        )
    return NAryFunctionRelation(f, scope, name=name)


constraint_from_str = relation_from_str


def constraint_from_external_definition(
    name: str, source_file: str, expression: str, all_variables: Iterable[Variable]
) -> NAryFunctionRelation:
    """Load a constraint whose cost function lives in an external python
    file (reference yaml `type: external` support, simplified)."""
    import runpy

    ns = runpy.run_path(source_file)
    f = ExpressionFunction(expression)
    scope_names = set(f.variable_names)
    by_name = {v.name: v for v in all_variables}
    scope = [by_name[n] for n in sorted(scope_names & set(by_name))]
    fixed = {
        k: v for k, v in ns.items() if k in scope_names and k not in by_name
    }
    if fixed:
        f = f.partial(**fixed)
        scope = [by_name[n] for n in sorted(f.variable_names)]
    return NAryFunctionRelation(f, scope, name=name)


def filter_assignment_dict(
    assignment: Mapping[str, Any], target_vars: Iterable[Variable]
) -> Dict[str, Any]:
    """Keep only the entries of ``assignment`` that concern ``target_vars``."""
    names = {v.name for v in target_vars}
    return {k: v for k, v in assignment.items() if k in names}


def assignment_cost(
    assignment: Mapping[str, Any],
    constraints: Iterable[RelationProtocol],
) -> float:
    """Total cost of a full assignment over the given constraints."""
    cost = 0.0
    for c in constraints:
        cost += c.get_value_for_assignment(
            {n: assignment[n] for n in c.scope_names}
        )
    return cost


def optimal_cost_value(
    variable: Variable, mode: str = "min"
) -> Tuple[Any, float]:
    """Best value (and cost) of a variable w.r.t. its own unary cost."""
    best_v, best_c = None, None
    for val in variable.domain:
        c = variable.cost_for_val(val)
        if best_c is None or (c < best_c if mode == "min" else c > best_c):
            best_v, best_c = val, c
    return best_v, float(best_c)


def find_dependent_relations(
    variable: Variable, relations: Iterable[RelationProtocol]
) -> List[RelationProtocol]:
    """All relations whose scope contains ``variable``."""
    return [r for r in relations if variable.name in r.scope_names]


def add_var_to_rel(
    name: str,
    relation: Constraint,
    variable: Variable,
    f: Callable[[Any, Any], float],
) -> NAryFunctionRelation:
    """Extend a relation with one extra variable combined via ``f(cost, val)``.

    Used by the SECP model builders (reference: relations.add_var_to_rel).
    """
    dims = relation.dimensions + [variable]

    def g(**kwargs):
        base = relation.get_value_for_assignment(
            {n: kwargs[n] for n in relation.scope_names}
        )
        return f(base, kwargs[variable.name])

    return NAryFunctionRelation(g, dims, name=name, f_kwargs=True)
