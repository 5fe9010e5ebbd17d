"""Algorithm plugin registry (port of ``pydcop_tpu/algorithms/__init__.py``).

Batched-engine contract of an algorithm module (the torch form of the
JAX package's):

- ``algo_params: List[AlgoParameterDef]`` — typed, defaulted parameters
  (same names, types, allowed values and defaults as the JAX package,
  host-runtime ones such as ``island_rounds`` included: accepted, unused
  by the batched engine).
- ``init_state(problem, seed, params, batch=()) -> state`` — a dict of
  tensors on the problem's device; must contain ``"values"``
  (i32[*batch, n_vars]).  Its random draws come from a CPU
  ``torch.Generator`` seeded with ``seed``, so a card run and a CPU run
  start from the same state.  ``batch = (K,)`` builds K restarts: every
  leaf gets a leading ``[K]`` axis except those named in
  ``STATIC_STATE_KEYS`` (problem-derived index data, shared).
- ``step(problem, state, params, gen) -> state`` — ONE synchronous round
  for every agent at once; its per-round random numbers come from the
  ``torch.Generator`` ``gen`` on the problem's device (deterministic
  algorithms ignore it).
- ``messages_per_round(problem, params=None) -> int`` — logical directed
  messages one round represents (the msgs/s accounting; the ghost
  constraints of a sharded layout are not counted).
- ``INSTANCE_AXIS`` (optional, default False) — True when ``step``
  takes a stacked problem (``ops/compile.py:StackedProblem``) with the
  state ``[I, R, ...]``, as Max-Sum and A-Max-Sum do; the other
  algorithms solve several instances on their disjoint union
  (``engine/batched.py:run_many_batched``).
- ``INSTANCE_PARAM_AXES`` (optional) — for a numeric param that may
  differ per instance on the union, the axis it acts on:
  ``"variables"`` (the default) or ``"constraints"``.

Sharded runs (``engine/batched.py`` with a ``parallel.Mesh``, the JAX
step's ``axis_name``).  ``step`` and ``apply`` take a keyword ``axis``
(``None``, or the shard's ``parallel.ShardAxis``): with it, ``problem`` is
the shard's view (its blocks of the constraint, edge and bucket arrays,
the per-variable arrays whole) and the state holds the shard's part;
every per-variable sum over edges or constraints ends in ``axis.psum``
(``ops/costs.py`` takes the axis).  An unmeshed ``n_shards > 1`` problem
runs the same sums segment by segment.  Optional declarations:

- ``state_specs(problem) -> {key: parallel.P}`` — how each state leaf
  splits over the mesh (``P(SHARD_AXIS)`` on its constraint or edge
  axis, ``P()`` replicated; unnamed leaves are replicated, and the
  engine puts restart and instance axes in front);
- ``draw_specs(problem)`` — the same for the draws, which the engine
  makes once, in its own thread, from the run's generator, with the
  whole problem's shapes, and splits for the shards.

A module whose ``step`` draws must split into ``draws``/``apply`` to run
over a mesh; a ``step`` without them is called with ``gen=None``.

The random seam.  The JAX steps take a key and split it inside; the port
does not replay jax's stream.  A stochastic module splits its round in
two: ``draws(problem, params, gen, batch=()) -> dict`` makes every
random tensor the round needs (f32 uniforms in ``[0, 1)``, or integers
where the JAX step draws integers; the JAX step's shapes with ``batch``
in front), and ``apply(problem, state, params, drawn) -> state`` is the
pure tensor function of the state and those draws; ``step`` is
``apply`` of ``draws`` (``_common.draw_apply_step``).  Tests rebuild the JAX step's draws from its key and hand
them to ``apply``; ``chip_smoke.py`` makes draws on the CPU and feeds the
same ones to ``apply`` on the card and on the CPU.

Host-path contract (exact algorithms, ``dpop`` and ``syncbb``): the
module has no ``init_state``/``step``; it exposes ``solve_host(dcop,
params, timeout=None, max_util_size=..., pad_policy=None, device=None)
-> result dict``, which ``api.solve`` calls instead of the batched
engine.

Host-runtime contract (``mode="sim"``/``"thread"``,
``infrastructure/runtime.py``): ``build_computation(comp_def, seed=0)``
returns the message-driven computation of one graph node, and
``build_island(comp_defs, dcop, seed=0, pending_fn=None, device=None)``
one agent's placed nodes as a compiled island on ``device`` behind
per-node proxies.  Every algorithm has host computations; Max-Sum,
A-Max-Sum, the DSA family, MGM, DBA and GDBA also have islands.

A dotted name loads an external plugin from ``sys.path``
(:func:`load_algorithm_module`): a module with ``GRAPH_TYPE`` (the
batched contract above, and ``build_computation`` for the host runtimes)
or ``solve_host`` (the host-path contract), and ``algo_params`` either
way.  :func:`list_available_algorithms` lists this package's own.
"""

from __future__ import annotations

import dataclasses
import importlib
import pkgutil
from typing import Any, Dict, List, Mapping, Optional, Sequence

from pydcop_tpu_torch.utils.simple_repr import SimpleRepr

_ALGO_PACKAGE = "pydcop_tpu_torch.algorithms"


class AlgorithmDefError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class AlgoParameterDef:
    """Typed algorithm-parameter declaration.

    type: 'str' | 'int' | 'float' | 'bool'
    values: allowed values (for enumerated str params), or None
    """

    name: str
    type: str = "str"
    values: Optional[Sequence[Any]] = None
    default: Any = None

    def check_value(self, value: Any) -> Any:
        try:
            if self.type == "int":
                value = int(value)
            elif self.type == "float":
                value = float(value)
            elif self.type == "bool":
                if isinstance(value, str):
                    if value.lower() in ("true", "1", "yes"):
                        value = True
                    elif value.lower() in ("false", "0", "no"):
                        value = False
                    else:
                        raise ValueError(value)
                value = bool(value)
            else:
                value = str(value)
        except (TypeError, ValueError):
            raise AlgorithmDefError(
                f"Parameter {self.name}: cannot convert {value!r} to "
                f"{self.type}"
            )
        if self.values is not None and value not in self.values:
            raise AlgorithmDefError(
                f"Parameter {self.name}: {value!r} not in allowed values "
                f"{list(self.values)}"
            )
        return value


def check_param_value(value: Any, param_def: AlgoParameterDef) -> Any:
    return param_def.check_value(value)


def prepare_algo_params(
    params: Optional[Mapping[str, Any]],
    param_defs: List[AlgoParameterDef],
) -> Dict[str, Any]:
    """Validate user params against the definitions; fill defaults;
    reject unknown names."""
    params = dict(params or {})
    out: Dict[str, Any] = {}
    by_name = {p.name: p for p in param_defs}
    unknown = set(params) - set(by_name)
    if unknown:
        raise AlgorithmDefError(
            f"Unknown algorithm parameter(s) {sorted(unknown)}; "
            f"accepted: {sorted(by_name)}"
        )
    for name, pdef in by_name.items():
        if name in params:
            out[name] = pdef.check_value(params[name])
        else:
            out[name] = pdef.default
    return out


class AlgorithmDef(SimpleRepr):
    """Serializable algorithm selection: name + validated params + mode
    (a copy of the JAX package's).

    ``mode`` is 'min' or 'max' (the optimization direction the algorithm
    should apply — normally taken from the DCOP objective).
    """

    def __init__(
        self,
        algo: str,
        params: Optional[Mapping[str, Any]] = None,
        mode: str = "min",
    ):
        self._algo = algo
        self._params = dict(params or {})
        self._mode = mode

    @classmethod
    def build_with_default_param(
        cls,
        algo: str,
        params: Optional[Mapping[str, Any]] = None,
        mode: str = "min",
    ) -> "AlgorithmDef":
        module = load_algorithm_module(algo)
        validated = prepare_algo_params(params, module.algo_params)
        return cls(algo, validated, mode)

    @property
    def algo(self) -> str:
        return self._algo

    @property
    def name(self) -> str:
        return self._algo

    @property
    def params(self) -> Dict[str, Any]:
        return dict(self._params)

    @property
    def mode(self) -> str:
        return self._mode

    def param_value(self, name: str) -> Any:
        return self._params[name]

    def __eq__(self, other):
        return (
            isinstance(other, AlgorithmDef)
            and other._algo == self._algo
            and other._params == self._params
            and other._mode == self._mode
        )

    def __repr__(self) -> str:
        return f"AlgorithmDef({self._algo!r}, {self._params}, {self._mode!r})"

    def _simple_repr(self) -> dict:
        from pydcop_tpu_torch.utils.simple_repr import (
            _CLASS_KEY,
            _MODULE_KEY,
            simple_repr,
        )

        return {
            _CLASS_KEY: type(self).__qualname__,
            _MODULE_KEY: type(self).__module__,
            "algo": self._algo,
            "params": simple_repr(self._params),
            "mode": self._mode,
        }

    @classmethod
    def _from_repr(cls, r: dict):
        from pydcop_tpu_torch.utils.simple_repr import from_repr

        return cls(r["algo"], from_repr(r["params"]) or {}, r.get("mode", "min"))


class ComputationDef(SimpleRepr):
    """Deployment unit: one computation-graph node + the algorithm that
    runs it (reference: ``ComputationDef``).  Used by the host runtime;
    the batched engine deploys whole problems instead."""

    def __init__(self, node, algo: AlgorithmDef):
        self._node = node
        self._algo = algo

    @property
    def node(self):
        return self._node

    @property
    def algo(self) -> AlgorithmDef:
        return self._algo

    @property
    def name(self) -> str:
        return self._node.name

    def __repr__(self) -> str:
        return f"ComputationDef({self.name!r}, {self._algo.name})"

    def _simple_repr(self) -> dict:
        from pydcop_tpu_torch.utils.simple_repr import (
            _CLASS_KEY,
            _MODULE_KEY,
            simple_repr,
        )

        return {
            _CLASS_KEY: type(self).__qualname__,
            _MODULE_KEY: type(self).__module__,
            "node": simple_repr(self._node)
            if isinstance(self._node, SimpleRepr)
            else {"name": self._node.name},
            "algo": simple_repr(self._algo),
        }

    @classmethod
    def _from_repr(cls, r: dict):
        from pydcop_tpu_torch.utils.simple_repr import from_repr

        return cls(from_repr(r["node"]), from_repr(r["algo"]))


def resolve_algo(algo, algo_params=None):
    """Normalize (algo, algo_params) into ``(name, params_dict)``.

    ``algo`` is a name or an :class:`AlgorithmDef`; explicit
    ``algo_params`` override the def's params."""
    if isinstance(algo, AlgorithmDef):
        name, params = algo.algo, dict(algo.params)
        if algo_params:
            params.update(algo_params)
        return name, params
    return algo, dict(algo_params or {})


def load_algorithm_module(name: str):
    """Import an algorithm plugin module by name.

    A plain name loads from this package; a dotted name is imported
    as-is from ``sys.path``, so third-party algorithm modules plug in
    without being copied into the package (module docstring).
    """
    target = name if "." in name else f"{_ALGO_PACKAGE}.{name}"
    if target.startswith(".") or target.endswith("."):
        raise AlgorithmDefError(
            f"Could not load algorithm {name!r}: relative module names "
            "are not supported (see docs/extending.md)"
        )
    try:
        mod = importlib.import_module(target)
    except ImportError as e:
        if "." in name:
            # external plugin: the internal algorithm list is never
            # where a dotted name resolves, and a broken import INSIDE
            # an existing module must not read as "unknown algorithm"
            missing_target = isinstance(e, ModuleNotFoundError) and (
                e.name == target
                or (e.name and target.startswith(e.name + "."))
            )
            raise AlgorithmDefError(
                f"Could not import external algorithm module "
                f"{name!r}: {e}"
                + (
                    ""
                    if missing_target
                    else " (the module exists but failed to import)"
                )
            )
        raise AlgorithmDefError(
            f"Could not load algorithm {name!r}: {e}; available: "
            f"{list_available_algorithms()}"
        )
    if "." in name:
        # exact algorithms may export only solve_host; algo_params is
        # required either way — every solve entry point dereferences it
        # right after loading
        if not hasattr(mod, "GRAPH_TYPE") and not hasattr(mod, "solve_host"):
            raise AlgorithmDefError(
                f"External module {name!r} is not an algorithm plugin "
                "(no GRAPH_TYPE or solve_host; see docs/extending.md "
                "for the contract)"
            )
        if not hasattr(mod, "algo_params"):
            raise AlgorithmDefError(
                f"External module {name!r} declares no algo_params "
                "(use `algo_params = []` for a parameter-free "
                "algorithm; see docs/extending.md)"
            )
    return mod


def require_island_support(module, algo_name: str) -> None:
    """Raise unless ``module`` can deploy compiled islands
    (``build_island``, the ``accel_agents`` path of the host runtimes)."""
    if not hasattr(module, "build_island"):
        have = [
            a
            for a in list_available_algorithms()
            if hasattr(load_algorithm_module(a), "build_island")
        ]
        raise ValueError(
            f"{algo_name}: no compiled-island support (build_island) "
            f"— accel agents are available for: {', '.join(have)}"
        )


def list_available_algorithms() -> List[str]:
    """All algorithm plugin modules in this package (any module defining
    GRAPH_TYPE)."""
    import pydcop_tpu_torch.algorithms as pkg

    names = []
    for info in pkgutil.iter_modules(pkg.__path__):
        if info.name.startswith("_"):
            continue
        mod = importlib.import_module(f"{_ALGO_PACKAGE}.{info.name}")
        if hasattr(mod, "GRAPH_TYPE"):
            names.append(info.name)
    return sorted(names)
