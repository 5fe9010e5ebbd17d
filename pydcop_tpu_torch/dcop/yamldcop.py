"""YAML DCOP format — load/dump, compatible with the reference format.

Role-equivalent to ``pydcop/dcop/yamldcop.py``.  The accepted format
(mirrors the reference's documented schema):

.. code-block:: yaml

    name: graph coloring
    objective: min
    description: optional text

    domains:
      colors:
        values: [R, G, B]        # or ranges: [1 .. 10]
        type: color              # optional
        initial_value: R         # optional (rarely used)

    variables:
      v1:
        domain: colors
        initial_value: R
        cost_function: 0.2 if v1 == 'R' else 0   # optional (yields VariableWithCostFunc)
        noise_level: 0.02                         # optional → VariableNoisyCostFunc

    external_variables:
      e1:
        domain: colors
        initial_value: R

    constraints:
      pref_1:
        type: intention
        function: 10 if v1 == v2 else 0
      ext_1:
        type: extensional
        variables: [v1, v2]
        default: 0
        values:
          10: R R | G G | B B

    agents:                     # mapping (with attributes) or plain list
      a1:
        capacity: 100
        hosting:
          default: 0
          computations: {v1: 5}
        routes:
          default: 1
          a2: 0.5

    distribution_hints:
      must_host:
        a1: [v1]
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Iterable, List, Mapping, Optional, Union

import numpy as np

from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.dcop.objects import (
    AgentDef,
    Domain,
    ExternalVariable,
    Variable,
    VariableNoisyCostFunc,
    VariableWithCostFunc,
)
from pydcop_tpu_torch.dcop.relations import (
    NAryMatrixRelation,
    RelationProtocol,
    constraint_from_external_definition,
    relation_from_str,
)
from pydcop_tpu_torch.dcop.scenario import EventAction, Scenario, ScenarioEvent
from pydcop_tpu_torch.utils.expressionfunction import ExpressionFunction

_RANGE_RE = re.compile(r"^\s*(-?\d+)\s*\.\.\s*(-?\d+)\s*$")


class DcopInvalidFormatError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Loading
# ---------------------------------------------------------------------------


def load_dcop_from_file(filenames: Union[str, Iterable[str]]) -> DCOP:
    """Load a DCOP from one or several YAML files (merged in order)."""
    if isinstance(filenames, (str, os.PathLike)):
        filenames = [filenames]
    content = ""
    main_dir = None
    for fn in filenames:
        if main_dir is None:
            main_dir = os.path.dirname(os.path.abspath(fn))
        with open(fn) as f:
            content += f.read() + "\n"
    return load_dcop(content, main_dir=main_dir)


def load_dcop(yaml_str: str, main_dir: Optional[str] = None) -> DCOP:
    import yaml  # lazy: the array path (compile_from_arrays) needs no PyYAML

    data = yaml.safe_load(yaml_str)
    if not isinstance(data, dict):
        raise DcopInvalidFormatError("DCOP yaml must be a mapping")

    dcop = DCOP(
        name=data.get("name", ""),
        objective=data.get("objective", "min"),
        description=data.get("description", ""),
    )

    domains = _parse_domains(data.get("domains", {}))
    for d in domains.values():
        dcop.domains[d.name] = d

    for v in _parse_variables(data.get("variables", {}), domains):
        dcop.add_variable(v)
    for v in _parse_external_variables(
        data.get("external_variables", {}), domains
    ):
        dcop.add_variable(v)

    for c in _parse_constraints(
        data.get("constraints", {}), dcop, main_dir=main_dir
    ):
        dcop.add_constraint(c)

    dcop.add_agents(_parse_agents(data.get("agents", {})))

    hints = data.get("distribution_hints")
    if hints:
        from pydcop_tpu_torch.distribution.objects import DistributionHints

        dcop.dist_hints = DistributionHints(
            must_host=hints.get("must_host", {}),
            host_with=hints.get("host_with", {}),
        )
    return dcop


def _parse_domain_values(raw_values: Iterable) -> List[Any]:
    values: List[Any] = []
    for v in raw_values:
        if isinstance(v, str):
            m = _RANGE_RE.match(v)
            if m:
                lo, hi = int(m.group(1)), int(m.group(2))
                values.extend(range(lo, hi + 1))
                continue
        values.append(v)
    return values


def _parse_domains(data: Mapping[str, Any]) -> Dict[str, Domain]:
    domains: Dict[str, Domain] = {}
    for name, dd in (data or {}).items():
        if "values" not in dd:
            raise DcopInvalidFormatError(f"Domain {name} has no values")
        values = _parse_domain_values(dd["values"])
        domains[name] = Domain(name, dd.get("type", ""), values)
    return domains


def _parse_variables(
    data: Mapping[str, Any], domains: Mapping[str, Domain]
) -> List[Variable]:
    out: List[Variable] = []
    for name, vd in (data or {}).items():
        vd = vd or {}
        dom_name = vd.get("domain")
        if dom_name is None:
            raise DcopInvalidFormatError(f"Variable {name} has no domain")
        if dom_name not in domains:
            raise DcopInvalidFormatError(
                f"Variable {name} uses unknown domain {dom_name}"
            )
        domain = domains[dom_name]
        initial = vd.get("initial_value")
        if initial is not None:
            initial = domain.to_domain_value(initial)
        cost_expr = vd.get("cost_function")
        if cost_expr is not None:
            cost_f = ExpressionFunction(str(cost_expr))
            free = set(cost_f.variable_names)
            if free != {name}:
                raise DcopInvalidFormatError(
                    f"cost_function of variable {name} must depend only on "
                    f"{name}, got {free}"
                )
            noise = vd.get("noise_level")
            if noise is not None:
                out.append(
                    VariableNoisyCostFunc(
                        name, domain, cost_f, initial, float(noise)
                    )
                )
            else:
                out.append(VariableWithCostFunc(name, domain, cost_f, initial))
        else:
            out.append(Variable(name, domain, initial))
    return out


def _parse_external_variables(
    data: Mapping[str, Any], domains: Mapping[str, Domain]
) -> List[ExternalVariable]:
    out: List[ExternalVariable] = []
    for name, vd in (data or {}).items():
        vd = vd or {}
        domain = domains[vd["domain"]]
        initial = vd.get("initial_value")
        if initial is not None:
            initial = domain.to_domain_value(initial)
        out.append(ExternalVariable(name, domain, initial))
    return out


def _parse_constraints(
    data: Mapping[str, Any], dcop: DCOP, main_dir: Optional[str] = None
) -> List[RelationProtocol]:
    out: List[RelationProtocol] = []
    all_vars = list(dcop.variables.values()) + list(
        dcop.external_variables.values()
    )
    for name, cd in (data or {}).items():
        ctype = cd.get("type")
        if ctype == "intention":
            expr = cd.get("function")
            if expr is None:
                raise DcopInvalidFormatError(
                    f"Intentional constraint {name} has no function"
                )
            source = cd.get("source")
            if source is not None:
                path = (
                    os.path.join(main_dir, source)
                    if main_dir and not os.path.isabs(source)
                    else source
                )
                out.append(
                    constraint_from_external_definition(
                        name, path, str(expr), all_vars
                    )
                )
            else:
                out.append(relation_from_str(name, str(expr), all_vars))
        elif ctype == "extensional":
            out.append(_parse_extensional(name, cd, dcop))
        else:
            raise DcopInvalidFormatError(
                f"Constraint {name}: unknown type {ctype!r} "
                "(expected 'intention' or 'extensional')"
            )
    return out


def _parse_extensional(
    name: str, cd: Mapping[str, Any], dcop: DCOP
) -> NAryMatrixRelation:
    var_names = cd.get("variables")
    if not var_names:
        raise DcopInvalidFormatError(
            f"Extensional constraint {name} has no variables"
        )
    variables = []
    for vn in var_names:
        if vn in dcop.variables:
            variables.append(dcop.variables[vn])
        elif vn in dcop.external_variables:
            variables.append(dcop.external_variables[vn])
        else:
            raise DcopInvalidFormatError(
                f"Extensional constraint {name} uses unknown variable {vn}"
            )
    default = float(cd.get("default", 0))
    shape = tuple(len(v.domain) for v in variables)
    matrix = np.full(shape, default, dtype=np.float32)
    values = cd.get("values", {}) or {}
    for cost, assignments_str in values.items():
        cost = float(cost)
        for assignment_str in str(assignments_str).split("|"):
            tokens = assignment_str.split()
            if len(tokens) != len(variables):
                raise DcopInvalidFormatError(
                    f"Extensional constraint {name}: assignment "
                    f"{assignment_str!r} does not match arity {len(variables)}"
                )
            idx = tuple(
                v.domain.index(v.domain.to_domain_value(t))
                for v, t in zip(variables, tokens)
            )
            matrix[idx] = cost
    return NAryMatrixRelation(variables, matrix, name=name)


def _parse_agents(data) -> List[AgentDef]:
    agents: List[AgentDef] = []
    if data is None:
        return agents
    if isinstance(data, list):
        return [AgentDef(str(a)) for a in data]
    for name, ad in data.items():
        ad = ad or {}
        hosting = ad.get("hosting", {}) or {}
        routes = dict(ad.get("routes", {}) or {})
        default_route = float(routes.pop("default", 1.0))
        extra = {
            k: v
            for k, v in ad.items()
            if k not in ("capacity", "hosting", "routes")
        }
        agents.append(
            AgentDef(
                str(name),
                capacity=float(ad.get("capacity", 100.0)),
                default_hosting_cost=float(hosting.get("default", 0.0)),
                hosting_costs={
                    str(k): float(v)
                    for k, v in (hosting.get("computations", {}) or {}).items()
                },
                default_route=default_route,
                routes={str(k): float(v) for k, v in routes.items()},
                **extra,
            )
        )
    return agents


# ---------------------------------------------------------------------------
# Dumping
# ---------------------------------------------------------------------------


def dcop_yaml(dcop: DCOP) -> str:
    """Serialize a DCOP to the YAML format (inverse of load_dcop for
    matrix/expression constraints)."""
    data: Dict[str, Any] = {
        "name": dcop.name,
        "objective": dcop.objective,
    }
    if dcop.description:
        data["description"] = dcop.description

    data["domains"] = {
        d.name: {
            "values": list(d.values),
            **({"type": d.type} if d.type else {}),
        }
        for d in dcop.domains.values()
    }

    variables = {}
    for v in dcop.variables.values():
        vd: Dict[str, Any] = {"domain": v.domain.name}
        if v.initial_value is not None:
            vd["initial_value"] = v.initial_value
        if isinstance(v, VariableWithCostFunc) and isinstance(
            v.cost_func, ExpressionFunction
        ):
            vd["cost_function"] = v.cost_func.expression
        if isinstance(v, VariableNoisyCostFunc):
            vd["noise_level"] = v.noise_level
        variables[v.name] = vd
    data["variables"] = variables

    if dcop.external_variables:
        data["external_variables"] = {
            v.name: {
                "domain": v.domain.name,
                "initial_value": v.value,
            }
            for v in dcop.external_variables.values()
        }

    constraints: Dict[str, Any] = {}
    for c in dcop.constraints.values():
        expr = getattr(c, "expression", None)
        if expr is not None:
            constraints[c.name] = {"type": "intention", "function": expr}
        else:
            m = c.as_matrix()
            # densest default = most frequent value
            vals, counts = np.unique(m.matrix, return_counts=True)
            default = float(vals[np.argmax(counts)])
            value_lines: Dict[float, List[str]] = {}
            it = np.nditer(m.matrix, flags=["multi_index"])
            for x in it:
                cost = float(x)
                if cost == default:
                    continue
                toks = " ".join(
                    str(v.domain[i])
                    for v, i in zip(m.dimensions, it.multi_index)
                )
                value_lines.setdefault(cost, []).append(toks)
            constraints[c.name] = {
                "type": "extensional",
                "variables": m.scope_names,
                "default": default,
                "values": {
                    cost: " | ".join(lines)
                    for cost, lines in value_lines.items()
                },
            }
    data["constraints"] = constraints

    agents: Dict[str, Any] = {}
    for a in dcop.agents.values():
        ad: Dict[str, Any] = {"capacity": a.capacity}
        if a.default_hosting_cost or a.hosting_costs:
            ad["hosting"] = {
                "default": a.default_hosting_cost,
                **(
                    {"computations": a.hosting_costs}
                    if a.hosting_costs
                    else {}
                ),
            }
        if a.routes or a.default_route != 1.0:
            ad["routes"] = {"default": a.default_route, **a.routes}
        ad.update(a.extra_attrs)
        agents[a.name] = ad
    data["agents"] = agents

    if dcop.dist_hints is not None:
        hints: Dict[str, Any] = {}
        if dcop.dist_hints.must_host_map:
            hints["must_host"] = dcop.dist_hints.must_host_map
        if dcop.dist_hints.host_with_map:
            hints["host_with"] = dcop.dist_hints.host_with_map
        if hints:
            data["distribution_hints"] = hints

    import yaml

    return yaml.safe_dump(data, sort_keys=False, default_flow_style=None)


# ---------------------------------------------------------------------------
# Scenario yaml
# ---------------------------------------------------------------------------


def load_scenario_from_file(filename: str) -> Scenario:
    with open(filename) as f:
        return load_scenario(f.read())


def load_scenario(yaml_str: str) -> Scenario:
    import yaml

    data = yaml.safe_load(yaml_str)
    events = []
    for ed in data.get("events", []):
        if "delay" in ed:
            events.append(
                ScenarioEvent(ed.get("id", ""), delay=float(ed["delay"]))
            )
        else:
            actions = []
            for ad in ed.get("actions", []):
                args = {k: v for k, v in ad.items() if k != "type"}
                actions.append(EventAction(ad["type"], **args))
            events.append(ScenarioEvent(ed.get("id", ""), actions=actions))
    return Scenario(events)


def yaml_scenario(scenario: Scenario) -> str:
    events = []
    for e in scenario:
        if e.is_delay:
            ed: Dict[str, Any] = {"delay": e.delay}
            if e.id:
                ed["id"] = e.id
        else:
            ed = {
                "id": e.id,
                "actions": [
                    {"type": a.type, **a.args} for a in e.actions
                ],
            }
        events.append(ed)
    import yaml

    return yaml.safe_dump({"events": events}, sort_keys=False)
