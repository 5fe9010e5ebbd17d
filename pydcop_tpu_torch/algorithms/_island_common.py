"""Shared sub-problem construction for compiled islands (port of
``pydcop_tpu/algorithms/_island_common.py``).

Every island (Max-Sum's, the DSA family's, MGM's, DBA's, GDBA's) hosts
one agent's
placed variables as a compiled sub-DCOP in which each REMOTE scope
variable is represented by one **shadow variable** ``__shadow__<name>``
(shared across all boundary constraints that reference it).  This
module owns that construction so the per-algorithm islands stay pure
protocol + kernel logic.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple

import numpy as np

SHADOW = "__shadow__{}"


class IslandSubproblem(NamedTuple):
    problem: Any  # CompiledProblem of the owned + shadow sub-DCOP (device)
    slot: Dict[str, int]  # sub-problem variable name -> slot index
    labels: Dict[str, list]  # variable name -> domain label list
    shadow_slot: Dict[str, int]  # REMOTE variable name -> its slot
    remotes_of: Dict[str, List[str]]  # owned boundary var -> remotes
    owned_names: set
    base_unary: np.ndarray  # [n, d] unary costs (copy, mutable)
    owned_slots: np.ndarray  # sorted i64 slots of the owned variables


def build_subproblem(
    var_nodes: List[Any], dcop, name: str, device=None
) -> IslandSubproblem:
    """Compile one agent's constraints-hypergraph nodes + shadows onto
    ``device`` (default: the CUDA device)."""
    from pydcop_tpu_torch.dcop.dcop import DCOP
    from pydcop_tpu_torch.dcop.objects import Variable
    from pydcop_tpu_torch.dcop.relations import NAryMatrixRelation
    from pydcop_tpu_torch.ops.compile import compile_dcop

    owned = {n.variable.name: n.variable for n in var_nodes}
    sub = DCOP(name, objective=dcop.objective)
    for v in owned.values():
        sub.add_variable(v)
    shadow_vars: Dict[str, Variable] = {}
    shadow_real: Dict[str, str] = {}  # shadow name -> remote name
    remotes_of: Dict[str, List[str]] = {}
    seen_constraints: set = set()
    for n in var_nodes:
        vname = n.variable.name
        remotes: set = set()
        for c in n.constraints:
            remotes |= {
                d.name for d in c.dimensions if d.name not in owned
            }
            if c.name in seen_constraints:
                continue
            seen_constraints.add(c.name)
            scope = []
            for d in c.dimensions:
                if d.name in owned:
                    scope.append(d)
                    continue
                sname = SHADOW.format(d.name)
                if sname not in shadow_vars:
                    shadow_vars[sname] = Variable(sname, d.domain)
                    shadow_real[sname] = d.name
                    sub.add_variable(shadow_vars[sname])
                scope.append(shadow_vars[sname])
            sub.add_constraint(
                NAryMatrixRelation(
                    scope, c.as_matrix().matrix, name=c.name
                )
            )
        remotes.discard(vname)
        if remotes:
            remotes_of[vname] = sorted(remotes)

    problem = compile_dcop(sub, device=device)
    slot = {nm: i for i, nm in enumerate(problem.var_names)}
    labels = {
        nm: list(problem.domain_labels[slot[nm]])
        for nm in problem.var_names
    }
    return IslandSubproblem(
        problem=problem,
        slot=slot,
        labels=labels,
        shadow_slot={real: slot[s] for s, real in shadow_real.items()},
        remotes_of=remotes_of,
        owned_names=set(owned),
        base_unary=problem.unary.cpu().numpy().copy(),
        owned_slots=np.asarray(
            sorted(slot[v] for v in owned), dtype=np.int64
        ),
    )


#: derived fields of a CompiledProblem that do not depend on ``unary``
#: (``functools.cached_property`` entries; ``unary_t`` is left out)
_UNARY_FREE_CACHES = ("var_edges_t", "slot_sentinels", "_index64")


def with_unary(problem, unary):
    """``problem`` with its ``unary`` replaced by ``unary`` (a tensor on
    the problem's device): a NEW problem, so its ``unary_t`` is derived
    from the new rows, never a stale cache of the old ones.  The derived
    index fields that do not depend on ``unary`` carry over, so a flush
    recomputes none of them (``slot_sentinels`` would sync the device)."""
    import dataclasses

    new = dataclasses.replace(problem, unary=unary)
    for name in _UNARY_FREE_CACHES:
        if name in problem.__dict__:
            new.__dict__[name] = problem.__dict__[name]
    return new


def device_scope(device):
    """Make ``device`` the current CUDA device for the enclosed launches
    (an island flushes on its agent's thread, whose current device is
    not the island's); a no-op context on the CPU."""
    import contextlib

    import torch

    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
