"""Repair-on-departure: re-host orphaned computations via a reparation
DCOP solved by this framework's own batched engine.

Role-equivalent to the reference's repair protocol (orchestrator +
``ResilientAgent`` halves): when an agent leaves, the agents holding
replicas of its computations decide among themselves who takes each one
over, by solving a small DCOP.  The reference formulates it with binary
"do I host it?" variables solved by local search; here each orphaned
computation gets one *selection* variable whose domain is its candidate
agents — an equivalent encoding of the same decision problem (a binary
one-hot vector over candidates ≡ one categorical variable) that keeps
constraint arity bounded for the problem compiler.

Costs mirror the reference's objective: hosting costs draw each
computation to its cheapest candidate, and a pairwise concentration
penalty (the soft form of the capacity constraint) spreads orphans
across agents.  After the solve, any remaining hard capacity violation
is projected out greedily (cheapest feasible alternative), which the
reference achieves by its hard constraints.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Mapping, Optional

import numpy as np


def build_reparation_dcop(
    candidates: Mapping[str, List[str]],
    agents: Mapping[str, "AgentDef"],
    footprint: Optional[Callable[[str], float]] = None,
    concentration_weight: float = 0.5,
):
    """Build the reparation DCOP.

    candidates: orphaned computation → candidate agent names (replica
    holders).  Returns the DCOP; its variables are named after the
    orphaned computations and their domains are the candidate agents.
    """
    from pydcop_tpu_torch.dcop.dcop import DCOP
    from pydcop_tpu_torch.dcop.objects import Domain, Variable
    from pydcop_tpu_torch.dcop.relations import NAryMatrixRelation

    dcop = DCOP("reparation", objective="min")
    variables: Dict[str, Variable] = {}
    for comp, cands in sorted(candidates.items()):
        if not cands:
            continue
        dom = Domain(f"cands_{comp}", "agents", list(cands))
        v = Variable(comp, dom)
        variables[comp] = v
        dcop.add_variable(v)
        hosting = np.array(
            [agents[a].hosting_cost(comp) for a in cands],
            dtype=np.float32,
        )
        dcop.add_constraint(
            NAryMatrixRelation([v], hosting, name=f"host_{comp}")
        )

    comps = sorted(variables)
    foot = footprint or (lambda c: 1.0)
    for i in range(len(comps)):
        for j in range(i + 1, len(comps)):
            c1, c2 = comps[i], comps[j]
            shared = set(candidates[c1]) & set(candidates[c2])
            if not shared:
                continue
            v1, v2 = variables[c1], variables[c2]
            m = np.zeros((len(v1.domain), len(v2.domain)), dtype=np.float32)
            for a in shared:
                m[v1.domain.index(a), v2.domain.index(a)] = (
                    concentration_weight * (foot(c1) + foot(c2))
                )
            dcop.add_constraint(
                NAryMatrixRelation([v1, v2], m, name=f"conc_{c1}_{c2}")
            )
    return dcop


def repair_placement(
    candidates: Mapping[str, List[str]],
    agentsdef: Iterable,
    remaining_capacity: Optional[Mapping[str, float]] = None,
    footprint: Optional[Callable[[str], float]] = None,
    algo: str = "mgm",
    rounds: int = 50,
    seed: int = 0,
    device=None,
) -> Dict[str, str]:
    """Decide new hosts for orphaned computations.

    Returns computation → new agent.  Computations with an empty
    candidate list are omitted (lost — the caller decides how to degrade).
    The reparation DCOP, when there is one to solve, runs through the
    port's ``api.solve`` on ``device`` (the CUDA device by default, as
    ``api.solve``; the dynamic engine passes its own).
    """
    agents = {a.name: a for a in agentsdef}
    solvable = {c: a for c, a in candidates.items() if a}
    if not solvable:
        return {}

    if len(solvable) == 1 or all(len(a) == 1 for a in solvable.values()):
        # nothing to coordinate: cheapest (or only) candidate wins
        chosen = {
            c: min(cands, key=lambda a: (agents[a].hosting_cost(c), a))
            for c, cands in solvable.items()
        }
    else:
        from pydcop_tpu_torch.api import solve

        dcop = build_reparation_dcop(solvable, agents, footprint)
        result = solve(
            dcop, algo, {}, rounds=rounds, seed=seed,
            convergence_chunks=1, chunk_size=16, device=device,
        )
        chosen = dict(result["assignment"])

    # hard-capacity projection (the reference's hard constraints)
    if remaining_capacity is not None:
        foot = footprint or (lambda c: 1.0)
        left = dict(remaining_capacity)
        final: Dict[str, str] = {}
        # place cheap-to-move computations last so big ones keep their slot
        for comp in sorted(chosen, key=lambda c: -foot(c)):
            agent = chosen[comp]
            if left.get(agent, 0.0) >= foot(comp):
                final[comp] = agent
                left[agent] -= foot(comp)
                continue
            alts = sorted(
                (
                    (agents[a].hosting_cost(comp), a)
                    for a in solvable[comp]
                    if left.get(a, 0.0) >= foot(comp)
                ),
            )
            if alts:
                final[comp] = alts[0][1]
                left[alts[0][1]] -= foot(comp)
            # else: truly no capacity anywhere → lost
        return final
    return chosen
