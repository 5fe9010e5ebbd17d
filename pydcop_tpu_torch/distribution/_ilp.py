"""Shared 0/1 ILP placement model, solved with ``scipy.optimize.milp``.

The reference's ILP distributions (``ilp_fgdp.py``, ``ilp_compref.py``)
shell out to CBC/GLPK through ``pulp``; here the same mixed-integer
program is handed to scipy's HiGHS backend — placement is an offline
host-side step, so no device work is involved (SURVEY §2.8).

Model
-----
Binary ``x[c, a]`` = computation *c* hosted on agent *a*.

    min   Σ_{c,a} hosting_w · hcost(a, c) · x[c,a]
        + Σ_{(c1,c2) ∈ links, a ≠ b} comm_w · load(c1,c2) · route(a,b)
              · z[c1,c2,a,b]
    s.t.  Σ_a x[c,a] = 1                        ∀ c
          Σ_c mem(c) · x[c,a] ≤ capacity(a)     ∀ a
          z[c1,c2,a,b] ≥ x[c1,a] + x[c2,b] − 1  (linearized product)
          x binary, z ∈ [0, 1]

Because every z coefficient in the objective is ≥ 0 and minimized, z
settles at ``max(0, x1 + x2 − 1)`` — exactly the product — without
being declared integer, keeping the MIP small.
"""

from __future__ import annotations

from itertools import combinations
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from pydcop_tpu_torch.distribution.objects import (
    Distribution,
    DistributionHints,
    ImpossibleDistributionException,
)


def solve_ilp_placement(
    computation_graph,
    agentsdef: Iterable,
    hints: Optional[DistributionHints],
    computation_memory: Optional[Callable],
    communication_load: Optional[Callable],
    comm_w: float = 1.0,
    hosting_w: float = 1.0,
    time_limit: float = 60.0,
) -> Distribution:
    from scipy.optimize import Bounds, LinearConstraint, milp
    from scipy.sparse import lil_matrix

    agents = list(agentsdef)
    nodes = {n.name: n for n in computation_graph.nodes}
    comps = sorted(nodes)
    anames = [a.name for a in agents]
    n_c, n_a = len(comps), len(agents)
    if n_a == 0:
        raise ImpossibleDistributionException("No agents")
    cidx = {c: i for i, c in enumerate(comps)}
    aidx = {a: i for i, a in enumerate(anames)}

    def xvar(c: int, a: int) -> int:
        return c * n_a + a

    n_x = n_c * n_a

    # pairwise communication terms; a pair connected by several links
    # accumulates each link's load, matching distribution_cost's
    # per-link summation (distribution/_cost.py)
    pair_load: Dict[Tuple[int, int], float] = {}
    if communication_load is not None and comm_w != 0.0:
        for link in computation_graph.links:
            members = [m for m in link.nodes if m in nodes]
            for c1, c2 in combinations(sorted(members), 2):
                load = float(communication_load(nodes[c1], c2))
                if load:
                    key = (cidx[c1], cidx[c2])
                    pair_load[key] = pair_load.get(key, 0.0) + load
    pairs: List[Tuple[int, int, float]] = [
        (c1, c2, load) for (c1, c2), load in sorted(pair_load.items())
    ]

    # z variables: one per (pair, a, b) with a != b and route > 0
    z_entries: List[Tuple[int, int, int, int, float]] = []
    for p, (c1, c2, load) in enumerate(pairs):
        for ai in range(n_a):
            for bi in range(n_a):
                if ai == bi:
                    continue
                route = agents[ai].route(anames[bi])
                if route:
                    z_entries.append((c1, c2, ai, bi, load * route))
    n_z = len(z_entries)
    n_vars = n_x + n_z

    obj = np.zeros(n_vars)
    if hosting_w:
        for c in comps:
            for ai, agent in enumerate(agents):
                obj[xvar(cidx[c], ai)] += hosting_w * agent.hosting_cost(c)
    for zi, (c1, c2, ai, bi, w) in enumerate(z_entries):
        obj[n_x + zi] = comm_w * w

    constraints = []

    # assignment: sum_a x[c,a] = 1
    A = lil_matrix((n_c, n_vars))
    for c in range(n_c):
        for a in range(n_a):
            A[c, xvar(c, a)] = 1.0
    constraints.append(LinearConstraint(A.tocsr(), 1.0, 1.0))

    # capacity
    if computation_memory is not None:
        mem = np.array(
            [float(computation_memory(nodes[c])) for c in comps]
        )
        if mem.any():
            A = lil_matrix((n_a, n_vars))
            for a in range(n_a):
                for c in range(n_c):
                    A[a, xvar(c, a)] = mem[c]
            caps = np.array([a.capacity for a in agents])
            constraints.append(LinearConstraint(A.tocsr(), -np.inf, caps))

    # must_host pins: x[c, pinned_agent] = 1
    if hints is not None:
        for agent_name, pinned in hints.must_host_map.items():
            if agent_name not in aidx:
                raise ImpossibleDistributionException(
                    f"must_host references unknown agent {agent_name}"
                )
            for comp in pinned:
                if comp not in cidx:
                    continue
                A = lil_matrix((1, n_vars))
                A[0, xvar(cidx[comp], aidx[agent_name])] = 1.0
                constraints.append(LinearConstraint(A.tocsr(), 1.0, 1.0))
        # host_with: members share an agent → x[c1,a] - x[c2,a] = 0 ∀a
        done = set()
        for comp in comps:
            for mate in hints.host_with(comp):
                if mate not in cidx or (mate, comp) in done:
                    continue
                done.add((comp, mate))
                A = lil_matrix((n_a, n_vars))
                for a in range(n_a):
                    A[a, xvar(cidx[comp], a)] = 1.0
                    A[a, xvar(cidx[mate], a)] = -1.0
                constraints.append(LinearConstraint(A.tocsr(), 0.0, 0.0))

    # z linearization: x1 + x2 - z <= 1
    if n_z:
        A = lil_matrix((n_z, n_vars))
        for zi, (c1, c2, ai, bi, _w) in enumerate(z_entries):
            A[zi, xvar(c1, ai)] = 1.0
            A[zi, xvar(c2, bi)] = 1.0
            A[zi, n_x + zi] = -1.0
        constraints.append(LinearConstraint(A.tocsr(), -np.inf, 1.0))

    integrality = np.concatenate([np.ones(n_x), np.zeros(n_z)])
    bounds = Bounds(np.zeros(n_vars), np.ones(n_vars))
    # time_limit: identical agents make the branch-and-bound highly
    # symmetric; accept the incumbent rather than spin for optimality
    res = milp(
        c=obj,
        constraints=constraints,
        integrality=integrality,
        bounds=bounds,
        options={"time_limit": time_limit},
    )
    if res.x is None:
        raise ImpossibleDistributionException(
            f"ILP infeasible or failed: {res.message}"
        )

    mapping: Dict[str, List[str]] = {a: [] for a in anames}
    x = res.x[:n_x].reshape(n_c, n_a)
    for c, comp in enumerate(comps):
        mapping[anames[int(np.argmax(x[c]))]].append(comp)
    return Distribution(mapping)
