"""DSA — Distributed Stochastic Algorithm (synchronous variants A/B/C).

Port of ``pydcop_tpu/algorithms/dsa.py`` for the batched engine.  One
round for every variable at once:

1. ``local_cost_sweep`` gives each variable the cost of each candidate
   value under its neighbors' current values (the value messages);
2. delta(v) = local_cost(current) − min_x local_cost(x);
3. the variant rule decides eligibility (A: delta > 0; B: delta > 0, or
   delta == 0 while in conflict; C: always);
4. eligible variables adopt a uniformly random best value with
   probability ``probability``.

Draws per round (the JAX step's ``k_tie, k_move = split(key)``): ``tie
f32[n, d]`` and ``move f32[n]``.  A card run and a CPU run of the engine
draw from different generators, so they are compared through ``apply``
with shared draws, not bit for bit as whole runs.

Message accounting: one round = each variable sends its value to each
primal neighbor → ``Σ_v degree(v)`` directed messages.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from pydcop_tpu_torch.algorithms import AlgoParameterDef
from pydcop_tpu_torch.algorithms._common import (
    draw_apply_step,
    dsa_candidate_eligibility,
    uniform,
    values_state,
)
from pydcop_tpu_torch.graphs import constraints_hypergraph as _graph
from pydcop_tpu_torch.ops.compile import CompiledProblem
from pydcop_tpu_torch.ops.costs import local_cost_sweep

GRAPH_TYPE = "constraints_hypergraph"

# the host runtime's k_target migration rebuilds a dead agent's
# computations: these terminate by QUIESCENCE and re-sync a migrated
# neighbor via on_peer_restarted; phased round-barrier algorithms
# (mgm/mgm2/dba/gdba) would deadlock at the cycle barrier instead
# and are rejected at deploy time.
MIGRATION_SAFE = True

algo_params = [
    AlgoParameterDef("variant", "str", ["A", "B", "C"], "B"),
    AlgoParameterDef("probability", "float", None, 0.7),
    AlgoParameterDef("initial", "str", ["declared", "random"], "random"),
    # host-runtime island scheduling (not used by the batched engine)
    AlgoParameterDef("island_rounds", "int", None, 4),
    AlgoParameterDef("island_start_rounds", "int", None, 64),
]


init_state = values_state


def draws(
    problem: CompiledProblem,
    params: Dict[str, Any],
    gen: torch.Generator,
    batch: Tuple[int, ...] = (),
) -> Dict[str, torch.Tensor]:
    n, d = problem.n_vars, problem.d_max
    return {
        "tie": uniform(gen, batch + (n, d)),
        "move": uniform(gen, batch + (n,)),
    }


def apply(
    problem: CompiledProblem,
    state: Dict[str, torch.Tensor],
    params: Dict[str, Any],
    drawn: Dict[str, torch.Tensor],
    axis=None,
) -> Dict[str, torch.Tensor]:
    values = state["values"]
    local = local_cost_sweep(problem, values, axis=axis)  # [..., n, d]
    candidate, eligible = dsa_candidate_eligibility(
        local, values, drawn["tie"], params["variant"]
    )
    move = eligible & (drawn["move"] < params["probability"])
    return {"values": torch.where(move, candidate, values)}


step = draw_apply_step(draws, apply)


def values_from_state(state: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The assignment a state holds (``i32[n_vars]``, or ``[K, n_vars]``
    under restarts): the algorithm contract's result readout."""
    return state["values"]


def messages_per_round(
    problem: CompiledProblem, params: Optional[Dict[str, Any]] = None
) -> int:
    """Directed value messages per round = Σ_v degree(v)."""
    return int(problem.neighbor_mask.sum())


# -- distribution-layer footprint callbacks ------------------------------

HEADER_SIZE = 0
UNIT_SIZE = 1


def computation_memory(node: _graph.VariableComputationNode) -> float:
    """One value per neighbor (the last received value message)."""
    return len(node.neighbors) * UNIT_SIZE


def communication_load(
    node: _graph.VariableComputationNode, neighbor_name: str
) -> float:
    """One value message per round on each link."""
    return HEADER_SIZE + UNIT_SIZE


# -- host-runtime hooks (mode="sim"/"thread") ----------------------------


def build_computation(comp_def, seed: int = 0):
    """Host message-driven computation (async semantics parity path —
    see ``pydcop_tpu_torch.infrastructure``); solving runs on the batched
    engine via ``init_state``/``step``."""
    from pydcop_tpu_torch.algorithms import _host_dsa

    return _host_dsa.build_computation(comp_def, seed=seed)


def build_island(comp_defs, dcop, seed: int = 0, pending_fn=None, device=None):
    """Compiled-island deployment: one agent's placed variables as a
    single island on ``device`` behind per-variable proxies
    (``accel_agents`` on the host runtimes; ``_island_dsa.py``)."""
    from pydcop_tpu_torch.algorithms import _island_dsa

    return _island_dsa.build_island(
        comp_defs, dcop, seed=seed, pending_fn=pending_fn, device=device
    )
