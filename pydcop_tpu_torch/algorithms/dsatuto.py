"""DSA-tuto — the minimal, pedagogical DSA.

Port of ``pydcop_tpu/algorithms/dsatuto.py``: DSA variant A with a fixed
move probability of 0.5 and random initial values, with no algorithm
parameters (the two island knobs belong to the host runtime).  It is the
whole batched-engine contract in a few lines:

- ``init_state`` — ``values`` drawn uniformly in each domain;
- ``draws`` — the round's one random tensor, ``move f32[n]`` (the JAX
  step draws it from its key unsplit);
- ``apply`` — ``local_cost_sweep`` gives each variable the cost of each
  candidate value under its neighbors' values; a variable moves to its
  best value when that is a strict improvement, with probability 0.5;
- ``step`` — ``apply`` of ``draws``;
- ``messages_per_round`` — one value message per primal neighbor.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from pydcop_tpu_torch.algorithms import AlgoParameterDef
from pydcop_tpu_torch.algorithms._common import (
    EPS,
    draw_apply_step,
    current_best,
    init_values,
    uniform,
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

# the tutorial ALGORITHM is parameter-free (fixed variant A, p = 0.5);
# the island knobs are host-runtime parameters (not used here)
algo_params = [
    AlgoParameterDef("island_rounds", "int", None, 4),
    AlgoParameterDef("island_start_rounds", "int", None, 64),
]

PROBABILITY = 0.5


def init_state(
    problem: CompiledProblem,
    seed: int,
    params: Dict[str, Any],
    batch: Tuple[int, ...] = (),
) -> Dict[str, torch.Tensor]:
    return {"values": init_values(problem, seed, {"initial": "random"}, batch)}


def draws(
    problem: CompiledProblem,
    params: Dict[str, Any],
    gen: torch.Generator,
    batch: Tuple[int, ...] = (),
) -> Dict[str, torch.Tensor]:
    return {"move": uniform(gen, batch + (problem.n_vars,))}


def apply(
    problem: CompiledProblem,
    state: Dict[str, torch.Tensor],
    params: Dict[str, Any],
    drawn: Dict[str, torch.Tensor],
    axis=None,
) -> Dict[str, torch.Tensor]:
    values = state["values"]
    local = local_cost_sweep(problem, values, axis=axis)  # [..., n, d]
    current, best = current_best(local, values)
    candidate = torch.argmin(local, dim=-1).to(values.dtype)
    move = (current - best > EPS) & (drawn["move"] < PROBABILITY)
    return {"values": torch.where(move, candidate, values)}


step = draw_apply_step(draws, apply)


def values_from_state(state: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The assignment a state holds (``i32[n_vars]``, or ``[K, n_vars]``
    under restarts): the algorithm contract's result readout."""
    return state["values"]


def messages_per_round(
    problem: CompiledProblem, params: Optional[Dict[str, Any]] = None
) -> int:
    """One value message to each primal neighbor per round."""
    return int(problem.neighbor_mask.sum())


# -- distribution-layer footprint callbacks ------------------------------

UNIT_SIZE = 1


def computation_memory(node: _graph.VariableComputationNode) -> float:
    return len(node.neighbors) * UNIT_SIZE


def communication_load(
    node: _graph.VariableComputationNode, neighbor_name: str
) -> float:
    return UNIT_SIZE


# -- host-runtime hooks (mode="sim"/"thread") ----------------------------


def build_computation(comp_def, seed: int = 0):
    """Host message-driven computation (async semantics parity path).

    dsatuto is parameter-free: strict-improvement moves at p = 0.5,
    matching the batched ``step`` above — NOT _host_dsa's B/0.7
    defaults."""
    from pydcop_tpu_torch.algorithms import _host_dsa

    return _host_dsa.build_computation(
        comp_def, seed=seed, variant="A", probability=0.5
    )


def build_island(comp_defs, dcop, seed: int = 0, pending_fn=None, device=None):
    """Compiled-island deployment (``_island_dsa.py``): internal rounds
    step this module's fixed A/0.5 rule."""
    from pydcop_tpu_torch.algorithms import _island_dsa

    return _island_dsa.build_island(
        comp_defs, dcop, seed=seed, pending_fn=pending_fn, device=device
    )
