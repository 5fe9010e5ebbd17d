"""A-DSA — Asynchronous DSA, run as a batched activation schedule.

Port of ``pydcop_tpu/algorithms/adsa.py`` for the batched engine: each
round an independent Bernoulli(``activation``) draw decides which
variables wake up; awake variables apply the DSA variant rule (A/B/C)
and move with probability ``probability``; asleep variables keep their
value and send nothing.  ``activation=1.0`` is synchronous DSA.

Draws per round (the JAX step's ``k_wake, k_tie, k_move = split(key,
3)``): ``wake f32[n]``, ``tie f32[n, d]`` and ``move f32[n]``.

Message accounting: only awake variables send, so the expected count
per round is ``activation · Σ_v degree(v)``.
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
    # probability that a variable wakes up in a given round — the
    # asynchrony knob (1.0 == synchronous DSA)
    AlgoParameterDef("activation", "float", None, 0.5),
    AlgoParameterDef("initial", "str", ["declared", "random"], "random"),
    # host-runtime island scheduling (not used by the batched engine)
    AlgoParameterDef("island_rounds", "int", None, 4),
    AlgoParameterDef("island_start_rounds", "int", None, 64),
]

_DEFAULT_ACTIVATION = next(
    p.default for p in algo_params if p.name == "activation"
)


init_state = values_state


def draws(
    problem: CompiledProblem,
    params: Dict[str, Any],
    gen: torch.Generator,
    batch: Tuple[int, ...] = (),
) -> Dict[str, torch.Tensor]:
    n, d = problem.n_vars, problem.d_max
    return {
        "wake": uniform(gen, batch + (n,)),
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
    awake = drawn["wake"] < params["activation"]
    candidate, eligible = dsa_candidate_eligibility(
        local, values, drawn["tie"], params["variant"]
    )
    move = awake & eligible & (drawn["move"] < params["probability"])
    return {"values": torch.where(move, candidate, values)}


step = draw_apply_step(draws, apply)


def values_from_state(state: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The assignment a state holds (``i32[n_vars]``, or ``[K, n_vars]``
    under restarts): the algorithm contract's result readout."""
    return state["values"]


def messages_per_round(
    problem: CompiledProblem, params: Optional[Dict[str, Any]] = None
) -> int:
    """Expected directed value messages per round: activation · Σ deg(v)."""
    total = int(problem.neighbor_mask.sum())
    activation = float(
        (params or {}).get("activation", _DEFAULT_ACTIVATION)
    )
    return max(1, round(activation * total))


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
    """Host message-driven computation (async semantics parity path —
    see ``pydcop_tpu_torch.infrastructure``); solving runs on the batched
    engine via ``draws``/``apply``."""
    from pydcop_tpu_torch.algorithms import _host_dsa

    return _host_dsa.build_computation(comp_def, seed=seed)


def build_island(comp_defs, dcop, seed: int = 0, pending_fn=None, device=None):
    """Compiled-island deployment (``_island_dsa.py``): internal rounds
    step THIS module's batched activation schedule."""
    from pydcop_tpu_torch.algorithms import _island_dsa

    return _island_dsa.build_island(
        comp_defs, dcop, seed=seed, pending_fn=pending_fn, device=device
    )
