"""MGM — Maximum Gain Messages (synchronous, 2-phase).

Port of ``pydcop_tpu/algorithms/mgm.py`` for the batched engine: both
phases of a round in one step.  ``local_cost_sweep`` evaluates every
variable's candidate row; gain(v) = current − best; one
``neighbor_gather`` is the gain-message exchange; v moves iff its (gain,
priority) pair beats every neighbor's and gain > 0.  With
``break_mode='lexic'`` the lower index wins ties (deterministic: no
draws); with ``'random'`` the priorities are the round's one draw,
``prio f32[n]`` (the JAX step draws it from its key unsplit).  No two
neighbors move in one round, so the cost never increases.

Message accounting: one value + one gain message per directed primal
link → ``2·Σ_v degree(v)``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from pydcop_tpu_torch.algorithms import AlgoParameterDef
from pydcop_tpu_torch.algorithms._common import (
    EPS,
    draw_apply_step,
    current_best,
    lexic_prio,
    strict_winner,
    uniform,
    values_state,
)
from pydcop_tpu_torch.graphs import constraints_hypergraph as _graph
from pydcop_tpu_torch.ops.compile import CompiledProblem
from pydcop_tpu_torch.ops.costs import local_cost_sweep

GRAPH_TYPE = "constraints_hypergraph"

algo_params = [
    AlgoParameterDef("initial", "str", ["declared", "random"], "random"),
    # 'lexic': deterministic index tie-break (reference default);
    # 'random': random per-round priorities instead
    AlgoParameterDef("break_mode", "str", ["lexic", "random"], "lexic"),
    # host-runtime island scheduling (not used by the batched engine)
    AlgoParameterDef("island_start_rounds", "int", None, 64),
]


init_state = values_state


def draws(
    problem: CompiledProblem,
    params: Dict[str, Any],
    gen: torch.Generator,
    batch: Tuple[int, ...] = (),
) -> Dict[str, torch.Tensor]:
    if params.get("break_mode", "lexic") == "random":
        return {"prio": uniform(gen, batch + (problem.n_vars,))}
    return {}


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
    gain = current - best  # >= 0
    prio = drawn["prio"] if "prio" in drawn else lexic_prio(problem)
    win = strict_winner(problem, gain, prio) & (gain > EPS)
    return {"values": torch.where(win, candidate, values)}


step = draw_apply_step(draws, apply)


def values_from_state(state: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The assignment a state holds (``i32[n_vars]``, or ``[K, n_vars]``
    under restarts): the algorithm contract's result readout."""
    return state["values"]


def messages_per_round(
    problem: CompiledProblem, params: Optional[Dict[str, Any]] = None
) -> int:
    """One value + one gain message per directed link = 2·Σ degree."""
    return 2 * int(problem.neighbor_mask.sum())


# -- distribution-layer footprint callbacks ------------------------------

HEADER_SIZE = 0
UNIT_SIZE = 1


def computation_memory(node: _graph.VariableComputationNode) -> float:
    """Stores each neighbor's last value and last gain."""
    return 2 * len(node.neighbors) * UNIT_SIZE


def communication_load(
    node: _graph.VariableComputationNode, neighbor_name: str
) -> float:
    """One value + one gain message per round on each link."""
    return HEADER_SIZE + 2 * UNIT_SIZE


def build_computation(comp_def, seed: int = 0):
    """Host message-driven computation (round-synchronized value/gain
    phases over real messages — the reference's MGM deployment shape);
    batched solving uses ``init_state``/``step``."""
    from pydcop_tpu_torch.algorithms import _host_mgm

    return _host_mgm.build_computation(comp_def, seed=seed)


def build_island(comp_defs, dcop, seed: int = 0, pending_fn=None, device=None):
    """LOCKSTEP compiled island on ``device``: one agent's placed
    variables step as one batched sub-problem, once per GLOBAL two-phase
    round — the only island schedule that preserves MGM's
    no-two-adjacent-movers guarantee (``_island_mgm.py``; interior
    value/gain messages become tensor ops, the per-round trajectory
    replays the all-host run)."""
    from pydcop_tpu_torch.algorithms import _island_mgm

    return _island_mgm.build_island(
        comp_defs, dcop, seed=seed, pending_fn=pending_fn, device=device
    )
