"""DBA — Distributed Breakout (synchronous).

Port of ``pydcop_tpu/algorithms/dba.py`` for the batched engine.  Every
constraint carries a weight ``w_c`` (init 1) and search uses the
weighted cost ``w_c · cost_c``:

- each round every variable computes its best weighted-gain move
  (``improve``); only the strict neighborhood winner with positive
  improve moves (the lower index wins ties);
- a variable is at a quasi-local minimum when it has a violated incident
  constraint and nobody in its closed neighborhood can improve; the
  weights of violated constraints touching such a variable grow by
  ``increase``.

Deterministic: no draws.  Reported costs use the raw problem.

Message accounting: one ok + one improve message per directed primal
link per round = ``2·Σ_v degree(v)``.
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
    lexic_prio,
    strict_winner,
)
from pydcop_tpu_torch.graphs import constraints_hypergraph as _graph
from pydcop_tpu_torch.ops.compile import CompiledProblem
from pydcop_tpu_torch.ops.costs import (
    con_cells,
    local_cost_sweep,
    neighbor_gather,
    segment_sum_edges,
)

GRAPH_TYPE = "constraints_hypergraph"

INSTANCE_PARAM_AXES = {"increase": "constraints"}  # one value per constraint

algo_params = [
    AlgoParameterDef("initial", "str", ["declared", "random"], "random"),
    # weight added to each violated constraint at a quasi-local minimum
    AlgoParameterDef("increase", "float", None, 1.0),
    # host-runtime island scheduling (not used by the batched engine)
    AlgoParameterDef("island_start_rounds", "int", None, 64),
]


def init_state(
    problem: CompiledProblem,
    seed: int,
    params: Dict[str, Any],
    batch: Tuple[int, ...] = (),
) -> Dict[str, torch.Tensor]:
    return {
        "values": init_values(problem, seed, params, batch),
        "weights": torch.ones(
            batch + (problem.n_cons,), dtype=problem.unary.dtype,
            device=problem.device,
        ),
    }


def draws(
    problem: CompiledProblem,
    params: Dict[str, Any],
    gen: torch.Generator,
    batch: Tuple[int, ...] = (),
) -> Dict[str, torch.Tensor]:
    return {}


def _local_con(problem: CompiledProblem, axis=None) -> torch.Tensor:
    """edge → constraint ids, localized to this shard's weight block
    under ``axis`` (a shard view's ``edge_con`` holds global ids)."""
    edge_con = problem.index64("edge_con")
    if axis is None:
        return edge_con
    return edge_con - axis.index * problem.n_cons


def candidate_metrics(
    problem: CompiledProblem,
    values: torch.Tensor,
    weights: torch.Tensor,
    axis=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(improve, candidate, violated)`` for one DBA round: the
    weighted best-move sweep plus the raw per-constraint violation mask
    under the CURRENT assignment (the shard's constraints under
    ``axis``).  Shared by :func:`apply` and the lockstep island
    (``_island_dba.py``) so the formulas cannot drift between them."""
    edge_con = _local_con(problem, axis)
    # candidate-value costs with per-constraint weights
    local = local_cost_sweep(problem, values, weights[..., edge_con], axis)
    current, best = current_best(local, values)
    candidate = torch.argmin(local, dim=-1).to(values.dtype)
    improve = current - best  # >= 0
    violated = problem.tables_flat[con_cells(problem, values)] > EPS
    return improve, candidate, violated


def qlm_mask(
    problem: CompiledProblem,
    improve: torch.Tensor,
    violated: torch.Tensor,
    axis=None,
) -> torch.Tensor:
    """bool[..., n_vars]: at a quasi-local minimum — a violated incident
    constraint, and nobody in the CLOSED neighborhood improves.  Shared
    by :func:`apply` and the lockstep island."""
    edge_con = _local_con(problem, axis)
    edge_viol = violated[..., edge_con].to(problem.unary.dtype)
    has_violation = segment_sum_edges(
        problem, edge_viol, dim=-1, axis=axis
    ) > 0.5
    nbr_improve = neighbor_gather(
        problem, improve, fill=-float("inf"), dim=-1
    ).amax(dim=-1)
    stuck = torch.maximum(improve, nbr_improve) <= EPS
    return has_violation & stuck


def apply(
    problem: CompiledProblem,
    state: Dict[str, torch.Tensor],
    params: Dict[str, Any],
    drawn: Dict[str, torch.Tensor],
    axis=None,
) -> Dict[str, torch.Tensor]:
    values, weights = state["values"], state["weights"]
    improve, candidate, violated = candidate_metrics(
        problem, values, weights, axis
    )

    win = strict_winner(problem, improve, lexic_prio(problem)) & (
        improve > EPS
    )
    new_values = torch.where(win, candidate, values)

    qlm = qlm_mask(problem, improve, violated, axis)
    # weight += increase on violated constraints touching a QLM variable
    # (read through con_scopes; stride 0 marks padded scope slots, which
    # point at variable 0 and are masked out)
    scope_mask = problem.con_strides > 0  # [C, k_max]
    touch_qlm = (qlm[..., problem.index64("con_scopes")] & scope_mask).any(
        dim=-1
    )
    new_weights = torch.where(
        violated & touch_qlm, weights + params["increase"], weights
    )
    return {"values": new_values, "weights": new_weights}


step = draw_apply_step(draws, apply)


def state_specs(problem) -> Dict[str, Any]:
    """Placement over a shard mesh: the weights split with their
    constraints, values replicated."""
    from pydcop_tpu_torch.parallel.mesh import SHARD_AXIS, P

    return {"values": P(), "weights": P(SHARD_AXIS)}


def values_from_state(state: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The assignment a state holds (``i32[n_vars]``, or ``[K, n_vars]``
    under restarts): the algorithm contract's result readout."""
    return state["values"]


def messages_per_round(
    problem: CompiledProblem, params: Optional[Dict[str, Any]] = None
) -> int:
    """One ok + one improve message per directed link = 2·Σ degree."""
    return 2 * int(problem.neighbor_mask.sum())


# -- distribution-layer footprint callbacks ------------------------------

UNIT_SIZE = 1


def computation_memory(node: _graph.VariableComputationNode) -> float:
    """Neighbor values + improves, plus a weight per incident constraint."""
    return (2 * len(node.neighbors) + len(node.constraints)) * UNIT_SIZE


def communication_load(
    node: _graph.VariableComputationNode, neighbor_name: str
) -> float:
    return 2 * UNIT_SIZE


def build_computation(comp_def, seed: int = 0):
    """Host message-driven computation (round-synchronized ok?/improve
    phases with per-computation breakout weights — the reference's DBA
    deployment shape); batched solving uses ``init_state``/``step``."""
    from pydcop_tpu_torch.algorithms import _host_dba

    return _host_dba.build_computation(comp_def, seed=seed)


def build_island(comp_defs, dcop, seed: int = 0, pending_fn=None, device=None):
    """LOCKSTEP compiled island on ``device`` (one batched step per
    global two-phase round — ``_island_dba.py``): preserves the
    no-two-adjacent-movers invariant while interior ok?/improve messages
    become tensor ops; flags ride the boundary payloads so endpoint
    weight copies stay equal across the seam."""
    from pydcop_tpu_torch.algorithms import _island_dba

    return _island_dba.build_island(
        comp_defs, dcop, seed=seed, pending_fn=pending_fn, device=device
    )
