"""Cost kernels over a :class:`CompiledProblem` (port of
``pydcop_tpu/ops/costs.py``, single device).

- :func:`segment_sum_edges` — sum a per-edge quantity into per-variable
  rows.
- :func:`local_cost_sweep` — every variable's full candidate-value cost
  row under the current assignment.
- :func:`total_cost` — solution cost of an assignment, on the device.
- :func:`neighbor_gather` — gather a per-variable quantity from each
  primal-graph neighbor.

``segment_sum_edges`` uses one lowering on every device: the per-slot
PREFIX gather sum over ``var_edges`` that the JAX package takes on the
TPU.  ``index_add_`` would be the other candidate, but on CUDA it adds
with atomics in an order that changes from run to run; the gather sum
adds in a fixed order, so a card run and a CPU run agree bit for bit.
"""

from __future__ import annotations

import torch

from pydcop_tpu_torch.ops.compile import CompiledProblem


def gather_sum_slots(
    problem: CompiledProblem, per_edge: torch.Tensor, acc: torch.Tensor
) -> torch.Tensor:
    """``acc`` plus, per variable, the sum of ``per_edge`` over its
    incoming edges; the edge axis of ``per_edge`` is its LAST axis and
    the variable axis of ``acc`` likewise.

    Variables are compiled degree-descending, so degree slot ``p``'s
    real entries are the first ``var_slot_counts[p]`` variables: slot
    by slot, that prefix is gathered and added in place (the slots are
    added in ascending order, one rounding per add — the order the JAX
    TPU lowering uses).  ``acc`` is not modified; the sum is returned.
    """
    ve_t = problem.var_edges_t  # [max_var_deg, n_vars]
    acc = acc.clone()
    for p, n_p in enumerate(problem.var_slot_counts):
        if n_p == 0:
            break  # counts are monotone over slots
        g = per_edge.index_select(-1, ve_t[p, :n_p])
        acc[..., :n_p] += g.to(acc.dtype)
    return acc


def segment_sum_edges(
    problem: CompiledProblem, per_edge: torch.Tensor
) -> torch.Tensor:
    """Sum per-edge rows into per-variable rows: [E, ...] → [n_vars, ...]."""
    moved = per_edge.movedim(0, -1)  # edges last
    acc = torch.zeros(
        moved.shape[:-1] + (problem.n_vars,),
        dtype=per_edge.dtype, device=per_edge.device,
    )
    return gather_sum_slots(problem, moved, acc).movedim(-1, 0)


def local_cost_sweep(
    problem: CompiledProblem, values: torch.Tensor
) -> torch.Tensor:
    """[n_vars, d_max]: cost of each candidate value for each variable,
    holding all other variables at ``values``."""
    co_vals = values[problem.edge_covars.long()]  # [E, k_max-1]
    base = problem.edge_offset.long() + (
        co_vals.long() * problem.edge_costrides.long()
    ).sum(dim=1)
    d = problem.d_max
    ar = torch.arange(d, device=values.device)
    cells = base[:, None] + ar[None, :] * problem.edge_stride.long()[:, None]
    sweeps = problem.tables_flat[cells]  # [E, d]
    return segment_sum_edges(problem, sweeps) + problem.unary


def total_cost(
    problem: CompiledProblem, values: torch.Tensor
) -> torch.Tensor:
    """0-dim tensor: cost of a full assignment (compiled sign: always a
    minimization cost; callers re-negate for max problems)."""
    v = values.long()
    scope_vals = v[problem.con_scopes.long()]  # [C, k_max]
    cell = problem.con_offset.long() + (
        scope_vals * problem.con_strides.long()
    ).sum(dim=1)
    con_cost = (
        problem.tables_flat[cell].sum()
        if problem.n_cons
        else torch.zeros((), dtype=problem.unary.dtype, device=v.device)
    )
    var_cost = problem.unary.gather(1, v[:, None])[:, 0].sum()
    return con_cost + var_cost


def neighbor_gather(
    problem: CompiledProblem, quantity: torch.Tensor, fill: float = 0.0
) -> torch.Tensor:
    """[n_vars, max_deg(, ...)]: ``quantity`` gathered from each primal
    neighbor, with ``fill`` on padding slots."""
    g = quantity[problem.neighbors.long()]  # [n, max_deg, ...]
    mask = problem.neighbor_mask
    mask = mask.reshape(mask.shape + (1,) * (g.ndim - 2))
    return torch.where(mask, g, torch.full_like(g, fill))
