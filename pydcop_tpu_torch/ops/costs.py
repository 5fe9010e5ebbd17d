"""Cost kernels over a :class:`CompiledProblem` (port of
``pydcop_tpu/ops/costs.py``, single device).

- :func:`segment_sum_edges` — sum a per-edge quantity into per-variable
  rows.
- :func:`edge_cells` / :func:`con_cells` — flat table cells of each
  edge's candidate sweep and of each constraint under an assignment.
- :func:`local_cost_sweep` — every variable's full candidate-value cost
  row under the current assignment.
- :func:`total_cost` — solution cost of an assignment, on the device.
- :func:`neighbor_gather` — gather a per-variable quantity from each
  primal-graph neighbor (:func:`at_neighbors` without the padding fill).

The JAX package runs parallel restarts under ``vmap``; here the restart
axis is written out: ``local_cost_sweep`` and ``total_cost`` take
``values`` of shape ``[..., n_vars]`` (leading batch axes, e.g.
``[K, n_vars]`` for K restarts) and keep the batch axes in front of
their result.

``segment_sum_edges`` uses one lowering on every device: the per-slot
PREFIX gather sum over ``var_edges`` that the JAX package takes on the
TPU.  ``index_add_`` would be the other candidate, but on CUDA it adds
with atomics in an order that changes from run to run; the gather sum
adds in a fixed order, so a card run and a CPU run agree bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch

from pydcop_tpu_torch.ops.compile import CompiledProblem


def gather_sum_slots(
    problem: CompiledProblem,
    per_edge: torch.Tensor,
    acc: torch.Tensor,
    dim: int = -1,
) -> torch.Tensor:
    """``acc`` plus, per variable, the sum of ``per_edge`` over its
    incoming edges; ``dim`` is the edge axis of ``per_edge`` and the
    variable axis of ``acc`` (the last axis by default).

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
        g = per_edge.index_select(dim, ve_t[p, :n_p])
        acc.narrow(dim, 0, n_p).add_(g.to(acc.dtype))
    return acc


def segment_sum_edges(
    problem: CompiledProblem, per_edge: torch.Tensor, dim: int = 0
) -> torch.Tensor:
    """Sum per-edge entries into per-variable entries: the edge axis
    ``dim`` of ``per_edge`` (length n_edges) becomes a variable axis
    (length n_vars)."""
    shape = list(per_edge.shape)
    shape[dim] = problem.n_vars
    acc = torch.zeros(shape, dtype=per_edge.dtype, device=per_edge.device)
    return gather_sum_slots(problem, per_edge, acc, dim)


def edge_cells(
    problem: CompiledProblem, values: torch.Tensor
) -> torch.Tensor:
    """i64[..., E, d_max]: the flat table cell of each directed edge's
    constraint with its own variable at each candidate value and the
    other scope variables at ``values [..., n_vars]``."""
    co_vals = values[..., problem.index64("edge_covars")].long()
    base = problem.index64("edge_offset") + (
        co_vals * problem.index64("edge_costrides")
    ).sum(dim=-1)  # [..., E]
    ar = torch.arange(problem.d_max, device=values.device)
    return base[..., None] + ar * problem.index64("edge_stride")[:, None]


def con_cells(problem: CompiledProblem, values: torch.Tensor) -> torch.Tensor:
    """i64[..., C]: the flat table cell of each constraint under the
    assignment ``values [..., n_vars]``."""
    scope_vals = values.long()[..., problem.index64("con_scopes")]
    return problem.index64("con_offset") + (
        scope_vals * problem.index64("con_strides")
    ).sum(dim=-1)


def local_cost_sweep(
    problem: CompiledProblem,
    values: torch.Tensor,
    edge_weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """[..., n_vars, d_max]: cost of each candidate value for each
    variable, holding all other variables at ``values [..., n_vars]``.
    ``edge_weight [..., E]`` scales each edge's constraint cells (DBA's
    weighted sweep)."""
    sweeps = problem.tables_flat[edge_cells(problem, values)]  # [..., E, d]
    if edge_weight is not None:
        sweeps = sweeps * edge_weight[..., None]
    return segment_sum_edges(problem, sweeps, dim=-2) + problem.unary


def total_cost(
    problem: CompiledProblem, values: torch.Tensor
) -> torch.Tensor:
    """[...]: cost of full assignments ``values [..., n_vars]`` (compiled
    sign: always a minimization cost; callers re-negate for max
    problems)."""
    v = values.long()
    con_cost = (
        problem.tables_flat[con_cells(problem, v)].sum(dim=-1)
        if problem.n_cons
        else torch.zeros(
            v.shape[:-1], dtype=problem.unary.dtype, device=v.device
        )
    )
    unary = problem.unary.expand(v.shape + (problem.d_max,))
    var_cost = unary.gather(-1, v[..., None])[..., 0].sum(dim=-1)
    return con_cost + var_cost


def at_neighbors(
    problem: CompiledProblem, quantity: torch.Tensor, dim: int = 0
) -> torch.Tensor:
    """``quantity`` read at every neighbor slot, padding slots included
    (they read variable 0, as ``quantity[neighbors]`` does in the JAX
    package): its variable axis ``dim`` (length n_vars) becomes two axes
    ``[n_vars, max_deg]``."""
    nbrs = problem.neighbors
    return quantity.index_select(dim, nbrs.reshape(-1)).unflatten(
        dim, nbrs.shape
    )


def neighbor_gather(
    problem: CompiledProblem,
    quantity: torch.Tensor,
    fill: float = 0.0,
    dim: int = 0,
) -> torch.Tensor:
    """:func:`at_neighbors` with ``fill`` on the padding slots."""
    g = at_neighbors(problem, quantity, dim)
    mask = problem.neighbor_mask
    trailing = quantity.dim() - dim % quantity.dim() - 1
    mask = mask.reshape(mask.shape + (1,) * trailing)
    return torch.where(mask, g, torch.full_like(g, fill))
