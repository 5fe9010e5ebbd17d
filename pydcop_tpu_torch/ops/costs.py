"""Cost kernels over a :class:`CompiledProblem` (port of
``pydcop_tpu/ops/costs.py``, single device).

- :func:`segment_sum_edges` — sum a per-edge quantity into per-variable
  rows.
- :func:`edge_cells` / :func:`con_cells` — flat table cells of each
  edge's candidate sweep and of each constraint under an assignment.
- :func:`local_cost_sweep` — every variable's full candidate-value cost
  row under the current assignment.
- :func:`total_cost` — solution cost of an assignment, on the device;
  :func:`instance_costs` the same per instance of a stacked problem,
  both summed by :func:`fixed_order_sum` (the same bits for a row
  alone, inside a batch, on the card or on the CPU).
- :func:`neighbor_gather` — gather a per-variable quantity from each
  primal-graph neighbor (:func:`at_neighbors` without the padding fill).

Sharded problems (``n_shards > 1``).  Under a shard mesh each of these
takes the shard's ``axis`` (``parallel/mesh.py:ShardAxis``): the shard
works on its local constraints and edges and the partial sums meet in
one ``psum``, added in shard order.  Without a mesh an ``n_shards > 1``
problem adds its segments in that same order, so a meshed run equals
the unmeshed run of the same problem bit for bit.

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

from pydcop_tpu_torch.ops.compile import CompiledProblem, StackedProblem


def gather_sum_slots(
    problem,
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
    TPU lowering uses).  Where a pad policy over-approximated a prefix,
    its sentinel entries read a zero row appended to ``per_edge``, as in
    the JAX package.  ``acc`` is not modified; the sum is returned.

    ``problem`` may be a :class:`StackedProblem`: ``per_edge`` and
    ``acc`` then lead with the instance axis, the edge and variable
    axes are the last ones, and instance i gathers through its own
    index (one ``gather`` per slot for all instances).
    """
    ve_t = problem.var_edges_t  # [(I,) max_var_deg, n_vars]
    if problem.slot_sentinels:
        shape = list(per_edge.shape)
        shape[dim] = 1
        per_edge = torch.cat([per_edge, per_edge.new_zeros(shape)], dim)
    stacked = isinstance(problem, StackedProblem)
    acc = acc.clone()
    for p, n_p in enumerate(problem.var_slot_counts):
        if n_p == 0:
            break  # counts are monotone over slots
        if stacked:
            idx = ve_t[:, p, :n_p].reshape(
                (ve_t.shape[0],) + (1,) * (per_edge.dim() - 2) + (n_p,)
            )
            g = per_edge.gather(-1, idx.expand(per_edge.shape[:-1] + (n_p,)))
        else:
            g = per_edge.index_select(dim, ve_t[p, :n_p])
        acc.narrow(dim, 0, n_p).add_(g.to(acc.dtype))
    return acc


def fold_shards(parts) -> torch.Tensor:
    """``((p0 + p1) + p2) + …``: the shards' partials added in the order
    of a shard mesh's psum (``parallel/mesh.py``)."""
    acc = None
    for x in parts:
        acc = x if acc is None else acc + x
    return acc


def segment_sum_edges(
    problem,
    per_edge: torch.Tensor,
    dim: int = 0,
    axis=None,
    dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Sum per-edge entries into per-variable entries, from zero, in
    ``dtype`` (default: ``per_edge``'s): the edge axis ``dim`` of
    ``per_edge`` (length n_edges) becomes a variable axis (length
    n_vars).

    With ``axis`` (a ``parallel.ShardAxis``), ``problem`` is a shard's
    view and ``per_edge`` holds its local edges: the shard's partial sum,
    then ``axis.psum`` across the mesh.  An unmeshed ``n_shards > 1``
    problem sums segment by segment (``problem.segments``) and adds the
    segments' partials in segment order, as the mesh's psum does, so
    the two agree bit for bit."""

    def partial(p, x):
        shape = list(x.shape)
        shape[dim] = problem.n_vars
        acc = torch.zeros(shape, dtype=dtype or x.dtype, device=x.device)
        return gather_sum_slots(p, x, acc, dim)

    if axis is not None:
        return axis.psum(partial(problem, per_edge))
    if problem.n_shards == 1:
        return partial(problem, per_edge)
    E_s = problem.n_edges // problem.n_shards
    return fold_shards(
        partial(seg, per_edge.narrow(dim, s * E_s, E_s))
        for s, seg in enumerate(problem.segments)
    )


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
    axis=None,
) -> torch.Tensor:
    """[..., n_vars, d_max]: cost of each candidate value for each
    variable, holding all other variables at ``values [..., n_vars]``.
    ``edge_weight [..., E]`` scales each edge's constraint cells (DBA's
    weighted sweep).  Under ``axis`` the shard sweeps its local edges and
    the partial sums meet in one psum."""
    sweeps = problem.tables_flat[edge_cells(problem, values)]  # [..., E, d]
    if edge_weight is not None:
        sweeps = sweeps * edge_weight[..., None]
    return segment_sum_edges(problem, sweeps, dim=-2, axis=axis) + problem.unary


def fixed_order_sum(*parts: torch.Tensor) -> torch.Tensor:
    """``parts`` concatenated along their last axis and summed over it,
    in one order that depends only on that axis's length: zero-padded
    to a power of two P, then halved (``x[..., :h] + x[..., h:]``) until
    one entry is left.

    ``torch.sum`` picks its reduction order from the whole shape and the
    device (how many rows, how long each, which kernel), so the same row
    summed alone and inside a batch can differ in the last bits.  These
    element-wise adds give every row the same bits whatever the leading
    axes and on every device: a lone solve and each instance of a group
    compute equal costs, and a card run equals a CPU run.  Types
    narrower than f32 (bf16 tables) add in f32 and round once at the
    end, as ``torch.sum`` accumulates them."""
    n = sum(p.shape[-1] for p in parts)
    size = 1 << max(n - 1, 0).bit_length()
    dtype = parts[0].dtype
    acc = torch.promote_types(dtype, torch.float32)
    pad = parts[0].new_zeros(parts[0].shape[:-1] + (size - n,), dtype=acc)
    buf = torch.cat([p.to(acc) for p in parts] + [pad], dim=-1)
    while size > 1:
        size //= 2
        buf = buf[..., :size] + buf[..., size:]
    return buf[..., 0].to(dtype)


def total_cost(
    problem: CompiledProblem, values: torch.Tensor, axis=None
) -> torch.Tensor:
    """[...]: cost of full assignments ``values [..., n_vars]`` (compiled
    sign: always a minimization cost; callers re-negate for max
    problems): the constraints' costs, then the variables', summed by
    :func:`fixed_order_sum`.

    An ``n_shards > 1`` problem sums each shard segment's constraints
    with :func:`fixed_order_sum`, adds the segments in segment order,
    then the variables' sum.  Under ``axis`` (a shard's view) the
    segments' sums meet in one psum: the same bits as the unmeshed
    problem's cost."""
    v = values.long()
    unary = problem.unary.expand(v.shape + (problem.d_max,))
    var_cost = unary.gather(-1, v[..., None])[..., 0]
    if axis is None and problem.n_shards == 1:
        con_cost = (
            problem.tables_flat[con_cells(problem, v)]
            if problem.n_cons
            else problem.unary.new_zeros(v.shape[:-1] + (0,))
        )
        return fixed_order_sum(con_cost, var_cost)

    def part(p):
        return fixed_order_sum(p.tables_flat[con_cells(p, v)])

    if axis is not None:
        con = axis.psum(part(problem))
    else:
        con = fold_shards(part(seg) for seg in problem.segments)
    return con + fixed_order_sum(var_cost)


def _instance_terms(stacked, v: torch.Tensor):
    """``(con [I, B, C], var [I, B, n])``: each instance's constraint
    and variable costs under ``v [I, B, n]`` (instance i's assignments
    against instance i's tables)."""
    sp = stacked.problem
    I, B, n = v.shape
    scopes = sp.con_scopes.long()  # [I, C, K]
    C, K = scopes.shape[1:]
    if C:
        sv = v.gather(-1, scopes.reshape(I, 1, C * K).expand(I, B, C * K))
        cells = sp.con_offset.long()[:, None] + (
            sv.view(I, B, C, K) * sp.con_strides.long()[:, None]
        ).sum(dim=-1)  # [I, B, C]
        con_cost = sp.tables_flat.gather(-1, cells.view(I, B * C)).view(
            I, B, C
        )
    else:
        con_cost = sp.unary.new_zeros((I, B, 0))
    unary = sp.unary[:, None].expand(I, B, n, stacked.d_max)
    var_cost = unary.gather(-1, v[..., None])[..., 0]
    return con_cost, var_cost


def instance_costs(
    stacked: StackedProblem, values: torch.Tensor, axis=None
) -> torch.Tensor:
    """``[I, ...]``: :func:`total_cost` of each instance of a stacked
    problem under ``values [I, ..., n_vars]`` (instance i's assignments
    against instance i's tables): the same cells summed by the same
    :func:`fixed_order_sum`, so each equals the instance's own
    ``total_cost`` bit for bit (segment by segment for ``n_shards >
    1``; under ``axis`` ``stacked`` is a shard's stacked view)."""
    I, n = values.shape[0], values.shape[-1]
    v = values.long().reshape(I, -1, n)  # [I, B, n]
    if axis is None and stacked.n_shards == 1:
        con_cost, var_cost = _instance_terms(stacked, v)
        out = fixed_order_sum(con_cost, var_cost)
    else:
        if axis is not None:
            con = axis.psum(fixed_order_sum(_instance_terms(stacked, v)[0]))
        else:
            con = fold_shards(
                fixed_order_sum(_instance_terms(seg, v)[0])
                for seg in stacked.segments
            )
        out = con + fixed_order_sum(_instance_terms(stacked, v)[1])
    return out.reshape(values.shape[:-1])


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
