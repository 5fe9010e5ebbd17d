"""GDBA — Generalized Distributed Breakout for valued DCOPs.

Port of ``pydcop_tpu/algorithms/gdba.py`` for the batched engine, with
the three generalization axes of Okamoto, Zivan & Nahon's GDBA:

- ``modifier`` — ``A`` additive (eff = cost + w, w init 0) or ``M``
  multiplicative (eff = cost · w, w init 1).  Weights are PER CELL of
  each constraint's table: one ``w{k}: f32[m, d^k]`` per arity bucket,
  one row per constraint even when the bucket shares one base table.
- ``violation`` — judged on the raw table under the current assignment:
  ``NZ`` non-zero cost, ``NM`` above the table's minimum, ``MX`` at the
  table's maximum.
- ``increase_mode`` — which cells of a violated constraint's weights
  grow when an incident variable hits a quasi-local minimum: ``E`` the
  current cell, ``R`` the variable's row (own axis free, co-variables at
  their values), ``C`` its column (own axis at its value, co-cells
  free), ``T`` the whole table.

The improve exchange (strict neighborhood winner, lower index wins ties)
and quasi-local-minimum test are DBA's.  Deterministic: no draws.  The
candidate sweep builds each bucket position's edge rows as one block, in
the compiler's position-major edge order, so the blocks concatenate into
the edge axis without a scatter.

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
from pydcop_tpu_torch.ops.costs import neighbor_gather, segment_sum_edges

GRAPH_TYPE = "constraints_hypergraph"

algo_params = [
    AlgoParameterDef("modifier", "str", ["A", "M"], "A"),
    AlgoParameterDef("violation", "str", ["NZ", "NM", "MX"], "NZ"),
    AlgoParameterDef("increase_mode", "str", ["E", "R", "C", "T"], "E"),
    AlgoParameterDef("initial", "str", ["declared", "random"], "random"),
]


def _bucket_strides(k: int, d: int):
    return [d ** (k - 1 - q) for q in range(k)]


def init_state(
    problem: CompiledProblem,
    seed: int,
    params: Dict[str, Any],
    batch: Tuple[int, ...] = (),
) -> Dict[str, torch.Tensor]:
    init_w = 0.0 if params["modifier"] == "A" else 1.0
    state = {"values": init_values(problem, seed, params, batch)}
    d = problem.d_max
    for k, bucket in sorted(problem.buckets.items()):
        state[f"w{k}"] = torch.full(
            batch + (bucket.n_cons, d**k), init_w,
            dtype=problem.unary.dtype, device=problem.device,
        )
    return state


def draws(
    problem: CompiledProblem,
    params: Dict[str, Any],
    gen: torch.Generator,
    batch: Tuple[int, ...] = (),
) -> Dict[str, torch.Tensor]:
    return {}


def _violated(base_flat, cc_raw, vmode: str) -> torch.Tensor:
    if vmode == "NZ":
        return cc_raw > EPS
    tmin = base_flat.amin(dim=-1)
    if vmode == "NM":
        return cc_raw > tmin + EPS
    tmax = base_flat.amax(dim=-1)  # MX
    return (cc_raw >= tmax - EPS) & (tmax > tmin + EPS)


def effective_metrics(
    problem: CompiledProblem,
    values: torch.Tensor,
    weights: Dict[int, torch.Tensor],
    params: Dict[str, Any],
    axis=None,
):
    """``(improve, candidate, per_bucket, edge_violated)`` for one GDBA
    round under per-cell ``weights`` (``{arity: f32[..., m, d^k]}``):
    the weighted candidate sweep, per bucket ``(cur_cell, violated,
    vals)`` and the edge-projected violation flags.  Shared by
    :func:`apply` and the lockstep island (``_island_gdba.py``) so the
    three generalization axes cannot drift between them."""
    batch = tuple(values.shape[:-1])
    d = problem.d_max
    dt = problem.unary.dtype
    additive = params["modifier"] == "A"

    # -- per bucket: effective sweep rows and raw violation flags -------
    per_bucket = {}  # k -> (cur_cell, violated, vals)
    eff = {}
    for k, bucket in sorted(problem.buckets.items()):
        m = bucket.n_cons
        # a shared-table bucket broadcasts its one base row over all m
        base_flat = bucket.tables.reshape(bucket.tables.shape[0], d**k)
        base_flat = base_flat.expand(batch + (m, d**k))
        w = weights[k]
        eff_flat = base_flat + w if additive else base_flat * w
        vals = values[..., bucket.scopes64].long()  # [..., m, k]
        strides = _bucket_strides(k, d)
        cur_cell = sum(vals[..., q] * strides[q] for q in range(k))
        cc_raw = base_flat.gather(-1, cur_cell[..., None])[..., 0]
        violated = _violated(base_flat, cc_raw, params["violation"])
        per_bucket[k] = (cur_cell, violated, vals)
        eff[k] = eff_flat
    # edge-indexed rows by concatenation: edges are position-major per
    # (shard segment, arity) run, so the blocks in (segment, arity,
    # position) order tile the (shard's) edge axis
    n_segments = problem.n_shards if axis is None else 1
    ar = torch.arange(d, device=values.device)
    sweep_blocks, viol_blocks = [], []
    for seg in range(n_segments):
        for k, bucket in sorted(problem.buckets.items()):
            cur_cell, violated, vals = per_bucket[k]
            m = bucket.n_cons // n_segments
            rows = slice(seg * m, (seg + 1) * m)
            strides = _bucket_strides(k, d)
            for p in range(k):
                base_wo_p = cur_cell[..., rows] - vals[..., rows, p] * strides[p]
                cells = base_wo_p[..., None] + ar * strides[p]  # [..., m, d]
                sweep_blocks.append(eff[k][..., rows, :].gather(-1, cells))
                viol_blocks.append(violated[..., rows].to(dt))
    E = problem.n_edges
    if sweep_blocks:
        edge_sweep = torch.cat(sweep_blocks, dim=-2)
        edge_violated = torch.cat(viol_blocks, dim=-1)
        pad = E - edge_sweep.shape[-2]  # the compiler's min-1 edge pad
        if pad:
            edge_sweep = torch.nn.functional.pad(edge_sweep, (0, 0, 0, pad))
            edge_violated = torch.nn.functional.pad(edge_violated, (0, pad))
    else:  # constraint-free problem
        edge_sweep = torch.zeros(batch + (E, d), dtype=dt,
                                 device=values.device)
        edge_violated = torch.zeros(batch + (E,), dtype=dt,
                                    device=values.device)

    local = segment_sum_edges(
        problem, edge_sweep, dim=-2, axis=axis
    ) + problem.unary
    current, best = current_best(local, values)
    candidate = torch.argmin(local, dim=-1).to(values.dtype)
    improve = current - best
    return improve, candidate, per_bucket, edge_violated


def qlm_mask(
    problem: CompiledProblem,
    improve: torch.Tensor,
    edge_violated: torch.Tensor,
    axis=None,
) -> torch.Tensor:
    """bool[..., n_vars]: quasi-local minimum under the GDBA violation
    flags (edge-projected).  Shared by :func:`apply` and the lockstep
    island."""
    has_violation = segment_sum_edges(
        problem, edge_violated, dim=-1, axis=axis
    ) > 0.5
    nbr_improve = neighbor_gather(
        problem, improve, fill=-float("inf"), dim=-1
    ).amax(dim=-1)
    return has_violation & (torch.maximum(improve, nbr_improve) <= EPS)


def apply(
    problem: CompiledProblem,
    state: Dict[str, torch.Tensor],
    params: Dict[str, Any],
    drawn: Dict[str, torch.Tensor],
    axis=None,
) -> Dict[str, torch.Tensor]:
    values = state["values"]
    d = problem.d_max
    weights = {k: state[f"w{k}"] for k in sorted(problem.buckets)}
    improve, candidate, per_bucket, edge_violated = effective_metrics(
        problem, values, weights, params, axis
    )

    win = strict_winner(problem, improve, lexic_prio(problem)) & (
        improve > EPS
    )
    new_state = {"values": torch.where(win, candidate, values)}

    # -- quasi-local minimum and the weight increase ---------------------
    qlm = qlm_mask(problem, improve, edge_violated, axis)

    imode = params["increase_mode"]
    for k, bucket in sorted(problem.buckets.items()):
        cur_cell, violated, vals = per_bucket[k]
        strides = _bucket_strides(k, d)
        w = state[f"w{k}"]
        qlm_scope = qlm[..., bucket.scopes64]  # [..., m, k]
        cell_axis = torch.arange(d**k, device=values.device)
        delta = torch.zeros_like(w)
        for p in range(k):
            active = (violated & qlm_scope[..., p]).to(w.dtype)[..., None]
            if imode == "E":
                mask = torch.nn.functional.one_hot(cur_cell, d**k).to(w.dtype)
            elif imode == "T":
                mask = torch.ones_like(w)
            elif imode == "C":  # own axis at its value, co-cells free
                on_own = (cell_axis // strides[p]) % d == vals[..., p : p + 1]
                mask = on_own.to(w.dtype)
            else:  # R: own axis free, co-axes at their current values
                on_co = torch.ones_like(w, dtype=torch.bool)
                for q2 in range(k):
                    if q2 != p:
                        on_co &= (
                            (cell_axis // strides[q2]) % d
                            == vals[..., q2 : q2 + 1]
                        )
                mask = on_co.to(w.dtype)
            delta = delta + active * mask
        new_state[f"w{k}"] = w + delta
    return new_state


step = draw_apply_step(draws, apply)


def state_specs(problem) -> Dict[str, Any]:
    """Placement over a shard mesh: each bucket's weight rows split with
    its constraints, values replicated."""
    from pydcop_tpu_torch.parallel.mesh import SHARD_AXIS, P

    specs: Dict[str, Any] = {"values": P()}
    for k in problem.buckets:
        specs[f"w{k}"] = P(SHARD_AXIS)
    return specs


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
    """Neighbor values/improves plus a weight matrix per constraint."""
    cells = 0
    for c in node.constraints:
        sz = 1
        for v in c.dimensions:
            sz *= len(v.domain)
        cells += sz
    return (2 * len(node.neighbors) + cells) * UNIT_SIZE


def communication_load(
    node: _graph.VariableComputationNode, neighbor_name: str
) -> float:
    return 2 * UNIT_SIZE


def build_computation(comp_def, seed: int = 0):
    """Host message-driven computation (round-synchronized ok?/improve
    phases with synchronized per-cell weight increases — the
    reference's GDBA deployment shape); batched solving uses
    ``init_state``/``step``."""
    from pydcop_tpu_torch.algorithms import _host_gdba

    return _host_gdba.build_computation(comp_def, seed=seed)


def build_island(comp_defs, dcop, seed: int = 0, pending_fn=None, device=None):
    """LOCKSTEP compiled island on ``device`` (one batched step per
    global two-phase round — ``_island_gdba.py``): per-cell weight
    matrices live on the island, and ``(constraint, cells)`` flag lists
    cross the boundary payloads so endpoint weight copies stay equal
    under every modifier/violation/increase-mode combination."""
    from pydcop_tpu_torch.algorithms import _island_gdba

    return _island_gdba.build_island(
        comp_defs, dcop, seed=seed, pending_fn=pending_fn, device=device
    )
