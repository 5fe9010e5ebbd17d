"""MGM-2 — coordinated 2-opt local search (synchronous, 5-phase).

Port of ``pydcop_tpu/algorithms/mgm2.py`` for the batched engine: the
whole 5-phase round in one step.

1. *value* (implicit): the shared assignment.
2. *offer*: a Bernoulli(``probability``) draw splits variables into
   offerers and receivers; each offerer picks one uniformly random
   neighbor and offers every joint value pair, materialized on the
   receiver side as a [d, d] joint-gain matrix per (receiver, offering
   neighbor).
3. *accept*: each receiver takes the best pair move among its offers if
   its gain is positive; the chosen offerer reads the acceptance back
   from its partner (no scatter).
4. *gain*: committed pairs announce their joint gain, the others their
   best unilateral gain.
5. *go*: a committed pair moves iff both partners beat all their other
   neighbors (the lower index wins ties); the others move as in MGM.

Joint gains decompose as ``base − [local_v(a) − shared(a, cur_r) +
local_r(b) − shared(cur_v, b) + shared(a, b)]``, ``shared`` summing every
constraint that holds both partners, other scope variables at their
current values.  The per-pair ``shared`` tables are rebuilt each round
from a static (edge, co-position) → (variable, neighbor-slot) index that
is built once per problem on the host (numpy) and kept as state leaves
(``STATIC_STATE_KEYS``: shared by all restarts, not stacked).

Draws per round (the JAX step's ``k_role, k_partner = split(key)``):
``role f32[n]`` and ``partner i32[n]`` in ``[0, max(degree, 1))``.

Memory: the pair accumulator is ``f32[n_vars·max_degree, d, d]`` per
restart — heavy on dense hubs; prefer MGM there.

Message accounting: value + gain per directed link, plus offer / accept
/ go (≤ 1 each per variable) → ``2·Σ_v degree(v) + 3·n_vars``.
"""

from __future__ import annotations

import logging
import weakref
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from pydcop_tpu_torch.algorithms import AlgoParameterDef
from pydcop_tpu_torch.algorithms._common import (
    EPS,
    draw_apply_step,
    current_best,
    init_values,
    lexic_prio,
    strict_winner,
    uniform,
)
from pydcop_tpu_torch.graphs import constraints_hypergraph as _graph
from pydcop_tpu_torch.ops.compile import CompiledProblem
from pydcop_tpu_torch.ops.costs import (
    at_neighbors,
    fold_shards,
    local_cost_sweep,
)

GRAPH_TYPE = "constraints_hypergraph"

algo_params = [
    # probability of taking the offerer role each round
    AlgoParameterDef("probability", "float", None, 0.5),
    AlgoParameterDef("initial", "str", ["declared", "random"], "random"),
]

# state keys that are pure problem-derived index data (rebuilt
# identically by init_state, shared across restarts)
STATIC_STATE_KEYS = frozenset(
    {"pe_edge", "pe_copos", "pe_pair", "pe_valid", "pe_inv", "pe_inv_shard"}
)

# pair-accumulator cells (n_vars * max_degree * d^2) above which MGM-2
# warns, as the JAX package does
PAIR_CELLS_WARN = 1 << 27  # 512 MB of f32


def pair_cells(problem: CompiledProblem) -> int:
    """Cells of one restart's pair accumulator, n·max_degree·d²."""
    return problem.n_vars * problem.neighbors.shape[1] * problem.d_max**2


def init_state(
    problem: CompiledProblem,
    seed: int,
    params: Dict[str, Any],
    batch: Tuple[int, ...] = (),
) -> Dict[str, torch.Tensor]:
    cells = pair_cells(problem)
    if cells > PAIR_CELLS_WARN:
        logging.getLogger(__name__).warning(
            "MGM-2 pair accumulator needs %d cells per restart (~%.1f GB "
            "of f32) — on high-degree graphs prefer MGM",
            cells, cells * 4 / 1e9,
        )
    state = {"values": init_values(problem, seed, params, batch)}
    for key, arr in zip(
        ("pe_edge", "pe_copos", "pe_pair", "pe_valid", "pe_inv"),
        _pair_index(problem),
    ):
        state[key] = torch.from_numpy(arr).to(problem.device)
    if problem.n_shards > 1:
        state["pe_inv_shard"] = torch.from_numpy(
            _shard_inverse(problem)
        ).to(problem.device)
    return state


def state_specs(problem) -> Dict[str, Any]:
    """Placement over a shard mesh: the pair entries and the per-shard
    inverse index split with the edges; values and the whole-problem
    inverse index replicated."""
    from pydcop_tpu_torch.parallel.mesh import SHARD_AXIS, P

    sh = P(SHARD_AXIS)
    return {
        "values": P(), "pe_edge": sh, "pe_copos": sh, "pe_pair": sh,
        "pe_valid": sh, "pe_inv": P(), "pe_inv_shard": sh,
    }


# The index is pure problem structure, so it is built once per
# CompiledProblem: keyed by id() with a weakref guard against id reuse;
# entries evict themselves when their problem is garbage-collected.
_PAIR_CACHE: Dict[int, Any] = {}


def _pair_index(problem: CompiledProblem):
    """``(pe_edge, pe_copos, pe_pair, pe_valid, pe_inv)`` as the JAX
    package builds them, vectorized: one entry per (edge, co-position)
    whose co-variable is a real other variable, in edge-major order,
    mapped to ``owner·max_deg + slot`` (the slot of the co-variable in
    the owner's sorted neighbor row).  The entries are laid out
    shard-major with equal per-shard lengths (one shard unless the
    problem is sharded), each shard's padding pointing at its first edge
    with ``pe_valid`` false, so the arrays split over a mesh with the
    edges; ``pe_inv[q]`` lists pair slot q's entries in ascending order,
    padded with the sentinel ``n_pe`` (a zero row)."""
    hit = _PAIR_CACHE.get(id(problem))
    if hit is not None and hit[0]() is problem:
        return hit[1]
    edge_var = problem.edge_var.cpu().numpy().astype(np.int64)
    covars = problem.edge_covars.cpu().numpy().astype(np.int64)
    costr = problem.edge_costrides.cpu().numpy()
    nbrs = problem.neighbors.cpu().numpy().astype(np.int64)
    mask = problem.neighbor_mask.cpu().numpy()
    n, max_deg = nbrs.shape

    # ghost constraints self-reference their variable: skipped
    keep = (costr > 0) & (covars != edge_var[:, None])
    e_idx, p_idx = np.nonzero(keep)  # edge-major, position-minor
    owner = edge_var[e_idx]
    co = covars[e_idx, p_idx]
    # slot = np.searchsorted(owner's real sorted row, co): rows are
    # sorted and real entries are a prefix, so search the flat list of
    # (row, neighbor) keys, which is sorted too
    rows, cols = np.nonzero(mask)
    keys = rows * n + nbrs[rows, cols]
    row_start = np.concatenate([[0], np.cumsum(mask.sum(axis=1))])
    slot = np.searchsorted(keys, owner * n + co) - row_start[owner]

    # shard-major, equal per-shard lengths
    S = max(problem.n_shards, 1)
    eps = edge_var.shape[0] // S
    shard = e_idx // eps
    per_shard = np.bincount(shard, minlength=S)
    pe_len = max(int(per_shard.max(initial=0)), 1)
    start = np.concatenate([[0], np.cumsum(per_shard)[:-1]])
    at = shard * pe_len + np.arange(len(e_idx)) - start[shard]
    n_pe = pe_len * S
    pe_e = np.repeat(np.arange(S, dtype=np.int64) * eps, pe_len)
    pe_p = np.zeros(n_pe, dtype=np.int64)
    pe_q = np.zeros(n_pe, dtype=np.int64)
    pe_valid = np.zeros(n_pe, dtype=bool)
    pe_e[at] = e_idx
    pe_p[at] = p_idx
    pe_q[at] = owner * max_deg + slot
    pe_valid[at] = True

    pe_inv = _inverse(pe_q[at], at, n * max_deg, n_pe)
    out = (pe_e, pe_p, pe_q, pe_valid, pe_inv)
    key = id(problem)
    ref = weakref.ref(problem, lambda _: _PAIR_CACHE.pop(key, None))
    _PAIR_CACHE[key] = (ref, out)
    return out


def _inverse(q: np.ndarray, idx: np.ndarray, n_pairs: int, sentinel: int,
             width: int = 0) -> np.ndarray:
    """``[n_pairs, s_max]``: per pair slot, the entries ``idx`` that map
    to it (``q``), in ascending order, padded with ``sentinel``
    (at least ``width`` columns)."""
    counts = np.bincount(q, minlength=n_pairs)
    s_max = max(int(counts.max(initial=0)), 1, width)
    order = np.argsort(q, kind="stable")
    q_sorted = q[order]
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(len(q)) - starts[q_sorted]
    inv = np.full((n_pairs, s_max), sentinel, dtype=np.int64)
    inv[q_sorted, rank] = idx[order]
    return inv


def _shard_inverse(problem: CompiledProblem) -> np.ndarray:
    """``pe_inv_shard [n_shards·n_pairs, s_max]``: for each shard, in
    shard-major blocks, the inverse index over ITS entries (local entry
    ids, sentinel ``pe_len``): the pair sums of a sharded problem run
    shard by shard through it, with no scatter."""
    pe_e, _, pe_q, pe_valid, _ = _pair_index(problem)
    S = problem.n_shards
    pe_len = len(pe_e) // S
    n_pairs = problem.n_vars * problem.neighbors.shape[1]
    blocks = []
    for s in range(S):
        sl = slice(s * pe_len, (s + 1) * pe_len)
        local = np.nonzero(pe_valid[sl])[0]
        blocks.append(_inverse(pe_q[sl][local], local, n_pairs, pe_len))
    width = max(b.shape[1] for b in blocks)
    return np.concatenate([
        np.pad(b, ((0, 0), (0, width - b.shape[1])), constant_values=pe_len)
        for b in blocks
    ])


def _inverse_sum(sweeps: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """Per pair slot, the sum from zero of its entries' ``sweeps [...,
    P, d, d]`` in the order ``inv [n_pairs, s_max]`` lists them, one add
    per entry (scatter-free; the sentinel ``P`` reads a zero row)."""
    d = sweeps.shape[-1]
    sw_pad = torch.cat(
        [sweeps, sweeps.new_zeros(sweeps.shape[:-3] + (1, d, d))], dim=-3
    )
    acc = torch.zeros(
        sweeps.shape[:-3] + (inv.shape[0], d, d),
        dtype=sweeps.dtype, device=sweeps.device,
    )
    for s in range(inv.shape[1]):
        acc = acc + sw_pad.index_select(-3, inv[:, s])
    return acc


def _pair_shared(
    problem: CompiledProblem,
    state: Dict[str, torch.Tensor],
    values: torch.Tensor,
    axis=None,
) -> torch.Tensor:
    """f32[..., n_vars, max_deg, d, d]: summed shared-constraint tables
    per (variable, neighbor-slot), axes (own value, neighbor value),
    other scope variables fixed at ``values``.  Sharded (``axis``, or an
    unmeshed ``n_shards > 1`` problem): each shard sums its own entries
    through its own inverse index (entry ids made shard-local), and the
    shards' partials meet in one psum, added in shard order."""
    e = state["pe_edge"].long()
    if axis is not None:  # global edge ids -> this shard's local ones
        e = e - axis.index * problem.n_edges
    p = state["pe_copos"].long()
    covars = problem.index64("edge_covars")[e]  # [P, k-1]
    costr = problem.index64("edge_costrides")[e]  # [P, k-1]
    covals = values[..., covars].long()  # [..., P, k-1]
    sel = torch.arange(costr.shape[1], device=e.device) == p[:, None]
    base = problem.index64("edge_offset")[e] + torch.where(
        sel, 0, covals * costr
    ).sum(dim=-1)  # [..., P]
    d = problem.d_max
    ar = torch.arange(d, device=e.device)
    stride_own = problem.index64("edge_stride")[e]
    stride_nbr = costr.gather(1, p[:, None])[:, 0]
    cells = (
        base[..., None, None]
        + (ar[:, None] * stride_own[:, None, None])
        + (ar[None, :] * stride_nbr[:, None, None])
    )  # [..., P, d, d]
    sweeps = problem.tables_flat[cells]
    sweeps = torch.where(state["pe_valid"][:, None, None], sweeps, 0.0)
    if axis is not None:
        acc = axis.psum(_inverse_sum(sweeps, state["pe_inv_shard"].long()))
    elif problem.n_shards == 1:
        acc = _inverse_sum(sweeps, state["pe_inv"].long())
    else:
        S = problem.n_shards
        inv = state["pe_inv_shard"].long()
        pe_len, n_pairs = sweeps.shape[-3] // S, inv.shape[0] // S
        acc = fold_shards(
            _inverse_sum(sweeps.narrow(-3, s * pe_len, pe_len),
                         inv.narrow(0, s * n_pairs, n_pairs))
            for s in range(S)
        )
    n, deg = problem.neighbors.shape
    return acc.unflatten(-3, (n, deg))


def draws(
    problem: CompiledProblem,
    params: Dict[str, Any],
    gen: torch.Generator,
    batch: Tuple[int, ...] = (),
) -> Dict[str, torch.Tensor]:
    n = problem.n_vars
    degree = problem.neighbor_mask.sum(dim=1).clamp(min=1)
    u = torch.rand(
        batch + (n,), generator=gen, dtype=torch.float64, device=gen.device
    )
    return {
        "role": uniform(gen, batch + (n,)),
        "partner": torch.floor(u * degree.to(gen.device)).to(torch.int32),
    }


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., i, idx[..., i]]``: one entry per variable along the last
    axis of ``x [..., n, m]`` (``x`` broadcast over idx's batch axes)."""
    x = x.expand(idx.shape + x.shape[-1:])
    return x.gather(-1, idx.long()[..., None])[..., 0]


def apply(
    problem: CompiledProblem,
    state: Dict[str, torch.Tensor],
    params: Dict[str, Any],
    drawn: Dict[str, torch.Tensor],
    axis=None,
) -> Dict[str, torch.Tensor]:
    values = state["values"]
    n, deg = problem.neighbors.shape
    d = problem.d_max
    mask = problem.neighbor_mask
    nbr_idx = problem.neighbors  # [n, deg]
    ar_n = torch.arange(n, device=values.device)

    local = local_cost_sweep(problem, values, axis=axis)  # [..., n, d]
    current, uni_best = current_best(local, values)
    uni_candidate = torch.argmin(local, dim=-1).to(values.dtype)
    uni_gain = current - uni_best

    # -- phase 2: roles + offers --------------------------------------
    is_off = (drawn["role"] < params["probability"]) & mask.any(dim=1)
    ps = drawn["partner"].long()  # offerer's partner slot
    partner_off = _take(nbr_idx, ps)  # [..., n]
    offered = (
        mask
        & at_neighbors(problem, is_off, -1)
        & (at_neighbors(problem, partner_off, -1) == ar_n[:, None])
        & ~is_off[..., None]
    )  # [..., n(receiver), deg]

    # -- phase 3: accept — dense joint-gain scan ----------------------
    shared = _pair_shared(problem, state, values, axis)  # [..., n, deg, b, a]
    cur_v = at_neighbors(problem, values, -1).long()  # [..., n, deg]
    nb_local = at_neighbors(problem, local, -2)  # [..., n, deg, d]
    own = values.long()[..., :, None, None, None].expand(
        shared.shape[:-2] + (1, d)
    )
    s_cur_own = shared.gather(-2, own)[..., 0, :]  # shared(cur_r, a)
    s_cur_nbr = shared.gather(-1, cur_v[..., None, None].expand(
        shared.shape[:-1] + (1,)
    ))[..., 0]  # shared(b, cur_v)
    base_shared = s_cur_own.gather(-1, cur_v[..., None])[..., 0]
    nb_current = nb_local.gather(-1, cur_v[..., None])[..., 0]
    base = current[..., None] + nb_current - base_shared  # [..., n, deg]
    joint = (
        (nb_local - s_cur_own)[..., None, :]  # a terms
        + (local[..., :, None, :] - s_cur_nbr)[..., :, None]  # b terms
        + shared
    )  # [..., n, deg, b, a]
    gain2 = base[..., None, None] - joint
    gain2 = torch.where(offered[..., None, None], gain2, -float("inf"))
    flat = gain2.flatten(-3)  # [..., n, deg·d·d]
    best_flat = torch.argmax(flat, dim=-1)
    best_gain2 = flat.gather(-1, best_flat[..., None])[..., 0]
    j_star = best_flat // (d * d)
    b_star = ((best_flat // d) % d).to(values.dtype)
    a_star = (best_flat % d).to(values.dtype)
    accept = best_gain2 > EPS  # receivers only (offered masks roles)
    partner_recv = _take(nbr_idx, j_star)

    # relay acceptance back to the chosen offerer: offerer o's only
    # possible acceptor is its own partner, so o reads its decision
    po = partner_off.long()
    off_committed = (
        is_off
        & accept.gather(-1, po)
        & (partner_recv.gather(-1, po) == ar_n)
    )
    off_planned = a_star.gather(-1, po)
    off_gain = best_gain2.gather(-1, po)

    committed = off_committed | accept
    planned = torch.where(
        off_committed, off_planned,
        torch.where(accept, b_star, uni_candidate),
    )
    gain_msg = torch.where(
        off_committed, off_gain, torch.where(accept, best_gain2, uni_gain)
    )
    partner_idx = torch.where(off_committed, partner_off, partner_recv)
    partner_slot = torch.where(off_committed, ps, j_star)

    # -- phases 4–5: gain exchange + go -------------------------------
    # a committed pair does not compete with its partner
    slot_is_partner = (
        torch.arange(deg, device=values.device) == partner_slot[..., None]
    ) & committed[..., None]
    win = strict_winner(
        problem, gain_msg, lexic_prio(problem), slot_is_partner
    ) & (gain_msg > EPS)
    partner_win = win.gather(-1, partner_idx.long().clamp(0, n - 1))
    move = torch.where(committed, win & partner_win, win)
    return {**state, "values": torch.where(move, planned, values)}


step = draw_apply_step(draws, apply)


def values_from_state(state: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The assignment a state holds (``i32[n_vars]``, or ``[K, n_vars]``
    under restarts): the algorithm contract's result readout."""
    return state["values"]


def messages_per_round(
    problem: CompiledProblem, params: Optional[Dict[str, Any]] = None
) -> int:
    """Value + gain per directed link, plus offer/accept/go per var."""
    return 2 * int(problem.neighbor_mask.sum()) + 3 * problem.n_vars


# -- distribution-layer footprint callbacks ------------------------------

HEADER_SIZE = 0
UNIT_SIZE = 1


def computation_memory(node: _graph.VariableComputationNode) -> float:
    """Neighbor values, gains, and one pending offer matrix."""
    return 3 * len(node.neighbors) * UNIT_SIZE


def communication_load(
    node: _graph.VariableComputationNode, neighbor_name: str
) -> float:
    """Value + gain + (amortized) offer/accept/go per round."""
    return HEADER_SIZE + 5 * UNIT_SIZE


def build_computation(comp_def, seed: int = 0):
    """Host message-driven MGM-2 (thread/sim runtimes)."""
    from pydcop_tpu_torch.algorithms._host_mgm2 import (
        build_computation as _build,
    )

    return _build(comp_def, seed=seed)
