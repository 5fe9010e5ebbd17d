"""Max-Sum — belief propagation on the factor graph (synchronous).

Port of ``pydcop_tpu/algorithms/maxsum.py`` for the batched engine.  The
whole factor graph's messages live in two ``[d, n_edges]`` tensors over
the compiler's directed edges (one per (constraint, scope position)):
``q`` (variable→factor) and ``r`` (factor→variable).  Edges are laid out
position-major per arity bucket, so each bucket position's messages are
one contiguous column block.

One round (factor-first, so one belief serves the q update and value
selection):

1. factor → variable per arity bucket: ``S = table ⊕ Σ_p q_p``,
   ``r_p = min over the other axes − q_p``, min-normalized.  On the card,
   when every bucket is binary, there is one shard and ``d ≤ 64``, this
   runs as the CUDA kernels of ``ops/maxsum_kernels.py`` (the gate of the
   JAX package's Pallas kernels); otherwise through the generic
   ``ops/semiring.py:bp_factor_messages``.
2. belief ``b_v = unary + noise + Σ incoming r`` (the per-slot prefix
   gather sum, ``ops/costs.py``);
3. q update ``q = damp·q + (1−damp)·norm(belief_e − r)``, with the
   broadcast-back gather ``belief_e = belief[:, edge_var]`` (in the
   message dtype) read inside it: the CUDA kernel on the card and its
   plain version on the CPU, for every problem; in f32, except for a
   bf16 belief (bf16 tables) outside the factor-kernel gate, which the
   JAX package computes in XLA in bf16: there the kernel rounds every
   operation to bf16 (``per_op``);
4. value selection ``values = argmin_d belief``.

Messages are stored in ``msg_dtype`` (f32 or bf16); the belief
accumulates in the unary's dtype.  One round = 2·n_real_edges directed
messages.  Deterministic: the round's generator is not used.

Restarts and instances (the JAX package's ``vmap``).  The state may
lead with batch axes: ``[R, d, E]`` messages for R restarts of one
problem, and ``[I, R, d, E]`` on a stacked problem
(``ops/compile.py:StackedProblem``, ``api.solve_many``).  Every round
still launches each kernel once: the kernels take the ``B = I·R``
batches in one launch, with the instance operands (tables, edge index,
per-instance damping) read at ``b // R``.  The belief gather and the
value argmin run per batch; batch b computes exactly what a run of its
restart alone computes.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from pydcop_tpu_torch.algorithms import AlgoParameterDef
from pydcop_tpu_torch.graphs import factor_graph as _graph
from pydcop_tpu_torch.ops import costs as _costs
from pydcop_tpu_torch.ops import maxsum_kernels
from pydcop_tpu_torch.ops import semiring as _semiring
from pydcop_tpu_torch.ops.compile import CompiledProblem, StackedProblem
from pydcop_tpu_torch.ops.padding import as_table_dtype

GRAPH_TYPE = "factor_graph"

# the host runtime's k_target migration rebuilds a dead agent's
# computations: these terminate by QUIESCENCE and re-sync a migrated
# neighbor via on_peer_restarted; phased round-barrier algorithms
# (mgm/mgm2/dba/gdba) would deadlock at the cycle barrier instead
# and are rejected at deploy time.
MIGRATION_SAFE = True

#: the engine solves several instances on the stacked problem (state
#: ``[I, R, ...]``) rather than on their disjoint union
INSTANCE_AXIS = True

algo_params = [
    AlgoParameterDef("damping", "float", None, 0.5),
    # per-(variable, value) perturbation added to the unary costs inside
    # the message math only — breaks ties; reported costs stay exact
    AlgoParameterDef("noise", "float", None, 0.001),
    AlgoParameterDef("initial", "str", ["declared", "random", "zero"], "zero"),
    # belief-aggregation lowering: 'auto' = the per-slot gather sum;
    # 'blockdiag' = one static variable-major permutation gather and
    # block-diagonal one-hot products (single problem only)
    AlgoParameterDef("belief", "str", ["auto", "blockdiag"], "auto"),
    # message storage dtype; arithmetic stays f32
    AlgoParameterDef("msg_dtype", "str", ["f32", "bf16"], "f32"),
    # branch-and-bound pruning of the generic factor path
    # (ops/semiring.py:bp_factor_messages): 'auto' prunes the arity
    # buckets whose per-factor config space d^k clears
    # BNB_AUTO_MIN_CELLS, 'on' every bucket outside the factor-kernel
    # gate, 'off' none; messages are bit-identical either way
    AlgoParameterDef("bnb", "str", ["auto", "on", "off"], "auto"),
    # host-runtime island scheduling (not used by the batched engine)
    AlgoParameterDef("island_rounds", "int", None, 4),
    AlgoParameterDef("island_start_rounds", "int", None, 64),
]


def _msg_dtype(problem: CompiledProblem, params: Dict[str, Any]):
    if as_table_dtype(params.get("msg_dtype"), allowed=("f32", "bf16")) == "bf16":
        return torch.bfloat16
    return problem.unary.dtype


_BLOCKDIAG_BLK = 128  # variables per one-hot block

# state keys that are pure problem-derived index data (rebuilt
# identically by init_state): shared by restarts, not checkpointed
STATIC_STATE_KEYS = frozenset({"bd_perm", "bd_onehot"})


def _blockdiag_index(problem: CompiledProblem):
    """``(perm i32[B·Lmax], onehot f32[B, Lmax, BLK])``, the JAX
    package's index: a variable-major padded edge order and the
    block-diagonal incidence such that ``einsum('dbl,blv->dbv',
    r_pad[:, perm].reshape(d, B, Lmax), onehot)`` is the per-variable
    sum of incoming r.  Host numpy, O(n_edges), built once by
    ``init_state`` and carried as state leaves."""
    BLK = _BLOCKDIAG_BLK
    ev = problem.edge_var.cpu().numpy()[: problem.n_edges]
    n = problem.n_vars
    n_blocks = (n + BLK - 1) // BLK
    counts = np.bincount(ev, minlength=n_blocks * BLK)
    block_counts = counts.reshape(n_blocks, BLK).sum(axis=1)
    lmax = max(int(block_counts.max()), 1)
    lmax = ((lmax + 127) // 128) * 128  # lane-align the block length
    cells = n_blocks * lmax * BLK
    if cells > (1 << 28):  # 1 GB of f32 incidence
        logging.getLogger(__name__).warning(
            "belief='blockdiag' incidence needs %d cells (~%.1f GB of "
            "f32: %d blocks x lmax=%d x %d) — a dense one-hot this "
            "size likely exceeds the win; high-degree hubs inflate "
            "lmax for EVERY block, prefer belief='auto' there",
            cells, cells * 4 / 1e9, n_blocks, lmax, BLK,
        )
    # edges by target variable; within its block, an edge's slot is its
    # rank after the block's first edge (the JAX package's loop, in one
    # vectorized pass)
    order = np.argsort(ev, kind="stable")
    var = ev[order]
    block = var // BLK
    block_start = np.zeros(n_blocks, dtype=np.int64)
    block_start[1:] = np.cumsum(block_counts)[:-1]
    pos = np.arange(len(order)) - block_start[block]
    perm = np.full(n_blocks * lmax, problem.n_edges, dtype=np.int32)
    perm[block * lmax + pos] = order
    onehot = np.zeros((n_blocks, lmax, BLK), dtype=np.float32)
    onehot[block, pos, var - block * BLK] = 1.0
    dev = problem.device
    return torch.from_numpy(perm).to(dev), torch.from_numpy(onehot).to(dev)


def _belief_blockdiag(problem, perm, onehot, r, unary_t) -> torch.Tensor:
    """Belief through ONE static permutation gather and one batched
    product per block: ``[*batch, d, E]`` r → ``[*batch, d, n_vars]``.

    The product ``dbl,blv->dbv`` is a dense f32 matmul (``torch.bmm``)
    that the JAX package computes outside any Pallas kernel.  It sums
    one-hot terms, so it is exact in f32 but for the order of the adds;
    TF32 would round r to 10 mantissa bits, so the product refuses to
    run with ``torch.backends.cuda.matmul.allow_tf32`` on."""
    if r.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "belief='blockdiag' needs f32 products: turn "
            "torch.backends.cuda.matmul.allow_tf32 off"
        )
    n_blocks, lmax, blk = onehot.shape
    lead = r.shape[:-1]  # (*batch, d)
    pad = r.new_zeros(lead + (1,))
    r_vm = torch.cat([r, pad], dim=-1).index_select(-1, perm)
    # [rows, B, L] -> [B, rows, L] @ [B, L, BLK] -> [B, rows, BLK]
    r_vm = r_vm.to(onehot.dtype).reshape(-1, n_blocks, lmax).transpose(0, 1)
    acc = torch.bmm(r_vm, onehot).transpose(0, 1)
    acc = acc.reshape(lead + (n_blocks * blk,))[..., : problem.n_vars]
    return acc + unary_t


def init_state(
    problem: CompiledProblem,
    seed: int,
    params: Dict[str, Any],
    batch: Tuple[int, ...] = (),
) -> Dict[str, torch.Tensor]:
    """Zero messages, initial values, and the noise ``[*batch, d,
    n_vars]`` (``batch``: ``(R,)`` for R restarts, each with its own
    noise and initial values).

    Random draws come from a CPU ``torch.Generator`` seeded with
    ``seed`` and are then moved to the problem's device, so a card run
    and a CPU run start from the same state.  (They are not the JAX
    package's draws: tests hand both packages the same numpy state.)
    """
    dev = problem.device
    E, d, n = problem.n_edges, problem.d_max, problem.n_vars
    gen = torch.Generator().manual_seed(int(seed))
    noise = params.get("noise", 0.0) * torch.rand(
        batch + (d, n), generator=gen, dtype=torch.float32
    )
    initial = params.get("initial", "zero")
    if initial == "random":
        sizes = problem.domain_sizes.cpu().to(torch.float64)
        u = torch.rand(batch + (n,), generator=gen, dtype=torch.float64)
        values = torch.floor(u * sizes).to(torch.int32).to(dev)
    elif initial == "declared":
        values = problem.init_idx.expand(batch + (n,)).clone()
    else:  # "zero"
        values = torch.zeros_like(problem.init_idx).expand(
            batch + (n,)
        ).clone()
    mdt = _msg_dtype(problem, params)
    state = {
        "q": torch.zeros(batch + (d, E), dtype=mdt, device=dev),
        "r": torch.zeros(batch + (d, E), dtype=mdt, device=dev),
        "values": values,
        "noise": noise.to(device=dev, dtype=problem.unary.dtype),
    }
    if params.get("belief", "auto") == "blockdiag":
        # problem structure, shared by every restart
        state["bd_perm"], state["bd_onehot"] = _blockdiag_index(problem)
    return state


def _template(problem) -> CompiledProblem:
    """The single-instance problem whose shapes a (stacked) problem has."""
    return problem.template if isinstance(problem, StackedProblem) else problem


def in_kernel_gate(problem) -> bool:
    """The JAX package's ``use_fused`` gate without its device condition:
    one shard, every bucket binary, and ``d ≤ MAX_D``."""
    problem = _template(problem)
    return (
        problem.n_shards == 1
        and set(problem.buckets) == {2}
        and problem.d_max <= maxsum_kernels.MAX_D
    )


def use_kernels(problem) -> bool:
    """The factor kernels run: tensors on the card, inside the gate."""
    return problem.device.type == "cuda" and in_kernel_gate(problem)


def belief_from_r(
    problem,
    r: torch.Tensor,
    unary_t: torch.Tensor,
    mode: str = "auto",
    axis=None,
) -> torch.Tensor:
    """``[*batch, d, n_vars]`` belief: ``unary_t`` + Σ incoming r per
    variable, accumulated in ``unary_t``'s dtype (f32) whatever r's
    dtype.

    ``mode="auto"``: the per-slot prefix gather sum of
    ``ops/costs.py:gather_sum_slots`` on every device (deterministic, so
    card and CPU runs agree bit for bit).  ``"blockdiag"``: the one-hot
    block products of :func:`_belief_blockdiag`, with the index built on
    the spot (``step`` carries it in the state instead).

    Sharded (``axis``, a shard's view and its local r; or an unmeshed
    ``n_shards > 1`` problem): the shards' partial sums from zero, added
    in shard order by one psum (``ops/costs.py:segment_sum_edges``), then
    the unary."""
    if axis is not None or _template(problem).n_shards > 1:
        return _costs.segment_sum_edges(
            problem, r, dim=-1, axis=axis, dtype=unary_t.dtype
        ) + unary_t
    if mode == "blockdiag":
        if isinstance(problem, StackedProblem):
            raise ValueError(
                "maxsum belief='blockdiag' indexes one problem's edges; a "
                "stacked group holds several graphs — use belief='auto'"
            )
        perm, onehot = _blockdiag_index(problem)
        return _belief_blockdiag(problem, perm, onehot, r, unary_t)
    return _costs.gather_sum_slots(problem, r, unary_t)


def _flat(x: torch.Tensor) -> torch.Tensor:
    """A ``[*batch, d, X]`` tensor as the kernels take it: ``[B, d, X]``
    with batch axes, ``[d, X]`` without."""
    return x.flatten(0, -3) if x.dim() > 3 else x


def step(
    problem,
    state: Dict[str, torch.Tensor],
    params: Dict[str, Any],
    gen: Optional[torch.Generator] = None,
    axis=None,
) -> Dict[str, torch.Tensor]:
    """One round on ``problem`` (a :class:`CompiledProblem`, or a
    :class:`StackedProblem` with the state ``[I, R, ...]``).  ``damping``
    is a float or, on a stacked problem, an f32 tensor of one value per
    instance.  Under a shard mesh ``problem`` is a shard's view, the
    messages are its local edges' and ``axis`` its
    ``parallel.ShardAxis``: the belief's psum is the round's one
    collective."""
    q = state["q"]  # [*batch, d, E]
    mdt = q.dtype
    damping = params["damping"]
    if not isinstance(damping, torch.Tensor):
        damping = float(damping)
    tmpl = _template(problem)
    unary_t = problem.unary_t + state["noise"]  # [*batch, d, n]
    fused = use_kernels(problem)
    lead = q.dim() - 2  # batch axes

    # -- 1. factor -> variable, per arity bucket ----------------------
    # (edges are position-major per (shard segment, arity) run: an
    # unmeshed n_shards > 1 problem runs its segments one after another)
    r_new = torch.empty_like(q)
    qk, rk = _flat(q), _flat(r_new)  # the kernels' [(B,) d, E]
    off = 0
    n_segments = tmpl.n_shards if axis is None else 1
    for seg, (k, bucket) in (
        (seg, kb)
        for seg in range(n_segments)
        for kb in sorted(problem.buckets.items())
    ):
        m = tmpl.buckets[k].n_cons // n_segments
        tab = bucket.tables_t  # [(I,) d, ..., d, m or 1]
        if not tmpl.buckets[k].shared_table:
            tab = tab[..., seg * m : (seg + 1) * m]

        def cols(x, p):
            return x[..., off + p * m : off + (p + 1) * m]

        if fused:  # k == 2 by the gate; the kernels write into r_new
            q_pos = [cols(qk, p) for p in range(k)]
            r_pos = tuple(cols(rk, p) for p in range(k))
            if tmpl.buckets[k].shared_table:
                maxsum_kernels.factor_round_binary_shared(
                    tab[..., 0], q_pos[0], q_pos[1], out=r_pos
                )
            else:
                maxsum_kernels.factor_round_binary(
                    tab, q_pos[0], q_pos[1], out=r_pos
                )
        else:
            if isinstance(problem, StackedProblem):  # [I, 1.., d.., m]
                tab = tab.reshape(
                    tab.shape[:1] + (1,) * (lead - 1) + tab.shape[1:]
                )
            # 'auto' gates on the raw per-factor config space d^k (BP
            # tables are never level-pack padded)
            bnb_mode = params.get("bnb", "auto")
            use_bnb = bnb_mode == "on" or (
                bnb_mode == "auto"
                and tmpl.d_max ** k >= _semiring.BNB_AUTO_MIN_CELLS
            )
            outs = _semiring.bp_factor_messages(
                _semiring.MIN_SUM, tab, [cols(q, p) for p in range(k)], mdt,
                bnb=use_bnb,
            )
            for p, src in enumerate(outs):
                cols(r_new, p).copy_(src)
        off += m * k

    # -- 2. variable -> factor + value selection ----------------------
    if "bd_perm" in state and axis is None:
        belief = _belief_blockdiag(
            problem, state["bd_perm"], state["bd_onehot"], r_new, unary_t
        )
    else:
        belief = belief_from_r(problem, r_new, unary_t, axis=axis)
    # outside the gate the JAX package computes in the belief's dtype
    per_op = belief.dtype == torch.bfloat16 and not in_kernel_gate(problem)
    # the q update reads belief[:, edge_var] (in the message dtype) itself
    q_new = maxsum_kernels.q_update(
        _flat(belief), problem.edge_var, rk, qk, damping, per_op
    ).view(q.shape)
    values = torch.argmin(belief, dim=-2).to(state["values"].dtype)
    return {**state, "q": q_new, "r": r_new, "values": values}


def state_specs(problem) -> Dict[str, Any]:
    """Placement of the state over a shard mesh: messages shard with
    their edges (the last axis), values and noise replicated."""
    from pydcop_tpu_torch.parallel.mesh import SHARD_AXIS, P

    sh = P(None, SHARD_AXIS)
    return {"q": sh, "r": sh, "values": P(), "noise": P()}


def values_from_state(state: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The assignment a state holds (``i32[n_vars]``, or ``[K, n_vars]``
    under restarts): the algorithm contract's result readout."""
    return state["values"]


def messages_per_round(
    problem: CompiledProblem, params: Optional[Dict[str, Any]] = None
) -> int:
    """q and r per REAL directed edge per round (one restart; ghost
    edges of the shard-major layout are not counted)."""
    return 2 * problem.n_real_edges


# -- distribution-layer footprint callbacks ------------------------------

UNIT_SIZE = 1
HEADER_SIZE = 0


def computation_memory(node) -> float:
    """Factor nodes store the table + one message per edge; variable
    nodes one message per neighbor."""
    if isinstance(node, _graph.FactorComputationNode):
        cells = 1
        for v in node.factor.dimensions:
            cells *= len(v.domain)
        return cells + sum(
            len(v.domain) for v in node.factor.dimensions
        )
    return sum(1 for _ in node.neighbors) * UNIT_SIZE


def communication_load(node, neighbor_name: str) -> float:
    """One cost vector (domain-sized message) per round per direction."""
    if isinstance(node, _graph.FactorComputationNode):
        for v in node.factor.dimensions:
            if v.name == neighbor_name:
                return HEADER_SIZE + len(v.domain)
    if hasattr(node, "variable"):
        return HEADER_SIZE + len(node.variable.domain)
    return HEADER_SIZE + UNIT_SIZE


# -- host-runtime hooks (mode="sim"/"thread") ----------------------------


def build_computation(comp_def, seed: int = 0):
    """Host message-driven computation (async semantics parity path —
    see ``pydcop_tpu_torch.infrastructure``); solving runs on the batched
    engine via ``init_state``/``step``."""
    from pydcop_tpu_torch.algorithms import _host_maxsum

    return _host_maxsum.build_computation(comp_def, seed=seed)


def build_island(comp_defs, dcop, seed: int = 0, pending_fn=None, device=None):
    """Compiled-island deployment: one agent's placed factor-graph nodes
    as a single island on ``device`` behind per-node proxies
    (``accel_agents`` on the host runtimes; ``_island_maxsum.py``)."""
    from pydcop_tpu_torch.algorithms import _island_maxsum

    return _island_maxsum.build_island(
        comp_defs, dcop, seed=seed, pending_fn=pending_fn, device=device
    )
