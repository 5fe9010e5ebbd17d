"""The problem compiler: DCOP model → device tensors.

Port of ``pydcop_tpu/ops/compile.py``.  The whole problem is tabulated
once, at setup time, into index arrays and dense cost tables; every
algorithm round then runs as tensor operations (and, on the card, the
hand-written kernels) over them.  The arrays are built in numpy exactly
as the JAX compiler builds them and handed to torch at the end, so each
tensor leaf equals the JAX package's leaf (``tests/test_torch_compile.py``
pins that).

Representation (see the JAX module for the full story):

- All domains are padded to ``d_max``; invalid values carry ``BIG``
  unary cost so no argmin ever selects them.
- **Flat form** (cost evaluation): all tables in one ``tables_flat``,
  each constraint at ``offset + Σ_j value_j · stride_j``.
- **Directed edges**, one per (constraint, scope position), laid out
  POSITION-MAJOR per arity bucket: each bucket position's messages are
  one contiguous ``[d, m]`` slice of the ``[d, E]`` message arrays.
- **Arity buckets** ``tables_t [d, ..., d, m]`` drive the Max-Sum factor
  phase; a bucket whose constraints all share one table keeps it once
  (``[d, ..., d, 1]``).

Shape bucketing (``pad_policy``, ``ops/padding.py``) pads the variable
count, each arity bucket's constraint count, the adjacency widths and
the flat-table length onto the pow-2 lattice with ghost variables and
zero-table ghost constraints, as the JAX compiler does, so that
similarly-sized problems share one shape (:func:`problem_group_key`)
and can be stacked (:func:`stack_problems`) for ``api.solve_many``.

``n_shards > 1`` compiles the JAX package's shard-major layout
(:func:`_shard_major_layout`): every arity bucket gets the same number
of rows on every shard, padded with zero-table ghost constraints, so the
constraint, edge and bucket arrays split into equal contiguous shard
blocks (``parallel/mesh.py:shard_problem``).  The ghosts never count as
messages (``n_real_edges``).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.dcop.objects import Variable
from pydcop_tpu_torch.dcop.relations import RelationProtocol
from pydcop_tpu_torch.device import DeviceLike, resolve_device
from pydcop_tpu_torch.ops.padding import (
    BIG,  # noqa: F401 (re-exported, as in the JAX package)
    NO_PADDING,
    PadPolicy,
    as_pad_policy,
    as_table_dtype,
    ghost_scopes,
    ghost_unary,
)

# Guard: dense tabulation over padded domains is d_max**arity cells.
MAX_ARITY = 6


@dataclasses.dataclass(frozen=True)
class ArityBucket:
    """Dense tables for all constraints of one arity.

    tables: [m, d_max, ..., d_max] (m = 1 for a shared table)
    tables_t: the same tables as [d_max, ..., d_max, m] — the Max-Sum
        layout (the constraint index is the fastest-moving axis)
    scopes: i32[m, k] — variable index per scope position
    edge_slot: i32[m, k] — global edge index of (constraint, position)
    """

    tables: torch.Tensor
    tables_t: torch.Tensor
    scopes: torch.Tensor
    edge_slot: torch.Tensor

    @property
    def n_cons(self) -> int:
        """Constraints in the bucket (tables may hold 1 shared entry
        instead of n_cons — consumers must size loops off THIS)."""
        return self.scopes.shape[0]

    @property
    def shared_table(self) -> bool:
        return self.tables.shape[0] == 1 and self.scopes.shape[0] > 1

    @functools.cached_property
    def scopes64(self) -> torch.Tensor:
        """``scopes`` as int64, converted once per bucket."""
        return self.scopes.long()

    def to(self, device: DeviceLike) -> "ArityBucket":
        dev = torch.device(device)
        return ArityBucket(
            *(getattr(self, f.name).to(dev) for f in dataclasses.fields(self))
        )


#: the tensor fields of :class:`CompiledProblem`, in declaration order
ARRAY_FIELDS = (
    "domain_sizes", "unary", "init_idx",
    "tables_flat", "con_offset", "con_scopes", "con_strides",
    "edge_var", "edge_con", "edge_offset", "edge_stride",
    "edge_covars", "edge_costrides",
    "neighbors", "neighbor_mask", "var_edges",
)

#: how the tensor fields of an ``n_shards > 1`` problem split over its
#: shards (:func:`shard_view`): the axis of each constraint or edge array,
#: ``None`` for a field every shard holds whole (``var_edges`` is replaced
#: by each shard's own slot table, :func:`slot_tables`)
SHARD_AXES = {
    f: (0 if f.startswith(("con_", "edge_")) else None) for f in ARRAY_FIELDS
}
BUCKET_SHARD_AXES = {"tables": 0, "tables_t": -1, "scopes": 0, "edge_slot": 0}

#: the host-side metadata fields of :class:`CompiledProblem`
META_FIELDS = (
    "var_names", "domain_labels", "con_names", "maximize", "n_shards",
    "n_real_edges", "var_slot_counts", "n_pad_vars",
)


@dataclasses.dataclass(frozen=True)
class CompiledProblem:
    """A DCOP compiled to tensors on one device (see module docstring)."""

    # -- per variable ---------------------------------------------------
    domain_sizes: torch.Tensor  # i32[n_vars]
    unary: torch.Tensor  # f32[n_vars, d_max]; BIG on padded values
    init_idx: torch.Tensor  # i32[n_vars]
    # -- flat constraint form ------------------------------------------
    tables_flat: torch.Tensor  # f32[total_cells]
    con_offset: torch.Tensor  # i32[n_con]
    con_scopes: torch.Tensor  # i32[n_con, k_max] (0-padded)
    con_strides: torch.Tensor  # i32[n_con, k_max] (0-padded)
    # -- directed edges (constraint, position) -------------------------
    edge_var: torch.Tensor  # i32[n_edges]
    edge_con: torch.Tensor  # i32[n_edges]
    edge_offset: torch.Tensor  # i32[n_edges]
    edge_stride: torch.Tensor  # i32[n_edges]
    edge_covars: torch.Tensor  # i32[n_edges, k_max-1] (0-padded)
    edge_costrides: torch.Tensor  # i32[n_edges, k_max-1] (0-padded)
    # -- primal-graph neighbor structure -------------------------------
    neighbors: torch.Tensor  # i32[n_vars, max_deg] (0-padded)
    neighbor_mask: torch.Tensor  # bool[n_vars, max_deg]
    # -- per-variable incoming-edge lists, padded with sentinel n_edges
    var_edges: torch.Tensor  # i32[n_vars, max_var_deg]
    # -- arity buckets for message-passing ------------------------------
    buckets: Dict[int, ArityBucket]
    # -- host-side metadata ---------------------------------------------
    var_names: Tuple[str, ...]
    domain_labels: Tuple[Tuple[Any, ...], ...]
    con_names: Tuple[str, ...]
    maximize: bool
    n_shards: int
    # directed edges of real constraints — the auditable message count
    n_real_edges: int
    # per var_edges slot p: how many variables have a REAL edge there.
    # Variables are compiled in degree-descending order, so column p's
    # real entries are the prefix [0, var_slot_counts[p]).
    var_slot_counts: Tuple[int, ...] = ()
    n_pad_vars: int = 0

    @property
    def n_vars(self) -> int:
        return self.unary.shape[0]

    @property
    def n_real_vars(self) -> int:
        return self.n_vars - self.n_pad_vars

    @property
    def d_max(self) -> int:
        return self.unary.shape[1]

    @property
    def n_cons(self) -> int:
        return self.con_offset.shape[0]

    @property
    def n_edges(self) -> int:
        return self.edge_var.shape[0]

    @property
    def device(self) -> torch.device:
        return self.unary.device

    @functools.cached_property
    def unary_t(self) -> torch.Tensor:
        """``unary`` transposed to ``[d_max, n_vars]`` and contiguous
        (the Max-Sum message layout)."""
        return self.unary.t().contiguous()

    @functools.cached_property
    def var_edges_t(self) -> torch.Tensor:
        """``var_edges`` transposed to ``[max_var_deg, n_vars]`` and
        contiguous: each degree slot's edge ids as one row, which the
        belief gather indexes every round."""
        return self.var_edges.t().contiguous()

    @functools.cached_property
    def slot_sentinels(self) -> bool:
        """Whether a degree slot's prefix holds the sentinel ``n_edges``
        (a pad policy over-approximates ``var_slot_counts``): the belief
        and sweep gathers then read a zero row appended to the edges."""
        ve_t = self.var_edges_t
        return any(
            bool((ve_t[p, :n_p] == self.n_edges).any())
            for p, n_p in enumerate(self.var_slot_counts)
            if n_p
        )

    @functools.cached_property
    def _index64(self) -> Dict[str, torch.Tensor]:
        return {}

    def index64(self, name: str) -> torch.Tensor:
        """The i32 index field ``name`` as int64 (what tensor indexing
        and flat-cell arithmetic take), converted once per problem."""
        cache = self._index64
        if name not in cache:
            cache[name] = getattr(self, name).long()
        return cache[name]

    @functools.cached_property
    def segments(self) -> Tuple["CompiledProblem", ...]:
        """The ``n_shards`` shard views of the problem on its own device
        (:func:`shard_view`): the sums of an ``n_shards > 1`` problem run
        segment by segment, in the order a shard mesh adds them."""
        tables = slot_tables([self])
        return tuple(
            shard_view(self, s, slots=tables[s]) for s in range(self.n_shards)
        )

    def to(self, device: DeviceLike) -> "CompiledProblem":
        dev = torch.device(device)
        moved = {f: getattr(self, f).to(dev) for f in ARRAY_FIELDS}
        moved["buckets"] = {
            k: b.to(dev) for k, b in self.buckets.items()
        }
        return dataclasses.replace(self, **moved)


def _resolve_table_dtype(table_dtype, dtype) -> torch.dtype:
    """Map the ``table_dtype`` vocabulary onto a torch dtype; ``None``
    keeps ``dtype``.  int8 packs belong to the contraction stack (DPOP
    and inference), not to the message-passing engines."""
    if table_dtype is None:
        return dtype
    dt = as_table_dtype(table_dtype)
    if dt == "int8":
        raise ValueError(
            "table_dtype='int8' is only supported by the contraction "
            "stack; the message-passing engines take 'f32' or 'bf16'"
        )
    return torch.bfloat16 if dt == "bf16" else torch.float32


def _check_supported(n_shards: int, pad_policy, table_format) -> PadPolicy:
    """Refuse what this compiler does not take; return the pad policy."""
    if int(n_shards) != n_shards or n_shards < 1:
        raise ValueError(f"n_shards must be an integer >= 1, got {n_shards}")
    if table_format not in (None, "dense"):
        raise ValueError(
            f"table_format={table_format!r}: the message-passing "
            "engines run on dense tables only"
        )
    return as_pad_policy(pad_policy)


def compile_dcop(
    dcop: DCOP,
    dtype: torch.dtype = torch.float32,
    n_shards: int = 1,
    pad_policy="none",
    table_dtype=None,
    table_format=None,
    device: DeviceLike = None,
) -> CompiledProblem:
    """Tabulate and pack a DCOP into a :class:`CompiledProblem` on
    ``device`` (default: the CUDA device; see ``device.py``).

    ``max`` objectives are compiled by negating all costs (solvers
    always minimize).  Variables are compiled in degree-descending
    order; assignments in and out are keyed by name.  ``pad_policy``
    (``"none"``, ``"pow2"``, ``"pow2:<floor>"`` or a ``PadPolicy``)
    buckets every array dimension with ghost variables and constraints
    (``ops/padding.py``).  Under an active telemetry session the call
    records a ``compile-problem`` span.
    """
    from pydcop_tpu_torch.telemetry import get_tracer

    tr = get_tracer()
    if not tr.enabled:
        return _compile_dcop(
            dcop, dtype, n_shards, pad_policy, table_dtype, table_format,
            device,
        )
    t0 = time.perf_counter()
    problem = _compile_dcop(
        dcop, dtype, n_shards, pad_policy, table_dtype, table_format, device,
    )
    tr.add_span(
        "compile-problem", "compile", t0, time.perf_counter() - t0,
        n_vars=int(problem.n_vars), n_edges=int(problem.n_edges),
        n_shards=n_shards,
    )
    return problem


def _compile_dcop(
    dcop, dtype, n_shards, pad_policy, table_dtype, table_format, device,
) -> CompiledProblem:
    pol = _check_supported(n_shards, pad_policy, table_format)
    dev = resolve_device(device)
    dtype = _resolve_table_dtype(table_dtype, dtype)

    variables: List[Variable] = list(dcop.variables.values())
    if not variables:
        raise ValueError("Cannot compile a DCOP with no variables")
    _ext = set(dcop.external_variables)
    _deg: Dict[str, int] = {v.name: 0 for v in variables}
    for c in dcop.constraints.values():
        scope_live = [n for n in c.scope_names if n not in _ext]
        if len(scope_live) >= 2:
            for n in scope_live:
                if n in _deg:
                    _deg[n] += 1
    variables.sort(key=lambda v: -_deg.get(v.name, 0))
    var_names = tuple(v.name for v in variables)
    var_idx = {n: i for i, n in enumerate(var_names)}
    n_vars = len(variables)
    d_max = max(len(v.domain) for v in variables)
    sign = -1.0 if dcop.objective == "max" else 1.0

    ext_values: Dict[str, Any] = {
        name: ev.value for name, ev in dcop.external_variables.items()
    }

    domain_sizes = np.array(
        [len(v.domain) for v in variables], dtype=np.int32
    )
    domain_labels = tuple(tuple(v.domain.values) for v in variables)

    unary = np.zeros((n_vars, d_max), dtype=np.float32)
    for i, v in enumerate(variables):
        dlen = len(v.domain)
        if v.has_cost:
            for k in range(dlen):
                unary[i, k] = sign * v.cost_for_val(v.domain[k])
        unary[i, dlen:] = BIG

    init_idx = np.zeros(n_vars, dtype=np.int32)
    for i, v in enumerate(variables):
        if v.initial_value is not None:
            init_idx[i] = v.domain.index(v.initial_value)

    # External variables are fixed at their current value (sliced out);
    # unary results fold into `unary`.
    multi_cons: List[Tuple[str, List[int], np.ndarray]] = []
    for c in dcop.constraints.values():
        scope_ext = [n for n in c.scope_names if n in ext_values]
        if scope_ext:
            c = c.slice({n: ext_values[n] for n in scope_ext})
        scope = [n for n in c.scope_names]
        if len(scope) == 0:
            continue  # fully external constraint: constant, ignore
        if len(scope) > MAX_ARITY:
            raise ValueError(
                f"Constraint {c.name} has arity {len(scope)} > "
                f"MAX_ARITY={MAX_ARITY}; dense tabulation would need "
                f"{d_max}^{len(scope)} cells"
            )
        table = _tabulate_padded(c, d_max) * sign
        if len(scope) == 1:
            i = var_idx[scope[0]]
            dlen = int(domain_sizes[i])
            unary[i, :dlen] += table[:dlen]
        else:
            multi_cons.append(
                (c.name, [var_idx[n] for n in scope], table)
            )

    n_real_edges = sum(len(scope) for _, scope, _ in multi_cons)

    # shape bucketing: ghost variables first (pinned to value 0 at zero
    # cost); the ghost constraints below scope them, so the real
    # variables' adjacency is untouched
    n_pad_vars = 0
    ghost_vars: List[int] = []
    if pol.enabled:
        n_pad_vars = pol.bucket(n_vars) - n_vars
        if n_pad_vars:
            ghost_vars = list(range(n_vars, n_vars + n_pad_vars))
            domain_sizes = np.concatenate(
                [domain_sizes, np.ones(n_pad_vars, dtype=np.int32)]
            )
            unary = np.concatenate([unary, ghost_unary(n_pad_vars, d_max)])
            init_idx = np.concatenate(
                [init_idx, np.zeros(n_pad_vars, dtype=np.int32)]
            )
            var_names = var_names + tuple(
                f"__pad_v{i}" for i in range(n_pad_vars)
            )
            domain_labels = domain_labels + ((0,),) * n_pad_vars
            n_vars += n_pad_vars

    if n_shards > 1:
        multi_cons = _shard_major_layout(
            multi_cons, n_shards, d_max, policy=pol, ghost_vars=ghost_vars
        )
    else:
        # arity-major (stable) order: every arity bucket's constraints —
        # and so its edges — occupy one contiguous range of the edge array
        multi_cons = sorted(multi_cons, key=lambda it: len(it[1]))
        if pol.enabled:
            multi_cons = _pad_arity_groups(multi_cons, pol, d_max, ghost_vars)
    con_names = tuple(name for name, _, _ in multi_cons)

    # one run per (shard segment, arity); the ghost constraints padded
    # onto a run's tail are counted so packing keeps their edges out of
    # var_edges under a pad policy
    n_cons = len(multi_cons)
    per_seg = n_cons // n_shards
    runs: List[Tuple[int, np.ndarray, np.ndarray, int]] = []
    for seg in range(n_shards):
        i, end = seg * per_seg, (seg + 1) * per_seg
        while i < end:
            k = len(multi_cons[i][1])
            j = i
            while j < end and len(multi_cons[j][1]) == k:
                j += 1
            sc = np.asarray(
                [multi_cons[ci][1] for ci in range(i, j)], dtype=np.int32
            ).reshape(j - i, k)
            tb = np.stack([multi_cons[ci][2] for ci in range(i, j)])
            tail = 0
            while tail < j - i and _is_ghost_name(multi_cons[j - 1 - tail][0]):
                tail += 1
            runs.append((k, sc, tb, tail))
            i = j

    packed = _pack_runs(runs, n_vars, d_max, dtype, dev, pol)

    return CompiledProblem(
        domain_sizes=torch.as_tensor(domain_sizes, device=dev),
        unary=_float_tensor(unary, dtype, dev),
        init_idx=torch.as_tensor(init_idx, device=dev),
        var_names=var_names,
        domain_labels=domain_labels,
        con_names=con_names,
        maximize=dcop.objective == "max",
        n_shards=n_shards,
        n_real_edges=n_real_edges,
        n_pad_vars=n_pad_vars,
        **packed,
    )


def _is_ghost_name(name: str) -> bool:
    """Ghost constraints: shard-divisibility padding (``__ghost_``) and
    pad-policy bucketing (``__pad_c``)."""
    return name.startswith("__ghost_") or name.startswith("__pad_c")


def _shard_major_layout(
    multi_cons: List[Tuple[str, List[int], np.ndarray]],
    n_shards: int,
    d_max: int,
    policy: PadPolicy = NO_PADDING,
    ghost_vars: Sequence[int] = (),
) -> List[Tuple[str, List[int], np.ndarray]]:
    """The constraints reordered shard-major, with equal per-shard,
    per-arity bucket sizes (the JAX package's layout): each arity's
    constraints are padded up to ``per_shard · n_shards`` with zero-table
    ghosts (scoped on the pad-policy ghost variables, cycled, or on
    variable 0) and dealt round-robin, so shard s owns rows ``[s·m_k,
    (s+1)·m_k)`` of bucket k and every shard's list is arity-sorted.  A
    constraint-free problem gets one ghost binary constraint per shard,
    so that every sharded axis still splits."""
    import math

    ghost_targets = list(ghost_vars) or [0]
    by_arity: Dict[int, List[Tuple[str, List[int], np.ndarray]]] = {}
    for item in multi_cons:
        by_arity.setdefault(len(item[1]), []).append(item)
    if not by_arity:
        by_arity[2] = []
    shards: List[List[Tuple[str, List[int], np.ndarray]]] = [
        [] for _ in range(n_shards)
    ]
    for k in sorted(by_arity):
        items = by_arity[k]
        per_shard = max(1, math.ceil(len(items) / n_shards))
        if policy.enabled:
            per_shard = policy.bucket(per_shard)
        need = per_shard * n_shards - len(items)
        gscopes = ghost_scopes(ghost_targets, need, k)
        for i in range(need):
            items.append((
                f"__ghost_{k}_{i}",
                list(gscopes[i]),
                np.zeros((d_max,) * k, dtype=np.float32),
            ))
        for i, item in enumerate(items):
            shards[i % n_shards].append(item)
    return [item for shard in shards for item in shard]


def _pad_arity_groups(
    multi_cons: List[Tuple[str, List[int], np.ndarray]],
    policy: PadPolicy,
    d_max: int,
    ghost_vars: Sequence[int],
) -> List[Tuple[str, List[int], np.ndarray]]:
    """Pad each arity group of an arity-sorted constraint list up to the
    policy's bucket with zero-table ghost constraints scoped on the
    ghost variables (cycled; variable 0 when the variable count already
    sat on a bucket boundary — the tables are all zero and the edges
    never enter ``var_edges``)."""
    out: List[Tuple[str, List[int], np.ndarray]] = []
    i = 0
    gi = 0
    while i < len(multi_cons):
        k = len(multi_cons[i][1])
        j = i
        while j < len(multi_cons) and len(multi_cons[j][1]) == k:
            j += 1
        group = multi_cons[i:j]
        need = policy.bucket(len(group)) - len(group)
        scopes = ghost_scopes(ghost_vars, need, k, start=gi)
        gi += need
        for t in range(need):
            group.append((
                f"__pad_c{k}_{t}",
                list(scopes[t]),
                np.zeros((d_max,) * k, dtype=np.float32),
            ))
        out.extend(group)
        i = j
    return out


def _float_tensor(
    a: np.ndarray, dtype: torch.dtype, device: torch.device
) -> torch.Tensor:
    """f32 numpy → ``dtype`` on ``device`` (bf16 rounds to nearest
    even, as ``jnp.asarray(..., dtype=bfloat16)`` does)."""
    return torch.as_tensor(
        np.ascontiguousarray(a, dtype=np.float32)
    ).to(device=device, dtype=dtype)


def _pack_runs(
    runs: Sequence[Tuple[int, np.ndarray, np.ndarray, int]],
    n_vars: int,
    d_max: int,
    dtype: torch.dtype,
    device: torch.device,
    policy: PadPolicy = NO_PADDING,
) -> Dict[str, Any]:
    """Vectorized packing of constraint runs into the flat + edge +
    bucket tensors of :class:`CompiledProblem`.

    ``runs`` is the constraint list in its final (arity-sorted) order,
    as contiguous same-arity runs ``(k, scopes i32[m, k], tables
    f32[m, d_max^k], ghost_tail)``; ``ghost_tail`` counts the zero-table
    ghost constraints a pad policy appended to the run.  A run whose
    tables have leading dim 1 while its scopes have m > 1 is a
    **shared-table run**: all m constraints use the one table, stored
    once in the flat form (every offset points at it) and kept as
    ``[1, ...]`` in the bucket.

    With an enabled ``policy``, ghost edges stay out of ``var_edges``,
    and the flat-table length, the adjacency widths and the
    ``var_slot_counts`` prefixes are quantized (``ops/padding.py``).
    """
    k_max = max((k for k, _, _, _ in runs), default=2)
    k_max = max(k_max, 2)
    n_cons = sum(sc.shape[0] for _, sc, _, _ in runs)

    def _is_shared(sc: np.ndarray, tb: np.ndarray) -> bool:
        return tb.shape[0] == 1 and sc.shape[0] > 1

    total_cells = sum(
        (1 if _is_shared(sc, tb) else sc.shape[0]) * d_max**k
        for k, sc, tb, _ in runs
    )
    if total_cells > np.iinfo(np.int32).max:
        raise ValueError(
            f"problem too large for int32 table offsets: the flat "
            f"table needs {total_cells} cells "
            f"(> {np.iinfo(np.int32).max}); reduce domain size, "
            "arity, or constraint count — or split the problem"
        )

    # flat form (constraint-major): offsets/scopes/strides per run
    offsets = np.zeros(n_cons, dtype=np.int32)
    con_scopes = np.zeros((n_cons, k_max), dtype=np.int32)
    con_strides = np.zeros((n_cons, k_max), dtype=np.int32)
    total = 0
    ci = 0
    run_con_base = []
    for k, sc, tb, _ in runs:
        m = sc.shape[0]
        size = d_max**k
        run_con_base.append(ci)
        if _is_shared(sc, tb):
            offsets[ci : ci + m] = total  # every constraint → one copy
            total += size
        else:
            offsets[ci : ci + m] = (
                total + np.arange(m, dtype=np.int64) * size
            )
            total += m * size
        strides = np.array(
            [d_max ** (k - 1 - q) for q in range(k)], dtype=np.int32
        )
        con_scopes[ci : ci + m, :k] = sc
        con_strides[ci : ci + m, :k] = strides
        ci += m
    tables_flat = (
        np.concatenate([tb.reshape(-1) for _, _, tb, _ in runs])
        if runs
        else np.zeros(1, dtype=np.float32)
    )
    if policy.enabled:
        # the flat pool's length in block multiples (no offset points
        # at the padding)
        tgt_cells = policy.bucket_cells(tables_flat.size)
        if tgt_cells > tables_flat.size:
            tables_flat = np.concatenate([
                tables_flat,
                np.zeros(tgt_cells - tables_flat.size, dtype=np.float32),
            ])

    # Edge ids are POSITION-MAJOR within each arity run: all position-0
    # edges of the run's constraints, then all position-1, …
    n_edges = sum(sc.shape[0] * k for k, sc, _, _ in runs)
    edge_var = np.zeros(max(n_edges, 1), dtype=np.int32)
    edge_con = np.zeros(max(n_edges, 1), dtype=np.int32)
    edge_offset = np.zeros(max(n_edges, 1), dtype=np.int32)
    edge_stride = np.zeros(max(n_edges, 1), dtype=np.int32)
    edge_covars = np.zeros((max(n_edges, 1), k_max - 1), dtype=np.int32)
    edge_costrides = np.zeros((max(n_edges, 1), k_max - 1), dtype=np.int32)
    edge_ghost = np.zeros(max(n_edges, 1), dtype=bool)
    run_edge_base = []
    edge_base = 0
    for ri, (k, sc, _, gtail) in enumerate(runs):
        m = sc.shape[0]
        i = run_con_base[ri]
        strides = np.array(
            [d_max ** (k - 1 - q) for q in range(k)], dtype=np.int32
        )
        run_edge_base.append(edge_base)
        for p in range(k):
            sl = slice(edge_base + p * m, edge_base + (p + 1) * m)
            edge_var[sl] = sc[:, p]
            edge_con[sl] = np.arange(i, i + m, dtype=np.int32)
            edge_offset[sl] = offsets[i : i + m]
            edge_stride[sl] = strides[p]
            other = [q for q in range(k) if q != p]
            edge_covars[sl, : k - 1] = sc[:, other]
            edge_costrides[sl, : k - 1] = strides[other]
            if gtail:
                edge_ghost[
                    edge_base + p * m + (m - gtail) : edge_base + (p + 1) * m
                ] = True
        edge_base += m * k

    # per-variable incoming edge lists (sentinel-padded with n_edges):
    # stable sort by owner variable; ghost edges stay out of them
    sel = np.arange(n_edges, dtype=np.int64)
    if policy.enabled and n_edges:
        sel = sel[~edge_ghost[:n_edges]]
    if sel.size:
        ev = edge_var[sel]
        counts = np.bincount(ev, minlength=n_vars)
        max_var_deg = max(int(counts.max(initial=0)), 1)
        var_edges = np.full((n_vars, max_var_deg), n_edges, dtype=np.int32)
        order = np.argsort(ev, kind="stable")
        ev_sorted = ev[order]
        starts = np.zeros(n_vars, dtype=np.int64)
        starts[1:] = np.cumsum(counts)[:-1]
        rank = np.arange(sel.size, dtype=np.int64) - starts[ev_sorted]
        var_edges[ev_sorted, rank] = sel[order].astype(np.int32)
    else:
        var_edges = np.full((n_vars, 1), n_edges, dtype=np.int32)
    # prefix invariant: the degree sort must reproduce the ACTUAL
    # per-variable edge counts (non-increasing over rows), or the
    # prefix gather would drop real edges
    _row_deg = (var_edges != n_edges).sum(axis=1)
    if not np.all(_row_deg[:-1] >= _row_deg[1:]):
        raise AssertionError(
            "variable degree sort does not match the edge counts"
        )
    var_slot_counts = tuple(
        int(x) for x in (var_edges != n_edges).sum(axis=0)
    )
    if policy.enabled:
        # quantized adjacency width and prefix counts: problems of one
        # bucket agree on them exactly (the extra prefix rows gather the
        # sentinel, a zero row)
        w = policy.bucket_dim(var_edges.shape[1])
        if w > var_edges.shape[1]:
            var_edges = np.concatenate([
                var_edges,
                np.full((n_vars, w - var_edges.shape[1]), n_edges,
                        dtype=np.int32),
            ], axis=1)
        var_slot_counts = var_slot_counts + (0,) * (w - len(var_slot_counts))
        var_slot_counts = tuple(
            0 if c == 0 else min(policy.bucket(c), n_vars)
            for c in var_slot_counts
        )

    # primal neighbors (padded): directed in-scope pairs, value-deduped
    pair_parts = []
    for k, sc, _, _ in runs:
        for a in range(k):
            for b in range(k):
                if a != b:
                    pair_parts.append(
                        np.stack([sc[:, a], sc[:, b]], axis=1)
                    )
    if pair_parts:
        pairs = np.concatenate(pair_parts)
        pairs = pairs[pairs[:, 0] != pairs[:, 1]]
        pairs = np.unique(pairs, axis=0)  # sorted (var, neighbor)
    else:
        pairs = np.zeros((0, 2), dtype=np.int32)
    ncounts = np.bincount(pairs[:, 0], minlength=n_vars)
    max_deg = max(int(ncounts.max(initial=0)), 1)
    if policy.enabled:
        max_deg = policy.bucket_dim(max_deg)
    neighbors = np.zeros((n_vars, max_deg), dtype=np.int32)
    neighbor_mask = np.zeros((n_vars, max_deg), dtype=bool)
    if len(pairs):
        nstarts = np.zeros(n_vars, dtype=np.int64)
        nstarts[1:] = np.cumsum(ncounts)[:-1]
        nrank = np.arange(len(pairs), dtype=np.int64) - nstarts[pairs[:, 0]]
        neighbors[pairs[:, 0], nrank] = pairs[:, 1]
        neighbor_mask[pairs[:, 0], nrank] = True

    # arity buckets: each arity's runs (one per shard segment) in run
    # order; edge slots are pure arithmetic on the run layout
    by_arity: Dict[int, List[int]] = {}
    for ri, (k, _, _, _) in enumerate(runs):
        by_arity.setdefault(k, []).append(ri)
    buckets: Dict[int, ArityBucket] = {}
    for k, run_ids in sorted(by_arity.items()):
        if len(run_ids) > 1 and any(
            _is_shared(runs[ri][1], runs[ri][2]) for ri in run_ids
        ):
            raise ValueError(
                "shared-table runs must be the only run of their arity "
                "(materialize before the shard-major layout)"
            )
        btables = np.concatenate(
            [runs[ri][2] for ri in run_ids]
        ).astype(np.float32, copy=False)
        bscopes = np.concatenate([runs[ri][1] for ri in run_ids])
        bslots = np.concatenate([
            run_edge_base[ri]
            + np.arange(runs[ri][1].shape[0], dtype=np.int32)[:, None]
            + np.arange(k, dtype=np.int32)[None, :] * runs[ri][1].shape[0]
            for ri in run_ids
        ])
        buckets[k] = ArityBucket(
            tables=_float_tensor(btables, dtype, device),
            tables_t=_float_tensor(
                np.moveaxis(btables, 0, -1), dtype, device
            ),
            scopes=torch.as_tensor(bscopes, device=device),
            edge_slot=torch.as_tensor(
                bslots.astype(np.int32), device=device
            ),
        )

    def _i(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=device)

    return dict(
        tables_flat=_float_tensor(tables_flat, dtype, device),
        con_offset=_i(offsets),
        con_scopes=_i(con_scopes),
        con_strides=_i(con_strides),
        edge_var=_i(edge_var),
        edge_con=_i(edge_con),
        edge_offset=_i(edge_offset),
        edge_stride=_i(edge_stride),
        edge_covars=_i(edge_covars),
        edge_costrides=_i(edge_costrides),
        neighbors=_i(neighbors),
        neighbor_mask=_i(neighbor_mask),
        var_edges=_i(var_edges),
        buckets=buckets,
        var_slot_counts=var_slot_counts,
    )


class AutoNames:
    """Compact, lazily-materialized name sequence for array-built
    problems: slot ``i`` is named ``f"{prefix}{ids[i]}"`` (``ids`` is
    the degree-sort permutation — original id order is what callers
    index by).  O(1) memory instead of a million-string tuple."""

    __slots__ = ("prefix", "ids", "_inv", "_hash")

    def __init__(self, prefix: str, ids: np.ndarray):
        self.prefix = prefix
        self.ids = np.asarray(ids)
        inv = np.empty(len(self.ids), dtype=np.int64)
        inv[self.ids] = np.arange(len(self.ids))
        self._inv = inv
        self._hash = hash((prefix, len(self.ids), self.ids.tobytes()))

    def __len__(self) -> int:
        return len(self.ids)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return tuple(
                f"{self.prefix}{int(j)}" for j in self.ids[i]
            )
        return f"{self.prefix}{int(self.ids[i])}"

    def __iter__(self):
        return (f"{self.prefix}{int(j)}" for j in self.ids)

    def __contains__(self, name) -> bool:
        try:
            self.index(name)
            return True
        except ValueError:
            return False

    def index(self, name: str) -> int:
        if not isinstance(name, str) or not name.startswith(self.prefix):
            raise ValueError(f"{name!r} is not in names")
        suffix = name[len(self.prefix):]
        # strict digits only: int() alone would accept 'v 1', 'v+1',
        # 'v1_0' and silently resolve a typo to the WRONG variable
        if not suffix.isdigit() or str(int(suffix)) != suffix:
            raise ValueError(f"{name!r} is not in names")
        j = int(suffix)
        if not 0 <= j < len(self.ids):
            raise ValueError(f"{name!r} is not in names")
        return int(self._inv[j])

    def __eq__(self, other) -> bool:
        if isinstance(other, AutoNames):
            return (
                self.prefix == other.prefix
                and np.array_equal(self.ids, other.ids)
            )
        if isinstance(other, tuple):
            return len(other) == len(self) and tuple(self) == other
        return NotImplemented

    def __hash__(self) -> int:
        return self._hash

    def __repr__(self) -> str:
        import hashlib

        digest = hashlib.sha256(self.ids.tobytes()).hexdigest()[:12]
        return (
            f"AutoNames({self.prefix!r}, n={len(self.ids)}, ids={digest})"
        )


class UniformLabels:
    """All ``n`` variables share one label tuple — O(1) stand-in for
    ``domain_labels`` on uniform-domain array-built problems."""

    __slots__ = ("labels", "n")

    def __init__(self, labels: Tuple[Any, ...], n: int):
        self.labels = tuple(labels)
        self.n = n

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i):
        if isinstance(i, slice):
            return tuple([self.labels] * len(range(*i.indices(self.n))))
        if not -self.n <= i < self.n:
            raise IndexError(i)
        return self.labels

    def __iter__(self):
        return iter([self.labels] * self.n)

    def __eq__(self, other) -> bool:
        if isinstance(other, UniformLabels):
            return self.labels == other.labels and self.n == other.n
        if isinstance(other, tuple):
            return len(other) == self.n and all(
                t == self.labels for t in other
            )
        return NotImplemented

    def __hash__(self) -> int:
        return hash((self.labels, self.n))

    def __repr__(self) -> str:
        return f"UniformLabels({self.labels!r} x {self.n})"


def compile_from_arrays(
    scopes,
    tables,
    n_values: int,
    *,
    n_vars: Optional[int] = None,
    unary: Optional[np.ndarray] = None,
    init_idx: Optional[np.ndarray] = None,
    domain_values: Optional[Sequence[Any]] = None,
    maximize: bool = False,
    n_shards: int = 1,
    var_prefix: str = "v",
    con_prefix: str = "c",
    dtype: torch.dtype = torch.float32,
    pad_policy="none",
    table_dtype=None,
    table_format=None,
    device: DeviceLike = None,
) -> CompiledProblem:
    """Array-level problem construction — the fast path for big
    generated instances (same contract as the JAX package's
    ``compile_from_arrays``).

    ``scopes`` is ``i32[m, k]`` (or a list of such arrays for mixed
    arities); ``tables`` matches it with ``f32[(d,)*k]`` (one table
    SHARED by all m constraints) or ``f32[m, (d,)*k]``.  ``unary`` and
    ``init_idx`` are in ORIGINAL variable-id order; variable ``i`` is
    named ``f"{var_prefix}{i}"``.  An enabled ``pad_policy`` appends
    ghost variables (the tail of the slot order) and zero-table ghost
    constraints; a shared-table group that needs ghosts is materialized
    per constraint (a group already on a bucket boundary keeps its one
    table), as in the JAX package.
    """
    pol = _check_supported(n_shards, pad_policy, table_format)
    dev = resolve_device(device)
    dtype = _resolve_table_dtype(table_dtype, dtype)
    if not isinstance(scopes, (list, tuple)):
        scopes = [scopes]
        tables = [tables]
    if len(scopes) != len(tables):
        raise ValueError("scopes and tables lists must match")
    scopes = [np.ascontiguousarray(s, dtype=np.int32) for s in scopes]
    if any(s.ndim != 2 for s in scopes):
        raise ValueError("each scopes entry must be [m, k]")
    for s in scopes:
        if s.shape[1] > MAX_ARITY:
            raise ValueError(
                f"arity {s.shape[1]} > MAX_ARITY={MAX_ARITY}"
            )
    d = int(n_values)
    max_id = max((int(s.max()) for s in scopes if s.size), default=-1)
    min_id = min((int(s.min()) for s in scopes if s.size), default=0)
    if min_id < 0:
        raise ValueError(
            f"scope references negative variable id {min_id}"
        )
    if n_vars is None:
        n_vars = max_id + 1
    elif max_id >= n_vars:
        raise ValueError(
            f"scope references variable {max_id} >= n_vars={n_vars}"
        )
    if domain_values is not None and len(domain_values) != d:
        raise ValueError(
            f"domain_values has {len(domain_values)} labels, "
            f"n_values={d}"
        )
    sign = -1.0 if maximize else 1.0

    n_real_vars = n_vars
    n_pad_vars = pol.bucket(n_vars) - n_vars if pol.enabled else 0
    n_vars += n_pad_vars

    # shared ``f32[(d,)*k]`` stays ONE copy (leading dim 1);
    # per-constraint tables keep ``f32[m, (d,)*k]``
    norm_tables: List[np.ndarray] = []
    for s, t in zip(scopes, tables):
        m, k = s.shape
        t = np.asarray(t, dtype=np.float32) * sign
        if t.shape == (d,) * k:
            t = t[None]
        elif t.shape != (m,) + (d,) * k:
            raise ValueError(
                f"table shape {t.shape} matches neither {(d,) * k} "
                f"nor {(m,) + (d,) * k}"
            )
        norm_tables.append(t)

    # degree-descending relabel: slot order is internal; names carry
    # original ids
    deg = np.zeros(n_vars, dtype=np.int64)
    for s in scopes:
        if s.shape[1] >= 2 and s.size:
            np.add.at(deg, s.reshape(-1), 1)
    perm = np.argsort(-deg, kind="stable")  # slot -> original id
    inv = np.empty(n_vars, dtype=np.int64)
    inv[perm] = np.arange(n_vars)
    scopes = [inv[s].astype(np.int32) for s in scopes]

    n_real_edges = sum(s.shape[0] * s.shape[1] for s in scopes)

    # one run per arity: same-arity entries MUST merge — the factor
    # phase reads each bucket position's q as one contiguous slice
    by_k: Dict[int, Tuple[List[np.ndarray], List[np.ndarray]]] = {}
    for s, t in zip(scopes, norm_tables):
        by_k.setdefault(s.shape[1], ([], []))
        by_k[s.shape[1]][0].append(s)
        by_k[s.shape[1]][1].append(t)

    def _merge_arity(ss, ts):
        """One (scopes, tables) per arity.  Sharedness survives only
        when the whole group is one shared entry on a single shard that
        needs no ghost rows; other groups (and the shard-major layout,
        whose ghosts have zero tables) materialize per-constraint
        tables."""
        sc = np.concatenate(ss) if len(ss) > 1 else ss[0]
        if (
            len(ts) == 1
            and ts[0].shape[0] == 1
            and sc.shape[0] > 1
            and n_shards == 1
            and pol.bucket(sc.shape[0]) == sc.shape[0]
        ):
            return sc, ts[0]
        mats = [
            np.broadcast_to(t, (s.shape[0],) + t.shape[1:])
            if t.shape[0] != s.shape[0]
            else t
            for s, t in zip(ss, ts)
        ]
        return sc, np.ascontiguousarray(np.concatenate(mats))

    # ghost constraints scope the ghost variable slots (the tail of the
    # slot order: ghosts have degree 0), with zero tables
    ghost_slots = list(range(n_real_vars, n_vars))
    runs: List[Tuple[int, np.ndarray, np.ndarray, int]] = []
    con_id_parts: List[np.ndarray] = []
    cid_base = 0
    if n_shards == 1:
        for k, (ss, ts) in sorted(by_k.items()):
            sc, tb = _merge_arity(ss, ts)
            gtail = pol.bucket(sc.shape[0]) - sc.shape[0] if pol.enabled else 0
            if gtail:
                sc = np.concatenate([sc, ghost_scopes(ghost_slots, gtail, k)])
                tb = np.concatenate(
                    [tb, np.zeros((gtail,) + (d,) * k, dtype=np.float32)]
                )
            runs.append((k, sc, tb, gtail))
            con_id_parts.append(
                np.arange(cid_base, cid_base + sc.shape[0], dtype=np.int64)
            )
            cid_base += sc.shape[0]
    else:
        # the shard-major layout: each arity padded to per_shard ·
        # n_shards with zero-table ghosts (on the pad-policy ghost slots,
        # else variable 0), dealt round-robin (row r to shard r mod
        # n_shards); the ghosts sit at the tail of every shard's run
        per_shard_parts: List[list] = [[] for _ in range(n_shards)]
        for k, (ss, ts) in sorted(by_k.items()):
            sc, tb = _merge_arity(ss, ts)
            m = sc.shape[0]
            per_shard = -(-m // n_shards)
            if pol.enabled:
                per_shard = pol.bucket(per_shard)
            tgt = per_shard * n_shards
            if tgt > m:
                gs = (
                    ghost_scopes(ghost_slots, tgt - m, k)
                    if pol.enabled
                    else np.zeros((tgt - m, k), dtype=np.int32)
                )
                sc = np.concatenate([sc, gs])
                tb = np.concatenate(
                    [tb, np.zeros((tgt - m,) + (d,) * k, dtype=np.float32)]
                )
            ids = np.arange(cid_base, cid_base + tgt, dtype=np.int64)
            cid_base += tgt
            ghost = np.arange(tgt) >= m
            for sh in range(n_shards):
                per_shard_parts[sh].append((
                    k, sc[sh::n_shards], tb[sh::n_shards],
                    int(ghost[sh::n_shards].sum()), ids[sh::n_shards],
                ))
        for parts in per_shard_parts:
            for k, sc, tb, gcount, ids in parts:
                runs.append((k, sc, tb, gcount))
                con_id_parts.append(ids)
    packed = _pack_runs(runs, n_vars, d, dtype, dev, pol)

    if unary is None:
        unary_np = np.zeros((n_real_vars, d), dtype=np.float32)
    else:
        unary_np = np.asarray(unary, dtype=np.float32) * sign
        if unary_np.shape != (n_real_vars, d):
            raise ValueError(
                f"unary shape {unary_np.shape} != {(n_real_vars, d)}"
            )
    if n_pad_vars:
        unary_np = np.concatenate([unary_np, ghost_unary(n_pad_vars, d)])
    unary_np = unary_np[perm]
    if init_idx is None:
        init_np = np.zeros(n_vars, dtype=np.int32)
    else:
        init_np = np.asarray(init_idx, dtype=np.int32)
        if n_pad_vars:
            init_np = np.concatenate(
                [init_np, np.zeros(n_pad_vars, dtype=np.int32)]
            )
        init_np = init_np[perm]
    domain_sizes = np.full(n_vars, d, dtype=np.int32)
    domain_sizes[n_real_vars:] = 1  # ghost slots: the tail

    labels = tuple(
        domain_values if domain_values is not None else range(d)
    )
    con_ids = (
        np.concatenate(con_id_parts)
        if con_id_parts
        else np.zeros(0, dtype=np.int64)
    )
    return CompiledProblem(
        domain_sizes=torch.as_tensor(domain_sizes, device=dev),
        unary=_float_tensor(unary_np, dtype, dev),
        init_idx=torch.as_tensor(init_np, device=dev),
        var_names=AutoNames(var_prefix, perm),
        domain_labels=UniformLabels(labels, n_vars),
        con_names=AutoNames(con_prefix, con_ids),
        maximize=maximize,
        n_shards=n_shards,
        n_real_edges=n_real_edges,
        n_pad_vars=n_pad_vars,
        **packed,
    )


def _tabulate_padded(c: RelationProtocol, d_max: int) -> np.ndarray:
    """Dense table of a constraint over the padded domain grid (cells
    involving padded values are 0 — unreachable behind BIG unary)."""
    m = c.as_matrix()
    k = m.arity
    padded = np.zeros((d_max,) * k, dtype=np.float32)
    padded[tuple(slice(0, s) for s in m.shape)] = m.matrix
    return padded


def encode_assignment(
    problem: CompiledProblem, assignment: Mapping[str, Any]
) -> torch.Tensor:
    """Assignment dict → i32[n_vars] of domain indices on the
    problem's device."""
    idx = np.zeros(problem.n_vars, dtype=np.int32)
    for i, name in enumerate(problem.var_names[: problem.n_real_vars]):
        labels = problem.domain_labels[i]
        val = assignment[name]
        try:
            idx[i] = labels.index(val)
        except ValueError:
            # tolerate str-typed values (e.g. parsed CLI input)
            idx[i] = [str(l) for l in labels].index(str(val))
    return torch.as_tensor(idx, device=problem.device)


def decode_assignment(
    problem: CompiledProblem, values
) -> Dict[str, Any]:
    """i32[n_vars] of domain indices (tensor or array) → assignment
    dict."""
    if isinstance(values, torch.Tensor):
        values = values.cpu().numpy()
    vals = np.asarray(values)
    return {
        name: problem.domain_labels[i][int(vals[i])]
        for i, name in enumerate(
            problem.var_names[: problem.n_real_vars]
        )
    }


def problem_fingerprint(problem: CompiledProblem) -> str:
    """Stable hash of the problem *instance* (names, domains, scopes and
    cost tables), the JAX package's: a checkpoint written for a
    structurally identical problem with other costs is rejected.  It
    hashes host bytes (bf16 tables as their raw 2-byte words), so the
    same problem gives the same fingerprint on every device and in both
    packages."""
    import hashlib

    def raw(t: torch.Tensor) -> bytes:
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().tobytes()

    h = hashlib.sha256()
    h.update(repr(problem.var_names).encode())
    h.update(repr(problem.domain_labels).encode())
    h.update(repr(problem.con_names).encode())
    h.update(raw(problem.con_scopes))
    h.update(raw(problem.unary))
    h.update(raw(problem.tables_flat))
    return h.hexdigest()[:16]


# -- several instances: grouping, stacking, the disjoint union ------------


def canonical_execution_problem(problem: CompiledProblem) -> CompiledProblem:
    """A copy of ``problem`` whose host-only metadata (names, labels,
    accounting counts) is replaced by shape-derived placeholders, as the
    JAX package's ``canonical_execution_problem`` does: two problems that
    agree on shapes, dtypes and the round loop's statics
    (``var_slot_counts``, ``maximize``, bucket arities) then have equal
    canonical forms.  Tensor leaves are shared, not copied."""
    n = problem.n_vars
    return dataclasses.replace(
        problem,
        var_names=("__anon_vars__", n),
        domain_labels=("__anon_labels__", n, problem.d_max),
        con_names=("__anon_cons__", problem.n_cons),
        n_real_edges=problem.n_edges,
        n_pad_vars=0,
    )


def _leaves(problem: CompiledProblem) -> List[Tuple[str, torch.Tensor]]:
    """Every tensor leaf with its name, buckets in arity order."""
    out = [(f, getattr(problem, f)) for f in ARRAY_FIELDS]
    for k, b in sorted(problem.buckets.items()):
        out += [
            (f"buckets.{k}.{f.name}", getattr(b, f.name))
            for f in dataclasses.fields(b)
        ]
    return out


def problem_group_key(problem: CompiledProblem):
    """Hashable batching key: equal keys mean equal leaf shapes and
    dtypes and equal statics (``maximize``, ``n_shards``,
    ``var_slot_counts``, bucket arities), so the problems stack into one
    :class:`StackedProblem` (the grouping predicate of
    :func:`stack_problems`, as in the JAX package).  Names never split a
    group; a ``pad_policy`` steers similarly-sized problems onto one
    key."""
    return (
        problem.maximize,
        problem.n_shards,
        tuple(problem.var_slot_counts),
        tuple(sorted(problem.buckets)),
        tuple(
            (name, tuple(t.shape), str(t.dtype), t.device.type)
            for name, t in _leaves(problem)
        ),
    )


@dataclasses.dataclass
class StackedProblem:
    """I same-key problems stacked along a leading instance axis.

    ``problem`` is a :class:`CompiledProblem` whose tensor leaves carry
    the extra leading ``[I, ...]`` axis and whose metadata is the shared
    canonical form: it is not a valid single-instance problem (its
    ``n_vars`` would read the instance count).  ``template`` is the
    canonical single-instance member, ``host_problems`` the original
    (named) problems in stack order, for decoding and message
    accounting, and ``indices`` maps stack position to input position.

    The message-passing algorithms run on the stacked form directly
    (state ``[I, R, d, E]``); the properties below give them the
    template's sizes and the stacked tensors in the shapes they read.
    The local search runs on :func:`union_problem` instead.
    """

    problem: CompiledProblem  # stacked leaves [I, ...]
    template: CompiledProblem  # canonical single-instance member
    host_problems: List[CompiledProblem]  # originals, stack order
    indices: List[int]  # stack position -> input position

    @property
    def n_instances(self) -> int:
        return len(self.host_problems)

    n_vars = property(lambda self: self.template.n_vars)
    n_edges = property(lambda self: self.template.n_edges)
    n_cons = property(lambda self: self.template.n_cons)
    d_max = property(lambda self: self.template.d_max)
    n_shards = property(lambda self: self.template.n_shards)
    device = property(lambda self: self.template.device)
    maximize = property(lambda self: self.template.maximize)
    var_slot_counts = property(lambda self: self.template.var_slot_counts)
    buckets = property(lambda self: self.problem.buckets)  # stacked
    edge_var = property(lambda self: self.problem.edge_var)  # [I, E]

    @functools.cached_property
    def unary_t(self) -> torch.Tensor:
        """``[I, 1, d, n]``: each instance's ``unary_t``, with a restart
        axis to broadcast over."""
        return self.problem.unary.transpose(1, 2).contiguous()[:, None]

    @functools.cached_property
    def var_edges_t(self) -> torch.Tensor:
        """``[I, max_var_deg, n]`` int64: each instance's degree-slot
        rows (the batched belief gather's index)."""
        return self.problem.var_edges.transpose(1, 2).contiguous().long()

    @functools.cached_property
    def slot_sentinels(self) -> bool:
        return any(p.slot_sentinels for p in self.host_problems)

    @functools.cached_property
    def segments(self) -> Tuple["StackedProblem", ...]:
        """The ``n_shards`` shard views of the group on its device: each
        instance's :func:`shard_view`, stacked (slot tables of one width
        for all instances)."""
        return shard_stacked(self, [self.device] * self.n_shards)


def stack_problems(
    problems: Sequence[CompiledProblem],
) -> List[StackedProblem]:
    """Group problems by :func:`problem_group_key` (in order of first
    appearance) and stack each group's tensor leaves along a new leading
    instance axis (a group of one still stacks, with ``I = 1``)."""
    groups: Dict[Any, List[int]] = {}
    for i, p in enumerate(problems):
        groups.setdefault(problem_group_key(p), []).append(i)
    out: List[StackedProblem] = []
    for idxs in groups.values():
        canon = [canonical_execution_problem(problems[i]) for i in idxs]
        first = canon[0]
        stacked = {
            f: torch.stack([getattr(c, f) for c in canon])
            for f in ARRAY_FIELDS
        }
        stacked["buckets"] = {
            k: ArityBucket(*(
                torch.stack([getattr(c.buckets[k], f.name) for c in canon])
                for f in dataclasses.fields(b)
            ))
            for k, b in first.buckets.items()
        }
        out.append(StackedProblem(
            problem=dataclasses.replace(first, **stacked),
            template=first,
            host_problems=[problems[i] for i in idxs],
            indices=list(idxs),
        ))
    return out


def union_problem(stacked: StackedProblem) -> CompiledProblem:
    """The I stacked instances as ONE problem, their disjoint union,
    interleaved: local variable, constraint or edge ``x`` of instance
    ``i`` becomes ``x·I + i``; each instance's flat tables follow the
    previous instance's.  The order within every instance is kept, so
    the union keeps each instance's arity buckets position-major, its
    degree-sorted prefixes (``var_slot_counts`` times I) and its
    neighbor order, and a deterministic algorithm computes on each
    instance exactly what it computes on the instance alone.  This is
    the local search's lowering of the instance axis
    (``engine/batched.py:run_many_batched``)."""
    sp = stacked.problem
    I = stacked.n_instances
    n, E, T = stacked.n_vars, stacked.n_edges, sp.tables_flat.shape[1]
    if I * T > np.iinfo(np.int32).max:
        raise ValueError(
            f"{I} instances of {T} table cells overflow the int32 "
            "offsets of one union problem — solve fewer at once"
        )

    def inst(x: torch.Tensor) -> torch.Tensor:  # i, shaped to x's rank
        return torch.arange(I, dtype=x.dtype, device=x.device).view(
            (I,) + (1,) * (x.dim() - 1)
        )

    def weave(x: torch.Tensor) -> torch.Tensor:  # [I, L, ...] -> [L*I, ...]
        return x.transpose(0, 1).reshape((-1,) + tuple(x.shape[2:]))

    def ids(x: torch.Tensor) -> torch.Tensor:  # local ids -> union ids
        return weave(x * I + inst(x))

    def cells(x: torch.Tensor) -> torch.Tensor:  # flat-table offsets
        return weave(x + inst(x) * T)

    ve = sp.var_edges
    var_edges = weave(torch.where(ve == E, E * I, ve * I + inst(ve)))
    buckets = {}
    for k, b in sp.buckets.items():
        m = b.scopes.shape[1]
        tables = b.tables.expand((I, m) + tuple(b.tables.shape[2:]))
        tables = weave(tables)
        buckets[k] = ArityBucket(
            tables=tables,
            tables_t=tables.movedim(0, -1).contiguous(),
            scopes=ids(b.scopes),
            edge_slot=ids(b.edge_slot),
        )
    return CompiledProblem(
        domain_sizes=weave(sp.domain_sizes),
        unary=weave(sp.unary),
        init_idx=weave(sp.init_idx),
        tables_flat=sp.tables_flat.reshape(-1),
        con_offset=cells(sp.con_offset),
        con_scopes=ids(sp.con_scopes),
        con_strides=weave(sp.con_strides),
        edge_var=ids(sp.edge_var),
        edge_con=ids(sp.edge_con),
        edge_offset=cells(sp.edge_offset),
        edge_stride=weave(sp.edge_stride),
        edge_covars=ids(sp.edge_covars),
        edge_costrides=weave(sp.edge_costrides),
        neighbors=ids(sp.neighbors),
        neighbor_mask=weave(sp.neighbor_mask),
        var_edges=var_edges,
        buckets=buckets,
        var_names=("__union_vars__", n * I),
        domain_labels=("__union_labels__", n * I, stacked.d_max),
        con_names=("__union_cons__", stacked.n_cons * I),
        maximize=stacked.maximize,
        n_shards=stacked.n_shards,
        n_real_edges=sum(p.n_real_edges for p in stacked.host_problems),
        var_slot_counts=tuple(c * I for c in stacked.var_slot_counts),
        n_pad_vars=0,
    )


# -- shard views ----------------------------------------------------------


def slot_tables(
    problems: Sequence[CompiledProblem],
) -> List[Tuple[List[np.ndarray], Tuple[int, ...]]]:
    """Per shard segment s of same-layout ``n_shards > 1`` problems:
    ``(tables, counts)``, each problem's slot table over the segment's
    LOCAL edges and the degree-slot prefix counts they share.

    ``var_edges`` holds global edge ids, which mean nothing inside one
    shard.  Segment s's table keeps, per variable and in ``var_edges``'
    order, the edges of ``[s·E_s, (s+1)·E_s)`` as local ids, padded
    with the sentinel ``E_s``.  Local degrees do not follow the global
    degree order, so slot p's count is one past the last variable with
    a p-th local edge (the sentinels inside that prefix read a zero
    row); several problems share the widest table and the largest
    counts, so that their views stack."""
    S = problems[0].n_shards
    E_s = problems[0].n_edges // S
    out = []
    ves = [p.var_edges.cpu().numpy().astype(np.int64) for p in problems]
    for s in range(S):
        tables, widths, counts = [], [], []
        for ve, p in zip(ves, problems):
            n = ve.shape[0]
            mask = (ve >= s * E_s) & (ve < (s + 1) * E_s)
            deg = mask.sum(axis=1)
            w = max(int(deg.max(initial=0)), 1)
            table = np.full((n, w), E_s, dtype=np.int32)
            rows, cols = np.nonzero(mask)
            rank = np.cumsum(mask, axis=1)[rows, cols] - 1
            table[rows, rank] = ve[rows, cols] - s * E_s
            tables.append(table)
            widths.append(w)
            counts.append([
                int(np.nonzero(deg > q)[0].max(initial=-1)) + 1
                for q in range(w)
            ])
        w = max(widths)
        tables = [
            np.pad(t, ((0, 0), (0, w - t.shape[1])), constant_values=E_s)
            for t in tables
        ]
        shared = tuple(
            max((c[q] if q < len(c) else 0) for c in counts)
            for q in range(w)
        )
        out.append((tables, shared))
    return out


def shard_view(
    problem: CompiledProblem,
    index: int,
    device: DeviceLike = None,
    slots: Optional[Tuple[List[np.ndarray], Tuple[int, ...]]] = None,
    member: int = 0,
) -> CompiledProblem:
    """Shard ``index``'s view of an ``n_shards > 1`` problem on
    ``device`` (default: the problem's): its blocks of the constraint,
    edge and bucket arrays (``tables_t`` splits on its last axis), the
    per-variable arrays and ``tables_flat`` whole, and its own slot
    table over its local edges as ``var_edges`` (``slots``: one entry of
    :func:`slot_tables`, whose ``member``-th table is this problem's).
    On the problem's own device the blocks are views, not copies.  The
    edge and constraint ids inside (``edge_con``, ``edge_slot``) stay
    global, as in a ``shard_map`` block of the JAX package."""
    S = problem.n_shards
    if S < 2 or not 0 <= index < S:
        raise ValueError(
            f"shard {index} of a problem compiled for {S} shard(s)"
        )
    dev = torch.device(device) if device is not None else problem.device
    if slots is None:
        slots = slot_tables([problem])[index]
    table, counts = slots[0][member], slots[1]

    def part(x, dim):
        if dim is None:
            return x.to(dev)
        size = x.shape[dim] // S
        return x.narrow(dim, index * size, size).contiguous().to(dev)

    fields = {f: part(getattr(problem, f), SHARD_AXES[f])
              for f in ARRAY_FIELDS}
    fields["var_edges"] = torch.as_tensor(table, device=dev)
    buckets = {
        k: ArityBucket(**{f: part(getattr(b, f), dim)
                          for f, dim in BUCKET_SHARD_AXES.items()})
        for k, b in problem.buckets.items()
    }
    return dataclasses.replace(
        problem, buckets=buckets, var_slot_counts=counts, **fields
    )


def shard_stacked(
    stacked: StackedProblem, devices: Sequence[torch.device],
    shards: Optional[Sequence[int]] = None,
) -> Tuple[StackedProblem, ...]:
    """A stacked group of ``n_shards > 1`` problems as one stacked view
    per shard, shard s on ``devices[s]``: the instances'
    :func:`shard_view` over slot tables of one width, stacked again.
    ``shards`` names the shards to build, one a device (default: all,
    in order)."""
    hosts = stacked.host_problems
    tables = slot_tables(hosts)
    views = []
    if shards is None:
        shards = range(len(devices))
    for s, dev in zip(shards, devices):
        members = [
            shard_view(hp, s, dev, slots=tables[s], member=i)
            for i, hp in enumerate(hosts)
        ]
        view = stack_problems(members)
        if len(view) != 1:
            raise AssertionError("a stacked group's shard views split")
        views.append(dataclasses.replace(view[0], indices=stacked.indices))
    return tuple(views)
