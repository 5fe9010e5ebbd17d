"""Memory-bounded contraction: cut-set planning + budgeted sweeps so
exact solves and inference survive induced widths past device memory
(a port of ``pydcop_tpu/ops/membound.py``).

The level-synchronous sweeps (DPOP's UTIL phase, the semiring
contraction engine) die the moment ONE joined UTIL/message table
exceeds device memory — table size is exponential in induced width,
so a single wide separator kills the whole call however small the
rest of the tree is.  This module bounds that largest table to a
``max_util_bytes`` budget the MB-DPOP way (RMB-DPOP,
arXiv:2002.10641): walk the bucket-tree plan
(``ops/semiring.py:build_plan``), and for every contraction whose
projected table would exceed the budget choose a minimal CUT SET of
separator variables to condition on — preferring variables shared
across many oversized nodes, so one enumeration is reused by every
sibling that needs it (the redundancy elimination that distinguishes
RMB from plain MB).  Each joint assignment of the cut set is one
LANE: a conditioned copy of the plan whose cut domains are singletons
(axes kept, length 1), so every lane has IDENTICAL table shapes and
the lanes ride the level-pack stack machinery (``contract_sweep``) as
extra rows of the stacked leading axis — same bucketing, zero new
kernel shapes beyond the conditioned axes.

Before planning, a CROSS-EDGE CONSISTENCY pass (after arXiv:
1909.06537) shrinks domains: a value whose every completion under
some constraint is hard-infeasible (``+inf`` energy) can never appear
in an optimum and carries ``exp(-inf) = 0`` weight, so pruning it is
exact for EVERY registered ⊕ — and smaller domains mean budgets are
met with fewer cut variables (``membound.pruned_cells``).

Per-⊕ exactness contracts carry over unchanged: each lane is a
normal sweep, so idempotent ⊕ keeps the f32 arg certificate + exact
host-f64 values PER LANE and the ⊕-combine across lanes (min/max of
exact scalars) is exact; logsumexp ⊕ carries its accumulated error
bound per lane and the cross-lane combine bounds the result by the
WORST lane bound plus the f64 combine rounding (multiplicative
errors: ``Σ ẑ_l ∈ Σ z_l · [e^-max(e_l), e^max(e_l)]``).

OOM ladder position: a budgeted sweep turns a device out-of-memory
error (the supervisor's ``DeviceOOMError``, raised for a real
``torch.cuda.OutOfMemoryError`` or an injected ``device_oom``) into a
REPLAN instead of a host retreat.  Level-stack OOM still degrades to per-node dispatches; a
per-node OOM then re-plans the whole sweep at HALF the budget
(``membound.replans`` — deterministic: the plan is a pure function of
(graph, budget)), and only when the budget bottoms out does the sweep
abandon the device for bounded host f64.

Budget semantics: ``max_util_bytes`` bounds the f32 bytes
(``BYTES_PER_CELL`` = 4) of each individual joined UTIL/message
table.  Stack height (lanes × level rows) multiplies a dispatch
LINEARLY and is handled by the existing level→node ladder; the
budget caps the per-table term that is EXPONENTIAL in width — the
one no ladder can save.

The planner is host numpy; the sweeps it drives run their device
contractions on the torch device they are given.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from pydcop_tpu_torch.engine.supervisor import DeviceOOMError
from pydcop_tpu_torch.ops.padding import (
    NO_PADDING,
    as_table_dtype,
    bucket_util_shape,
    table_dtype_bytes,
)
from pydcop_tpu_torch.ops.semiring import (
    ContractionPlan,
    Semiring,
    _np_logsumexp,
    contract_sweep,
)
from pydcop_tpu_torch.ops.sparse import (
    SPARSE_INDEX_BYTES,
    SPARSE_MAX_DENSITY,
    SPARSE_MIN_CELLS,
    as_table_format,
)

_EPS64 = float(np.finfo(np.float64).eps)

#: device tables default to f32 — the byte unit ``max_util_bytes``
#: caps.  Sub-f32 table packs (``table_dtype=bf16|int8``) shrink the
#: per-cell width through :func:`~pydcop_tpu_torch.ops.padding.
#: table_dtype_bytes`, so the SAME budget fits wider tables — bf16
#: halves the cut width pressure, int8 quarters it.
BYTES_PER_CELL = 4

#: enumeration guard: a cut whose joint assignment space exceeds this
#: many lanes is declared unplannable (the sizing error names it).
MAX_CUT_LANES = 4096


class MemboundError(ValueError):
    """Memory-bounded planning failed: no cut set within the lane
    budget brings the peak table under ``max_util_bytes``.  The
    message reports the ACTIONABLE sizing — planned peak table bytes
    vs the budget and the cut width reached — instead of a retry
    hint."""

    def __init__(
        self,
        *,
        naive_peak_bytes: int,
        reached_peak_bytes: int,
        max_util_bytes: int,
        cut_width: int,
        lanes: int,
        max_cut_lanes: int,
    ):
        self.naive_peak_bytes = naive_peak_bytes
        self.reached_peak_bytes = reached_peak_bytes
        self.max_util_bytes = max_util_bytes
        self.cut_width = cut_width
        self.lanes = lanes
        super().__init__(
            "memory-bounded planning failed: naive peak contraction "
            f"table is {naive_peak_bytes} bytes against "
            f"max_util_bytes={max_util_bytes}; a cut of width "
            f"{cut_width} reaches a {reached_peak_bytes}-byte peak "
            f"but needs {lanes} enumeration lanes "
            f"(> max_cut_lanes={max_cut_lanes}).  Raise "
            "max_util_bytes, raise max_cut_lanes, or reduce the "
            "instance's induced width (order='min_fill' narrows "
            "loopy graphs)."
        )


# -- cross-edge consistency (pre-plan domain pruning) --------------------


def prune_plan(plan: ContractionPlan):
    """Shrink the plan's domains by hard-constraint consistency, IN
    PLACE: a value of ``v`` is pruned when some single part forces
    every completion to ``+inf`` energy (generalized arc consistency
    over the part's scope, iterated to fixpoint so one variable's
    pruning propagates across shared — cross — edges).  Pruned values
    are optimal for no query: they never enter a finite optimum and
    weigh ``exp(-inf) = 0`` in any logsumexp, so every registered ⊕
    is exact on the pruned plan.  A domain is never emptied (a fully
    infeasible instance keeps its semantics: all-``-inf`` sweeps).

    Returns ``(pruned_cells, keep, orig_len)``: the number of table
    cells removed across the plan's buckets, the per-variable
    original-index arrays of the surviving values, and the original
    domain lengths (marginal results scatter back through these)."""
    domains = plan.domains
    orig_len = {v: len(domains[v]) for v in domains}
    parts = [
        (scope, table)
        for v in plan.order
        for (scope, table) in plan.buckets[v]
    ]
    inf_parts = [
        (scope, table)
        for scope, table in parts
        if np.isposinf(table).any()
    ]
    keep = {
        v: np.arange(orig_len[v], dtype=np.intp) for v in domains
    }
    if not inf_parts:
        return 0, keep, orig_len

    alive = {
        v: np.ones(orig_len[v], dtype=bool) for v in domains
    }
    changed = True
    while changed:
        changed = False
        for scope, table in inf_parts:
            masked = np.asarray(table, dtype=np.float64)
            for ax, u in enumerate(scope):
                a = alive[u]
                if not a.all():
                    shp = [1] * len(scope)
                    shp[ax] = a.size
                    masked = np.where(a.reshape(shp), masked, np.inf)
            for ax, u in enumerate(scope):
                other = tuple(
                    i for i in range(len(scope)) if i != ax
                )
                support = (
                    np.min(masked, axis=other) if other else masked
                )
                # ONLY +inf support is infeasible: a -inf support is
                # an infinitely GOOD completion (±inf is a legitimate
                # hard-constraint cost), and pruning
                # it would delete the optimum
                dead = alive[u] & np.isposinf(support)
                if dead.any() and (alive[u] & ~dead).any():
                    alive[u][dead] = False
                    changed = True

    if all(a.all() for a in alive.values()):
        return 0, keep, orig_len
    keep = {v: np.flatnonzero(alive[v]) for v in domains}
    pruned_cells = 0
    for v in plan.order:
        new_bucket = []
        for scope, table in plan.buckets[v]:
            before = table.size
            t = table
            for ax, u in enumerate(scope):
                if keep[u].size != orig_len[u]:
                    t = np.take(t, keep[u], axis=ax)
            pruned_cells += before - t.size
            new_bucket.append((scope, t))
        plan.buckets[v] = new_bucket
        if plan.wbuckets[v]:
            # weight (log-prob) parts ride the same domains — slice
            # them too or an expectation lane misaligns its axes
            new_w = []
            for scope, t in plan.wbuckets[v]:
                for ax, u in enumerate(scope):
                    if keep[u].size != orig_len[u]:
                        t = np.take(t, keep[u], axis=ax)
                new_w.append((scope, t))
            plan.wbuckets[v] = new_w
    for v in list(domains):
        if keep[v].size != orig_len[v]:
            domains[v] = [domains[v][i] for i in keep[v]]
    return pruned_cells, keep, orig_len


# -- the cut-set planner -------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CutPlan:
    """One instance's cut decision at one budget (a pure function of
    the plan's structure/domains and the budget — what makes OOM
    re-planning deterministic)."""

    cut: Tuple[str, ...]
    n_lanes: int
    budget_cells: int
    naive_peak_cells: int
    bounded_peak_cells: int
    #: bytes per SCALAR-WORLD cell = BYTES_PER_CELL × the semiring's
    #: cell width (a kbest:8 sweep moves 8 f32s per table cell — the
    #: budget model must see them or the sweep lands 8× over budget)
    cell_width: int = 1
    #: storage dtype of the device tables this cut was budgeted for —
    #: bf16 halves and int8 quarters the per-cell byte width, so the
    #: same ``max_util_bytes`` fits more cells (a smaller cut)
    table_dtype: str = "f32"
    #: table format the sweep will run at: ``"sparse"`` sizes
    #: hard-capped nodes at their estimated PACKED cells (feasible
    #: fraction × box, plus the per-candidate index overhead), so a
    #: 0.9-sparse table fits ~10× more scope under the same budget
    table_format: str = "dense"

    @property
    def width(self) -> int:
        return len(self.cut)

    @property
    def bytes_per_cell(self) -> int:
        return table_dtype_bytes(self.table_dtype) * max(
            int(self.cell_width), 1
        )


def plan_cut(
    plan: ContractionPlan,
    max_util_bytes: int,
    pad=None,
    max_cut_lanes: int = MAX_CUT_LANES,
    cell_width: int = 1,
    table_dtype: str = "f32",
    table_format: str = "dense",
) -> CutPlan:
    """Choose a minimal cut set keeping every contraction table of
    the plan under ``max_util_bytes``.

    Dims-only simulation (no tables): each node's target is its
    separator plus its own axis; conditioning a variable collapses
    its axis to 1 in EVERY table that carries it.  Sizes are taken
    on the level-pack lattice of the active ``pad`` policy
    (``ops/padding.py:bucket_util_shape`` — identity under
    ``NO_PADDING``, and conditioned size-1 axes always stay 1), so
    the budget caps what the device will actually ALLOCATE per lane,
    not the pre-padding cell count.  Greedy pick, from the remaining
    oversized nodes: the variable occurring in the most oversized
    targets — a variable shared across sibling subtrees bounds all
    of them with ONE enumeration (the RMB-DPOP reuse) — tie-broken
    root-most (latest elimination position: ancestors near the root
    sit in the most separators), then by name.  Deterministic: a
    pure function of (graph, domains, budget, pad).  Raises
    :class:`MemboundError` when no cut within ``max_cut_lanes``
    enumeration lanes meets the budget.

    ``cell_width`` is the semiring's structured-cell width
    (``ops/semiring.py``): every table cell is ``cell_width`` f32s on
    device, so the cell budget divides by it — a ``kbest:8`` sweep
    under ``max_util_bytes`` must not land 8× over budget unseen.

    ``table_dtype`` is the device storage dtype of the sweep's tables
    (``ops/padding.py:as_table_dtype``): the budget divides by the
    REAL per-cell byte width, so the same ``max_util_bytes`` fits 2×
    the cells at bf16 and 4× at int8 — a strictly smaller (or equal)
    cut than f32 for the same plan and budget.

    ``table_format="sparse"`` sizes each scalar-cell node at what the
    sparse sweep will actually allocate: the node's feasible fraction
    (min over its own tables of the non-``+inf`` share — the packed
    support can only be smaller) times the dense box, times the
    per-candidate overhead factor ``(value + index bytes) / value
    bytes``.  Nodes too dense or too small to pack keep their dense
    size, so the estimate is format-aware per node, not a blanket
    discount.  Conditioning keeps the unconditioned feasible
    fraction (the per-slice density varies around it) — the OOM
    replan ladder of :func:`run_bounded` absorbs underestimates."""
    pad = NO_PADDING if pad is None else pad
    table_dtype = as_table_dtype(table_dtype)
    table_format = as_table_format(table_format)
    # structured cells never pack (ops/semiring.py gates on scalar
    # kinds), so a kbest/expectation sweep sizes dense regardless
    sparse = table_format == "sparse" and int(cell_width) <= 1
    feas: Dict[str, float] = {}
    sp_factor = 1.0
    if sparse:
        vb = table_dtype_bytes(table_dtype)
        sp_factor = (vb + SPARSE_INDEX_BYTES) / vb
        for v in plan.order:
            f = 1.0
            for _dims, t in plan.buckets.get(v, ()):
                a = np.asarray(t)
                if a.size:
                    f = min(
                        f, 1.0 - float(np.isposinf(a).mean())
                    )
            feas[v] = f
    bytes_per_cell = table_dtype_bytes(table_dtype) * max(
        int(cell_width), 1
    )
    budget_cells = max(int(max_util_bytes) // bytes_per_cell, 1)
    seps: Dict[str, List[str]] = {}
    targets: Dict[str, List[str]] = {}
    for v in plan.order:
        seps[v] = plan.sep_of(v, seps)
        targets[v] = seps[v] + [v]
    dsize = {
        v: bucket_util_shape((len(plan.domains[v]),), pad)[0]
        for v in plan.domains
    }

    def sizes(cutset):
        out = []
        for v, tgt in targets.items():
            size = 1
            for d in tgt:
                size *= 1 if d in cutset else dsize[d]
            if sparse:
                f = feas.get(v, 1.0)
                est = size * f * sp_factor
                if (
                    f <= SPARSE_MAX_DENSITY
                    and size >= SPARSE_MIN_CELLS
                    and est < size
                ):
                    size = max(int(np.ceil(est)), 1)
            out.append((v, tgt, size))
        return out

    naive_peak = max((s for _, _, s in sizes(frozenset())), default=1)
    cut: List[str] = []
    cutset: set = set()
    lanes = 1
    while True:
        oversized = [
            (v, tgt, s)
            for v, tgt, s in sizes(cutset)
            if s > budget_cells
        ]
        if not oversized:
            break
        counts: Dict[str, int] = {}
        for _, tgt, _ in oversized:
            for d in tgt:
                if d not in cutset and dsize[d] > 1:
                    counts[d] = counts.get(d, 0) + 1
        # an oversized node (> budget_cells >= 1) always has an
        # unconditioned multi-value dim, so counts is never empty
        pick = min(
            counts,
            key=lambda d: (-counts[d], -plan.pos[d], d),
        )
        if lanes * dsize[pick] > max_cut_lanes:
            reached = max(
                (s for _, _, s in sizes(cutset)), default=1
            )
            raise MemboundError(
                naive_peak_bytes=naive_peak * bytes_per_cell,
                reached_peak_bytes=reached * bytes_per_cell,
                max_util_bytes=int(max_util_bytes),
                cut_width=len(cut),
                lanes=lanes * dsize[pick],
                max_cut_lanes=max_cut_lanes,
            )
        cut.append(pick)
        cutset.add(pick)
        lanes *= dsize[pick]
    bounded_peak = max((s for _, _, s in sizes(cutset)), default=1)
    return CutPlan(
        tuple(cut), lanes, budget_cells, naive_peak, bounded_peak,
        cell_width=max(int(cell_width), 1), table_dtype=table_dtype,
        table_format=table_format,
    )


def lane_plans(plan: ContractionPlan, cut: Sequence[str]):
    """Expand a plan into its cut-assignment lanes: one conditioned
    :class:`ContractionPlan` per joint assignment of ``cut``, cut
    domains shrunk to singletons with their table axes KEPT at
    length 1 — every lane has identical shapes, which is what lets
    lanes share level-pack buckets (and compiled kernels) with each
    other.  Returns ``(plans, combos)``; an empty cut returns the
    plan itself (no copies)."""
    if not cut:
        return [plan], [()]
    combos = list(
        itertools.product(
            *(range(len(plan.domains[c])) for c in cut)
        )
    )
    out = []
    for combo in combos:
        fixed = dict(zip(cut, combo))
        domains_l = dict(plan.domains)
        for c, i in fixed.items():
            domains_l[c] = [plan.domains[c][i]]

        def _slice(bucket):
            lane_parts = []
            for scope, table in bucket:
                t = table
                for d in scope:
                    if d in fixed:
                        t = np.take(
                            t, [fixed[d]], axis=scope.index(d)
                        )
                lane_parts.append((scope, t))
            return lane_parts

        buckets_l: Dict[str, list] = {}
        wbuckets_l: Dict[str, list] = {}
        for v in plan.order:
            buckets_l[v] = _slice(plan.buckets[v])
            wbuckets_l[v] = _slice(plan.wbuckets[v])
        out.append(
            ContractionPlan(
                domains_l, plan.order, buckets_l,
                plan.const_energy, plan.order_name,
                wbuckets=wbuckets_l,
                node_semiring=plan.node_semiring,
                max_vars=plan.max_vars,
            )
        )
    return out, combos


# -- the budgeted sweep driver -------------------------------------------


class BoundedSweep:
    """Result of one budgeted merged sweep over K instances' lanes.

    ``sw`` is the underlying :class:`~pydcop_tpu_torch.ops.semiring._Sweep`
    whose instance axis is the FLAT lane list; ``ranges[k]`` slices
    instance ``k``'s lanes out of it.  Combination helpers implement
    the per-⊕ cross-lane contracts (module docstring)."""

    __slots__ = (
        "sw", "plans", "cuts", "ranges", "lanes", "combos", "keep",
        "orig_len", "replans", "budget_bytes", "max_util_bytes",
        "pruned_cells", "on_device",
    )

    def __init__(
        self, sw, plans, cuts, ranges, lanes, combos, keep,
        orig_len, replans, budget_bytes, max_util_bytes,
        pruned_cells, on_device,
    ):
        self.sw = sw
        self.plans = plans
        self.cuts = cuts
        self.ranges = ranges
        self.lanes = lanes  # flat lane plans (sweep instance axis)
        self.combos = combos
        self.keep = keep
        self.orig_len = orig_len
        self.replans = replans
        self.budget_bytes = budget_bytes
        self.max_util_bytes = max_util_bytes
        self.pruned_cells = pruned_cells
        self.on_device = on_device

    # -- per-instance views ---------------------------------------------

    def lane_values(self, k: int) -> List[float]:
        """Raw per-lane aggregates (root total + applied shifts) —
        the caller folds ``const_energy``/``beta`` in."""
        lo, hi = self.ranges[k]
        return [
            self.sw.root_total[l] + self.sw.total_shift[l]
            for l in range(lo, hi)
        ]

    def lane_errs(self, k: int) -> List[float]:
        lo, hi = self.ranges[k]
        return [
            sum(
                self.sw.err[l].get(r, 0.0)
                for r in self.lanes[l].roots
            )
            for l in range(lo, hi)
        ]

    def best_lane(self, k: int, maximize: bool) -> int:
        """GLOBAL index of instance ``k``'s winning lane under an
        idempotent ⊕ (first best wins ties — deterministic)."""
        lo, _ = self.ranges[k]
        vals = self.lane_values(k)
        best = max(vals) if maximize else min(vals)
        return lo + vals.index(best)

    def logsumexp_lanes(self, k: int) -> Tuple[float, float]:
        """Cross-lane ⊕-combine for logsumexp: the combined value
        and its bound — worst lane bound (multiplicative-error
        argument, module docstring) plus the f64 combine rounding."""
        vals = np.asarray(self.lane_values(k), dtype=np.float64)
        errs = self.lane_errs(k)
        combined = float(_np_logsumexp(vals))
        err = max(errs, default=0.0) + _EPS64 * (len(errs) + 2)
        return combined, err

    def stats(self, k: int) -> Dict[str, int]:
        lo, hi = self.ranges[k]
        sw = self.sw
        return {
            "cells": sum(sw.cells[lo:hi]),
            "dispatches": sum(sw.dispatches[lo:hi]),
            "device_nodes": sum(sw.device_nodes[lo:hi]),
            "host_nodes": sum(sw.host_nodes[lo:hi]),
        }

    def width(self, k: int) -> int:
        lo, _ = self.ranges[k]
        return max(
            (len(s) for s in self.sw.seps[lo].values()), default=0
        )

    def meta(self, k: int) -> Dict[str, Any]:
        """The ``result["membound"]`` block.  ``on_device`` is true
        only when the device was still allowed at the final budget
        AND at least one of this instance's contractions actually
        dispatched — an ``auto``-mode sweep whose bounded tables all
        fell below ``device_min_cells`` truthfully reports False."""
        cp = self.cuts[k]
        return {
            "max_util_bytes": int(self.max_util_bytes),
            "budget_bytes": int(self.budget_bytes),
            "on_device": bool(
                self.on_device and self.stats(k)["device_nodes"] > 0
            ),
            "cut": list(cp.cut),
            "cut_width": cp.width,
            "cut_lanes": cp.n_lanes,
            "table_dtype": cp.table_dtype,
            "table_format": cp.table_format,
            "peak_table_bytes": cp.bounded_peak_cells
            * cp.bytes_per_cell,
            "naive_peak_table_bytes": cp.naive_peak_cells
            * cp.bytes_per_cell,
            "pruned_cells": int(self.pruned_cells),
            "replans": int(self.replans),
        }


def run_bounded(
    plans: Sequence[ContractionPlan],
    sr: Semiring,
    *,
    max_util_bytes: int,
    beta: float = 1.0,
    device_min_cells: Optional[int] = 1 << 14,
    pad=None,
    tol: float = 1e-6,
    max_table_size: int = 1 << 26,
    want_args: bool = False,
    max_cut_lanes: int = MAX_CUT_LANES,
    t0: Optional[float] = None,
    timeout: Optional[float] = None,
    bnb: str = "off",
    table_dtype: str = "f32",
    table_format: str = "dense",
    torch_device: Optional[torch.device] = None,
) -> Optional[BoundedSweep]:
    """Prune, plan, and run ONE budgeted merged sweep over K
    instances (module docstring), re-planning at half the budget on
    device OOM until the plan fits or the device is abandoned for
    bounded host f64.  Returns the :class:`BoundedSweep`, or None on
    timeout; raises :class:`MemboundError` when the USER's budget is
    itself unplannable (replan budgets that become unplannable fall
    to the host instead of raising — the caller asked for THAT
    budget, and the original plan still bounds host memory).  The
    device contractions run on ``torch_device``; after a device OOM the
    caching allocator's free blocks are released
    (``torch.cuda.empty_cache``) before the re-planned attempt.

    ``bnb`` threads the branch-and-bound pruned kernels through the
    budgeted sweep: each cut LANE is an instance of the merged sweep, so
    its pruning context (greedy incumbent, rest bounds, shift ledger) is
    built from the lane's own conditioned plan — exact per lane, and the
    cross-lane ⊕-combine is untouched.  ``plan_cut``'s byte sizing does
    not change: pruning changes which rows are worked, never what the
    device allocates."""
    from pydcop_tpu_torch.telemetry import get_metrics, get_tracer

    met = get_metrics()
    tracer = get_tracer()
    pad = NO_PADDING if pad is None else pad
    table_dtype = as_table_dtype(table_dtype)
    table_format = as_table_format(table_format)
    t0 = time.perf_counter() if t0 is None else t0
    if int(max_util_bytes) <= 0:
        raise ValueError(
            f"max_util_bytes must be > 0, got {max_util_bytes}"
        )

    pruned_cells = 0
    keep: List[Dict[str, np.ndarray]] = []
    orig_len: List[Dict[str, int]] = []
    for p in plans:
        pc, kp, ol = prune_plan(p)
        pruned_cells += pc
        keep.append(kp)
        orig_len.append(ol)
    if met.enabled and pruned_cells:
        met.inc("membound.pruned_cells", pruned_cells)

    # the user's budget must be plannable — this is the actionable
    # sizing error (peak bytes vs budget, cut width), replacing the
    # old "try order='min_fill'" retry hint for budgeted calls
    cuts0 = [
        plan_cut(
            p, max_util_bytes, pad, max_cut_lanes,
            cell_width=sr.cell_width, table_dtype=table_dtype,
            table_format=table_format,
        )
        for p in plans
    ]
    cuts = cuts0
    budget = int(max_util_bytes)
    dmc = device_min_cells
    replans = 0
    while True:
        if replans and torch.cuda.is_available():
            # the failed attempt's tensors are released once its
            # exception is gone: hand their blocks back to the device
            torch.cuda.empty_cache()
        flat: List[ContractionPlan] = []
        ranges: List[Tuple[int, int]] = []
        combos: List[list] = []
        for p, c in zip(plans, cuts):
            lps, cbs = lane_plans(p, c.cut)
            ranges.append((len(flat), len(flat) + len(lps)))
            flat.extend(lps)
            combos.append(cbs)
        try:
            sw = contract_sweep(
                flat, sr, beta=beta, device_min_cells=dmc, pad=pad,
                tol=tol, max_table_size=max_table_size,
                want_args=want_args, t0=t0, timeout=timeout,
                on_oom="raise" if dmc is not None else "host",
                bnb=bnb, table_dtype=table_dtype,
                table_format=table_format, torch_device=torch_device,
            )
        except DeviceOOMError:
            # the replan rung of the OOM ladder: level->node already
            # degraded inside the sweep; a per-node OOM means the
            # TABLES are too big, and only a tighter plan changes that
            replans += 1
            if met.enabled:
                met.inc("membound.replans")
            budget //= 2
            next_cuts = None
            if budget >= 2 * table_dtype_bytes(table_dtype):
                try:
                    next_cuts = [
                        plan_cut(
                            p, budget, pad, max_cut_lanes,
                            cell_width=sr.cell_width,
                            table_dtype=table_dtype,
                            table_format=table_format,
                        )
                        for p in plans
                    ]
                except MemboundError:
                    next_cuts = None
            if tracer.enabled:
                tracer.event(
                    "membound-replan", cat="supervisor",
                    budget_bytes=budget,
                    to_host=next_cuts is None,
                )
            if next_cuts is not None:
                cuts = next_cuts
                continue
            # bottom of the ladder: abandon the device.  Host f64 at
            # the ORIGINAL budget's plan — memory stays bounded, and
            # host contractions cannot OOM the accelerator.
            dmc = None
            budget = int(max_util_bytes)
            cuts = cuts0
            continue
        if sw is None:
            return None
        bs = BoundedSweep(
            sw, list(plans), cuts, ranges, flat, combos, keep,
            orig_len, replans, budget, int(max_util_bytes),
            pruned_cells, dmc is not None,
        )
        if met.enabled:
            # a gauge, not a counter: widths of successive budgeted
            # calls must not SUM into a meaningless total (the
            # per-result ``membound`` block carries exact values)
            met.gauge(
                "membound.cut_width",
                max((c.width for c in cuts), default=0),
            )
            met.inc(
                "membound.cut_lanes",
                sum(c.n_lanes for c in cuts),
            )
        return bs


def combine_marginals(
    bs: BoundedSweep,
    k: int,
    sr: Semiring,
    beta: float,
    t0: float,
    timeout: Optional[float],
) -> Optional[Dict[str, np.ndarray]]:
    """Cross-lane marginal combine for instance ``k``:
    ``p(x_v) = Σ_l w_l · p_l(x_v)`` with lane weights
    ``w_l ∝ exp(agg_l)`` (each lane's downward pass runs on host f64
    as in the unbudgeted sweep), scattered back over the ORIGINAL
    domain — pruned values carry exactly probability 0, and a cut
    variable's marginal is the normalized lane-weight mass of each of
    its conditioned values.  Returns None on timeout."""
    from pydcop_tpu_torch.ops.semiring import _downward_marginals

    lo, hi = bs.ranges[k]
    plan = bs.plans[k]
    cut = list(bs.cuts[k].cut)
    vals = np.asarray(bs.lane_values(k), dtype=np.float64)
    m = float(np.max(vals))
    if np.isfinite(m):
        w = np.exp(vals - m)
    else:  # every lane fully infeasible: weight lanes uniformly
        w = np.ones(len(vals))
    w = w / w.sum()

    keep = bs.keep[k]
    full: Dict[str, np.ndarray] = {
        v: np.zeros(bs.orig_len[k][v]) for v in plan.domains
    }
    for j, l in enumerate(range(lo, hi)):
        margs = _downward_marginals(
            bs.lanes[l], bs.sw, l, sr, beta, t0, timeout
        )
        if margs is None:
            return None
        combo = bs.combos[k][j]
        for v, p in margs.items():
            if v in cut:
                i_pruned = combo[cut.index(v)]
                full[v][keep[v][i_pruned]] += float(w[j])
            else:
                full[v][keep[v]] += w[j] * np.asarray(p)
    return full


# -- memory-bounded DPOP (min/+ through the same machinery) --------------


def solve_dpop_bounded(
    dcop,
    params: Dict[str, Any],
    *,
    timeout: Optional[float] = None,
    pad_policy: Any = None,
    max_table_size: int = 1 << 26,
    device: Optional[torch.device] = None,
) -> Dict[str, Any]:
    """Memory-bounded exact DPOP: ``build_plan`` over the pseudo-tree
    order (DPOP's own bucket tree), the budgeted min/+ sweep with the
    arg certificate per lane on ``device``, a VALUE phase on the winning
    lane, and the DPOP-shaped result dict plus a ``membound`` block.
    The entry ``algorithms/dpop.py:solve_host`` delegates to when
    ``max_util_bytes > 0`` or ``table_format='sparse'``."""
    # the unbudgeted UTIL phase's own knob resolution — one mapping, or
    # the budgeted path could drift off the bit-identical-to-unbounded
    # contract
    from pydcop_tpu_torch.algorithms.dpop import _resolve_device_min_cells
    from pydcop_tpu_torch.ops.padding import as_pad_policy
    from pydcop_tpu_torch.ops.semiring import (
        MIN_SUM,
        _value_phase,
        as_bnb,
        build_plan,
    )
    from pydcop_tpu_torch.telemetry import get_tracer

    t0 = time.perf_counter()
    max_util_bytes = int(params.get("max_util_bytes", 0) or 0)
    pad = as_pad_policy(pad_policy)
    dmc = _resolve_device_min_cells(params)

    plan = build_plan(dcop, order="pseudo_tree")
    t_util = time.perf_counter()
    bs = run_bounded(
        [plan], MIN_SUM,
        max_util_bytes=max_util_bytes,
        device_min_cells=dmc, pad=pad, want_args=True,
        max_table_size=max_table_size, t0=t0, timeout=timeout,
        bnb=as_bnb(params.get("bnb"), "auto"),
        table_dtype=as_table_dtype(params.get("table_dtype")),
        table_format=as_table_format(params.get("table_format")),
        torch_device=device,
    )
    if bs is None:
        return _dpop_timeout(dcop, t0)
    util_time = time.perf_counter() - t_util

    winner = bs.best_lane(0, maximize=False)
    t_value = time.perf_counter()
    assignment = _value_phase(bs.lanes[winner], bs.sw.args[winner])
    cost = dcop.solution_cost(assignment)
    tracer = get_tracer()
    if tracer.enabled:
        tracer.add_span(
            "value-phase", "phase", t_value,
            time.perf_counter() - t_value, algo="dpop",
        )
    stats = bs.stats(0)
    n_lanes = bs.cuts[0].n_lanes
    n_msgs = sum(
        1 for v in plan.order if plan.parent[v] is not None
    )
    height = max(plan.height.values(), default=0)
    return {
        "assignment": assignment,
        "cost": cost,
        "final_assignment": assignment,
        "final_cost": cost,
        "cycle": height,
        # one bounded UTIL + one VALUE message per non-root node per
        # cut lane — the MB-DPOP accounting
        "msg_count": 2 * n_msgs * n_lanes,
        "msg_size": stats["cells"] + n_msgs * n_lanes,
        "status": "finished",
        "time": time.perf_counter() - t0,
        "cost_trace": [cost],
        "util_time": util_time,
        "util_backend": "device" if bs.on_device else "host",
        "util_cells": stats["cells"],
        "util_device_nodes": stats["device_nodes"],
        "util_host_nodes": stats["host_nodes"],
        "util_dispatches": stats["dispatches"],
        "membound": bs.meta(0),
    }


def _dpop_timeout(dcop, t0: float) -> Dict[str, Any]:
    return {
        "assignment": {},
        "cost": None,
        "final_assignment": {},
        "final_cost": None,
        "cycle": 0,
        "msg_count": 0,
        "msg_size": 0,
        "status": "timeout",
        "time": time.perf_counter() - t0,
        "cost_trace": [],
    }
