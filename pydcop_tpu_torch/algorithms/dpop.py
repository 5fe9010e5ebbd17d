"""DPOP — exact dynamic programming on a pseudo-tree.

Port of ``pydcop_tpu/algorithms/dpop.py`` (pseudo-tree graph; bottom-up
UTIL hypercube joins with project-out-own-variable; top-down VALUE
assignments), rebuilt on arrays: a UTIL table is an n-dim tensor over
the separator's domains, the join is a broadcast-add over aligned axes,
and the projection is a ``min`` over the node's own axis.

Execution model: the pseudo-tree walk is host-side (it is sequential in
tree depth and runs once).  Each join/projection runs

- **on the device (f32)** when the node's joined table has at least
  ``device_min_cells`` cells (``util_device='auto'``, the default) —
  table sizes are exponential in separator width, while small tables
  are dominated by dispatch overhead;
- **on the host (f64 numpy)** otherwise.

The device is the one ``solve_host`` is given (the CUDA device unless
the caller asks for the CPU); its contraction is
``ops/semiring.py:contraction_kernel`` at min-sum, eager PyTorch
operations, as the JAX package's is jitted XLA.

The UTIL phase is LEVEL-SYNCHRONOUS: wave ``w`` holds the nodes of
height ``w``, which never depend on each other, so each wave's device
joins are grouped by *level-pack key* — the ``(joined shape, aligned
part shapes)`` pair, quantized to the pow-2 lattice of an optional
``pad_policy`` (``ops/padding.py:util_level_key``) — and run as ONE
stacked dispatch per bucket: one host→device transfer of the bucket's
parts, one device→host transfer each of ``amin`` and ``margins``.  With
a pow-2 policy near-miss shapes share buckets (ghost cells are
zero-padded and sliced away; a ``+inf`` own-axis mask keeps argmins
inside the real domain).  ``util_batch='node'`` keeps the same joins
but dispatches per node.

DPOP is an *exact* algorithm, so the f32 path carries a certificate.
The device computes only the ARGMIN over the own axis plus each cell's
decision margin (second best − best); since the join's inputs are exact
f64 tables rounded once to f32, a margin ≥ 2·(#parts+1)·eps32·Σᵢ
max|partᵢ| proves the f32 argmin equals the true argmin.  Near-tie
cells below that bound get their row recomputed exactly on the host.
The projected ``u`` values are then *evaluated on the host in f64 at
the certified argmin*, so every stored UTIL table is exact however it
was computed.  Tie-heavy tables (>10% of cells uncertifiable) are redone
wholesale on the host in f64, per NODE, and the sweep keeps going.  A
device out-of-memory error splits a level stack into per-node
dispatches; a node that still does not fit runs the host f64 join.
Both are counted (``util_host_nodes``, ``util_dispatches``) as in the
JAX package.

The VALUE phase only needs each node's argmin over its own axis, so the
UTIL phase retains just that (int) table per node.  ``max_util_size``
guards against width blowups with a clear error; ``memory_bound``
conditions a cut set of variables (one bounded pass per cut
assignment, best of them).

Each constraint is owned by the deepest variable in its scope; the
pseudo-tree invariant (every constraint's scope lies on one root-leaf
branch) guarantees all other scope variables are ancestors.

Message accounting: one UTIL message per non-root node (its table,
``d^|sep|`` cells) and one VALUE message back down.  ``cycle`` reports
the tree height.

``table_dtype`` (``f32``/``bf16``/``int8``) is the STORAGE precision of
the device parts: bf16 halves and int8 quarters the bytes each part
ships (int8 packs carry per-part scale/offset dequant params; reserved
codes keep ±inf exact).  The join stays f32 and the certificate widens
to the storage dtype's eps (plus the int8 quantization bound), so
results stay bit-identical to f32; low precision only widens the repair
set (``semiring.precision_repairs``).  ``max_util_bytes > 0`` and
``table_format='sparse'`` run the planner sweep instead
(``ops/membound.py:solve_dpop_bounded``; sparse with an effectively
unlimited budget), the same result dict plus a ``membound`` block.

``bnb`` prunes the UTIL joins by branch and bound (``ops/semiring.py``,
:class:`~pydcop_tpu_torch.ops.semiring._BnbContext`): a greedy incumbent
and the subtree rest bounds give every device row a budget, and rows
that provably cannot enter the optimum are masked.  ``'auto'`` (the
default) prunes the dispatches whose per-row padded table has at least
``BNB_AUTO_MIN_CELLS`` cells, ``'on'`` every device dispatch, ``'off'``
none.  Once the sweep has seen at least half of its rows pruned, a
bucket whose host pass 1 (per-part own-axis minima) kills at least
``BNB_HOST_FRAC`` of its rows contracts its survivors on the host in f64
instead of dispatching.  Results are bit-identical whatever the mode.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from pydcop_tpu_torch.algorithms import AlgoParameterDef
from pydcop_tpu_torch.device import DeviceLike, resolve_device
from pydcop_tpu_torch.engine.supervisor import DeviceOOMError, get_supervisor
from pydcop_tpu_torch.graphs import pseudotree as _pt
from pydcop_tpu_torch.ops import semiring as _semiring
from pydcop_tpu_torch.ops.padding import (
    NO_PADDING,
    PadPolicy,
    as_pad_policy,
    as_table_dtype,
    bucket_util_shape,
    pad_util_parts,
    stack_bucket,
    table_dtype_bytes,
    util_level_key,
)
from pydcop_tpu_torch.ops.sparse import as_table_format
from pydcop_tpu_torch.telemetry import get_metrics, get_tracer

GRAPH_TYPE = "pseudotree"

algo_params: list = [
    # device offload of the UTIL joins (see module docstring)
    AlgoParameterDef(
        "util_device", "str", ["auto", "never", "always"], "auto"
    ),
    # smallest joined-table size worth a device dispatch
    AlgoParameterDef("device_min_cells", "int", None, 1 << 14),
    # 'level' (default): one stacked dispatch per level-pack bucket per
    # wave; 'node': one dispatch per device node
    AlgoParameterDef("util_batch", "str", ["level", "node"], "level"),
    # bounded-memory exact mode: cap every UTIL table at this many
    # cells by CONDITIONING a cut set of variables (one bounded pass per
    # cut assignment, best of them).  0 = off
    AlgoParameterDef("memory_bound", "int", None, 0),
    # branch-and-bound pruned UTIL joins: 'auto' (default) prunes the
    # device dispatches whose per-row padded table clears
    # BNB_AUTO_MIN_CELLS, 'on' every device dispatch, 'off' none;
    # results are bit-identical either way
    AlgoParameterDef("bnb", "str", ["auto", "on", "off"], "auto"),
    # byte-budgeted exact mode (ops/membound.py): cap every UTIL table
    # at this many device bytes by conditioning a cut set whose
    # assignments ride the level-pack stack as extra lanes; a device OOM
    # re-plans at half the budget.  0 = off; excludes memory_bound
    AlgoParameterDef("max_util_bytes", "int", None, 0),
    # storage precision of the device UTIL parts (f32 join, certificate
    # widened to the storage eps: results bit-identical to f32)
    AlgoParameterDef(
        "table_dtype", "str", ["f32", "bf16", "int8"], "f32"
    ),
    # storage layout of the UTIL parts: 'sparse' COO-packs feasible
    # tuples and joins them by gather/segment reduce, through the
    # planner sweep (results bit-identical to dense)
    AlgoParameterDef(
        "table_format", "str", ["dense", "sparse"], "dense"
    ),
]



def build_computation(comp_def, seed: int = 0):
    """Host message-driven DPOP (thread/sim runtimes) — UTIL/VALUE
    messages over the pseudo-tree; the device UTIL path below remains
    the production engine."""
    from pydcop_tpu_torch.algorithms._host_dpop import (
        build_computation as _build,
    )

    return _build(comp_def, seed=seed)


from pydcop_tpu_torch.algorithms._tables import align_table as _align  # noqa: E402


def _prepare_instance(dcop, provenance: Optional[dict] = None):
    """Host-side problem setup: the pseudo-tree, per-variable domains and
    depths, and constraint ownership (each constraint owned by the
    deepest variable of its scope; external variables sliced out).

    ``provenance`` (optional out-param) records, per external-scoped
    constraint name, the ``(owner, index)`` slot its sliced table landed
    in inside ``owned`` — the hook
    :class:`~pydcop_tpu_torch.engine.memo.ExactSession` uses to
    re-tabulate only the constraints a ``set_values`` delta touched."""
    sign = -1.0 if dcop.objective == "max" else 1.0

    graph = _pt.build_computation_graph(dcop)
    ext_values = {n: ev.value for n, ev in dcop.external_variables.items()}

    domains: Dict[str, list] = {
        v.name: list(v.domain.values) for v in dcop.variables.values()
    }
    depth: Dict[str, int] = {}
    for root in graph.roots:
        for name in graph.depth_first_order(root):
            node = graph.node(name)
            depth[name] = 0 if node.parent is None else depth[node.parent] + 1

    # fold variable value costs; assign each constraint to the deepest
    # variable of its scope
    owned: Dict[str, List[Tuple[List[str], np.ndarray]]] = {
        n: [] for n in domains
    }
    for v in dcop.variables.values():
        if v.has_cost:
            costs = np.array(
                [sign * v.cost_for_val(x) for x in v.domain.values],
                dtype=np.float64,
            )
            owned[v.name].append(([v.name], costs))
    for c in dcop.constraints.values():
        cname = c.name
        scope_ext = [n for n in c.scope_names if n in ext_values]
        if scope_ext:
            c = c.slice({n: ext_values[n] for n in scope_ext})
        scope = list(c.scope_names)
        if not scope:
            continue
        m = c.as_matrix()
        table = sign * np.asarray(m.matrix, dtype=np.float64)
        owner = max(scope, key=lambda n: depth[n])
        if provenance is not None and scope_ext:
            provenance[cname] = (owner, len(owned[owner]))
        owned[owner].append((scope, table))
    return graph, domains, depth, owned


def _resolve_device_min_cells(params: Dict[str, Any]) -> Optional[int]:
    """``util_device``/``device_min_cells`` → the per-instance device
    threshold: None disables the device path entirely."""
    use_device = params.get("util_device", "auto")
    if use_device == "never":
        return None
    if use_device == "always":
        return 0
    return int(params.get("device_min_cells", 1 << 14))


def solve_host(
    dcop,
    params: Dict[str, Any],
    timeout: Optional[float] = None,
    max_util_size: int = 1 << 26,
    pad_policy: Any = None,
    device: DeviceLike = None,
) -> Dict[str, Any]:
    """Run DPOP to optimality; returns the JAX package's DPOP result
    dict.  ``pad_policy`` (str spec or :class:`PadPolicy`) buckets the
    UTIL level dispatches on the pow-2 lattice — results are
    bit-identical with or without it.  The device joins run on
    ``device``: the CUDA device unless ``"cpu"`` is passed."""
    t0 = time.perf_counter()
    pad = as_pad_policy(pad_policy)
    bnb = _semiring.as_bnb(params.get("bnb"), "auto")
    dev = resolve_device(device)

    # -- byte-budgeted exact mode (max_util_bytes > 0): the planner
    # sweep (ops/membound.py) — consistency-pruned domains, a cut set
    # chosen on the bucket-tree plan, cut lanes merged into one
    # level-pack-batched sweep, OOM re-planning — same result dict plus
    # a "membound" block
    max_util_bytes = int(params.get("max_util_bytes", 0) or 0)
    table_format = as_table_format(params.get("table_format"))
    if table_format == "sparse" and max_util_bytes <= 0:
        if int(params.get("memory_bound", 0) or 0):
            raise ValueError(
                "table_format='sparse' runs the planner sweep "
                "(ops/membound.py) and is incompatible with "
                "memory_bound's sequential conditioning passes — "
                "use max_util_bytes for bounded sparse runs"
            )
        # sparse storage lives in the plan-based sweep: run it with an
        # effectively unlimited byte budget (the cut stays empty)
        params = dict(params)
        params["max_util_bytes"] = 1 << 60
        max_util_bytes = 1 << 60
    if max_util_bytes > 0:
        if int(params.get("memory_bound", 0) or 0):
            raise ValueError(
                "memory_bound (sequential conditioning passes, "
                "cells) and max_util_bytes (planner cut lanes, "
                "bytes) are two bounded-memory modes — set one"
            )
        from pydcop_tpu_torch.ops.membound import solve_dpop_bounded

        return solve_dpop_bounded(
            dcop, params, timeout=timeout, pad_policy=pad,
            max_table_size=max_util_size, device=dev,
        )

    graph, domains, depth, owned = _prepare_instance(dcop)

    # -- bounded-memory planning (memory_bound > 0): pick a cut set
    # whose conditioning keeps every UTIL table under the bound
    memory_bound = int(params.get("memory_bound", 0) or 0)
    cut: List[str] = []
    if memory_bound > 0:
        bound = min(memory_bound, max_util_size)
        cut = _plan_conditioning(graph, domains, depth, owned, bound)
        max_util_size = bound

    device_min_cells = _resolve_device_min_cells(params)
    level_sync = params.get("util_batch", "level") != "node"
    table_dtype = as_table_dtype(params.get("table_dtype"))

    tracer = get_tracer()

    def one_pass(domains_p, owned_p):
        """One full UTIL+VALUE run (device path w/ host fallback).
        Returns (assignment, stats dict) or None on timeout."""
        t_util = time.perf_counter()
        util_backend = "host" if device_min_cells is None else "device"
        util_stats = _util_phase(
            graph, domains_p, depth, owned_p, t0, timeout,
            device_min_cells=device_min_cells, device=dev,
            max_util_size=max_util_size, pad=pad, level_sync=level_sync,
            bnb=bnb, table_dtype=table_dtype,
        )
        if util_stats is None:
            return None
        (best_choice, util_cells, device_nodes, host_nodes,
         dispatches) = util_stats
        t_value = time.perf_counter()
        tracer.add_span(
            "util-phase", "phase", t_util, t_value - t_util,
            algo="dpop", backend=util_backend, cells=util_cells,
        )
        assignment = _value_phase(graph, domains_p, best_choice)
        tracer.add_span(
            "value-phase", "phase", t_value,
            time.perf_counter() - t_value, algo="dpop",
        )
        return assignment, {
            "util_time": time.perf_counter() - t_util,
            "util_backend": util_backend,
            "util_cells": util_cells,
            "util_device_nodes": device_nodes,
            "util_host_nodes": host_nodes,
            "util_dispatches": dispatches,
        }

    if not cut:
        out = one_pass(domains, owned)
        if out is None:
            return _timeout_result(dcop, t0)
        assignment, stats = out
        n_passes = 1
    else:
        # conditioning search: one bounded pass per cut-set assignment,
        # keep the best (exact: every pass is optimal given its cut
        # values, and the enumeration covers the cut's whole space)
        from itertools import product as _product

        sign = -1.0 if dcop.objective == "max" else 1.0
        sign_best = float("inf")
        assignment = None
        stats = {
            "util_time": 0.0, "util_backend": "device",
            "util_cells": 0, "util_device_nodes": 0,
            "util_host_nodes": 0, "util_dispatches": 0,
        }
        n_passes = 0
        exhausted = True
        for combo in _product(*(range(len(domains[v])) for v in cut)):
            if timeout is not None and time.perf_counter() - t0 > timeout:
                exhausted = False
                break
            domains_p = dict(domains)
            for v, i in zip(cut, combo):
                domains_p[v] = [domains[v][i]]
            owned_p = {
                n: [
                    _condition_part(dims, table, cut, combo, domains)
                    for dims, table in parts
                ]
                for n, parts in owned.items()
            }
            out = one_pass(domains_p, owned_p)
            if out is None:
                exhausted = False
                break
            n_passes += 1
            a, s = out
            for key in ("util_time", "util_cells", "util_device_nodes",
                        "util_host_nodes", "util_dispatches"):
                stats[key] += s[key]
            if s["util_backend"] == "host":
                stats["util_backend"] = "host"
            c = sign * dcop.solution_cost(a)
            if c < sign_best:
                sign_best = c
                assignment = a
        if assignment is None:
            return _timeout_result(dcop, t0)
        if not exhausted:
            # partial enumeration is NOT exact — surface it
            r = _timeout_result(dcop, t0)
            r["assignment"] = r["final_assignment"] = assignment
            r["cost"] = r["final_cost"] = dcop.solution_cost(assignment)
            r["conditioned_vars"] = list(cut)
            r["conditioning_passes"] = n_passes
            return r

    result = _assemble_result(
        dcop, graph, domains, depth, assignment, stats, t0, n_passes
    )
    if cut:
        result["conditioned_vars"] = list(cut)
        result["conditioning_passes"] = n_passes
    return result


def solve_host_many(
    dcops: Sequence[Any],
    params_list: Sequence[Dict[str, Any]],
    timeout: Optional[float] = None,
    max_util_size: int = 1 << 26,
    pad_policy: Any = None,
    device: DeviceLike = None,
) -> List[Dict[str, Any]]:
    """Solve K DPOP instances with their UTIL phases merged into one
    level-synchronous sweep (:func:`_util_phase_multi`): wave ``w`` holds
    every instance's nodes of height ``w``, and same-bucket joins of
    different instances ride one stacked dispatch.

    Each result equals the sequential ``solve_host(dcops[i],
    params_list[i])``: the sweep runs the same joins in the same part
    order, the certified argmins are the true unique argmins whatever
    rides with them, and uncertified cells get the same host repair.
    Instances with ``memory_bound`` conditioning run alone (their UTIL
    phase is a dependent pass sequence), and so do budgeted and sparse
    instances (their planner sweep fills the stack axis with its own
    lanes).  ``util_batch="node"`` on any
    instance de-batches the whole sweep.  ``timeout`` bounds the whole
    call; ``util_time`` is the sweep's wall time divided evenly over its
    instances.
    """
    t0 = time.perf_counter()
    pad = as_pad_policy(pad_policy)
    dev = resolve_device(device)
    K = len(dcops)
    results: List[Optional[Dict[str, Any]]] = [None] * K

    def _remaining():
        if timeout is None:
            return None
        return max(timeout - (time.perf_counter() - t0), 0.01)

    merged = [
        i for i in range(K)
        if not int(params_list[i].get("memory_bound", 0) or 0)
        and not int(params_list[i].get("max_util_bytes", 0) or 0)
        and params_list[i].get("table_format", "dense") != "sparse"
    ]
    for i in range(K):
        if i not in merged:
            results[i] = solve_host(
                dcops[i], params_list[i], timeout=_remaining(),
                max_util_size=max_util_size, pad_policy=pad, device=dev,
            )
    if not merged:
        return results  # type: ignore[return-value]

    tracer = get_tracer()
    met = get_metrics()
    if met.enabled:
        met.inc("dpop.instances_batched", len(merged))
    preps = {i: _prepare_instance(dcops[i]) for i in merged}
    insts = [
        _UtilInstance(
            *preps[i], _resolve_device_min_cells(params_list[i]),
            as_table_dtype(params_list[i].get("table_dtype")),
            _semiring.as_bnb(params_list[i].get("bnb"), "auto"),
        )
        for i in merged
    ]
    level_sync = all(
        params_list[i].get("util_batch", "level") != "node" for i in merged
    )
    t_util = time.perf_counter()
    outs = _util_phase_multi(
        insts, t0, timeout, dev, max_util_size=max_util_size, pad=pad,
        level_sync=level_sync,
    )
    if outs is None:
        for i in merged:
            results[i] = _timeout_result(dcops[i], t0)
        return results  # type: ignore[return-value]
    tracer.add_span(
        "util-phase", "phase", t_util, time.perf_counter() - t_util,
        algo="dpop", backend="merged", instances=len(merged),
    )
    util_time = (time.perf_counter() - t_util) / len(merged)
    for i, inst, out in zip(merged, insts, outs):
        graph, domains, depth, _ = preps[i]
        best_choice, cells, dev_nodes, host_nodes, dispatches = out
        results[i] = _assemble_result(
            dcops[i], graph, domains, depth,
            _value_phase(graph, domains, best_choice),
            {
                "util_time": util_time,
                "util_backend": (
                    "host" if inst.device_min_cells is None else "device"
                ),
                "util_cells": cells,
                "util_device_nodes": dev_nodes,
                "util_host_nodes": host_nodes,
                "util_dispatches": dispatches,
            },
            t0, 1,
        )
    return results  # type: ignore[return-value]


def _value_phase(graph, domains, best_choice) -> Dict[str, Any]:
    """Top-down VALUE wave (pre-order): condition each node's retained
    argmin table on the accumulated ancestor assignment."""
    assignment: Dict[str, Any] = {}
    idx: Dict[str, int] = {}
    for root in graph.roots:
        for name in graph.depth_first_order(root):
            sep, amin = best_choice[name]
            best = int(amin[tuple(idx[d] for d in sep)])
            idx[name] = best
            assignment[name] = domains[name][best]
    return assignment


def _assemble_result(
    dcop,
    graph,
    domains,
    depth,
    assignment: Dict[str, Any],
    stats: Dict[str, Any],
    t0: float,
    n_passes: int,
) -> Dict[str, Any]:
    cost = dcop.solution_cost(assignment)
    n_msgs = sum(
        1 for n in domains if graph.node(n).parent is not None
    )
    height = max(depth.values(), default=0)
    return {
        "assignment": assignment,
        "cost": cost,
        "final_assignment": assignment,
        "final_cost": cost,
        "cycle": height,
        # per pass: one UTIL + one VALUE message per non-root node
        "msg_count": 2 * n_msgs * n_passes,
        "msg_size": stats["util_cells"] + n_msgs * n_passes,
        "status": "finished",
        "time": time.perf_counter() - t0,
        "cost_trace": [cost],
        "util_time": stats["util_time"],
        "util_backend": stats["util_backend"],
        "util_cells": stats["util_cells"],
        "util_device_nodes": stats["util_device_nodes"],
        "util_host_nodes": stats["util_host_nodes"],
        "util_dispatches": stats["util_dispatches"],
    }


def _condition_part(
    dims: List[str],
    table: np.ndarray,
    cut: List[str],
    combo: Tuple[int, ...],
    domains: Dict[str, list],
) -> Tuple[List[str], np.ndarray]:
    """Slice a part's conditioned axes to the chosen values, KEEPING the
    axes (length 1) so dims stay aligned with the singleton domains of
    the conditioned pass."""
    fixed = {v: i for v, i in zip(cut, combo)}
    hit = [d for d in dims if d in fixed]
    if not hit:
        return dims, table
    t = np.asarray(table)
    for d in hit:
        t = np.take(t, [fixed[d]], axis=dims.index(d))
    return dims, t


def _plan_conditioning(
    graph,
    domains: Dict[str, list],
    depth: Dict[str, int],
    owned: Dict[str, List[Tuple[List[str], np.ndarray]]],
    bound: int,
) -> List[str]:
    """Choose a cut set whose conditioning keeps every node's UTIL target
    under ``bound`` cells: a dims-only simulation of the separator
    propagation, and a greedy pick — from the largest oversized node,
    the shallowest unconditioned separator variable (the MB-DPOP
    'highest cycle-cut node' heuristic)."""
    names = [
        n for root in graph.roots for n in graph.depth_first_order(root)
    ]
    post = sorted(names, key=lambda n: -depth[n])

    def oversized(cut: set):
        util_dims: Dict[str, set] = {}
        out = []
        for name in post:
            node = graph.node(name)
            sep: set = set()
            for dims, _ in owned[name]:
                sep |= {d for d in dims if d != name}
            for child in node.children:
                sep |= util_dims[child] - {name}
            util_dims[name] = sep
            size = 1
            for d in list(sep) + [name]:
                size *= 1 if d in cut else len(domains[d])
            if size > bound:
                out.append((size, name, sep))
        return out

    cut: List[str] = []
    while True:
        ov = oversized(set(cut))
        if not ov:
            return cut
        size, name, sep = max(ov)
        cands = [
            d
            for d in list(sep) + [name]
            if d not in cut and len(domains[d]) > 1
        ]
        # a node with everything conditioned has size 1 <= bound, so an
        # oversized node always has an unconditioned multi-value dim
        if not cands:
            raise RuntimeError(f"no conditioning candidate for {name!r}")
        cut.append(min(cands, key=lambda d: (depth[d], d)))


class _PrecisionFallback(Exception):
    """Raised when too many f32 decision margins fail their error
    bound."""


class _UtilInstance(NamedTuple):
    """One instance's UTIL-phase inputs for the merged sweep."""

    graph: Any
    domains: Dict[str, list]
    depth: Dict[str, int]
    owned: Dict[str, List[Tuple[List[str], np.ndarray]]]
    device_min_cells: Optional[int]  # None = host-only instance
    # device storage precision of the UTIL parts (algo param
    # table_dtype); joins the level-pack bucket key so merged sweeps
    # never mix dtypes inside one dispatch
    table_dtype: str = "f32"
    # branch-and-bound pruning mode (algo param bnb); joins the bucket
    # key too, so a pruned kernel never runs an unpruned instance
    bnb: str = "off"
    # subtree-fingerprint message memo (engine/memo.py SweepMemoView, or
    # None): fingerprint-unchanged nodes reinstall their stored UTIL
    # message instead of re-contracting — the serving delta path
    memo: Any = None
    # previous solution as {var: domain index}: seeds the bnb incumbent,
    # so a warm re-solve prunes at least as hard as the cold one
    bnb_seed: Any = None


def _util_phase(
    graph,
    domains: Dict[str, list],
    depth: Dict[str, int],
    owned: Dict[str, List[Tuple[List[str], np.ndarray]]],
    t0: float,
    timeout: Optional[float],
    device_min_cells: Optional[int],
    device: torch.device,
    max_util_size: int = 1 << 26,
    pad: PadPolicy = NO_PADDING,
    level_sync: bool = True,
    bnb: str = "off",
    table_dtype: str = "f32",
):
    """Single-instance UTIL phase: the K=1 case of
    :func:`_util_phase_multi`.  Returns ``(best_choice, util_cells,
    device_nodes, host_nodes, dispatches)`` or None on timeout."""
    outs = _util_phase_multi(
        [
            _UtilInstance(
                graph, domains, depth, owned, device_min_cells,
                table_dtype, bnb,
            )
        ],
        t0, timeout, device, max_util_size=max_util_size,
        pad=pad, level_sync=level_sync,
    )
    return None if outs is None else outs[0]


def _device_parts(parts: Sequence[np.ndarray], nd: int, lead: tuple):
    """The dispatch's parts; a node with no part (a variable with no
    constraint and no child) contracts a single zero part instead, so
    the kernel always has a tensor to place its work with."""
    if parts:
        return list(parts)
    return [np.zeros(lead + (1,) * nd, dtype=np.float32)]


def _max_padded_util_cells(inst: _UtilInstance, pad) -> int:
    """Dims-only upper bound on the instance's largest PADDED UTIL join,
    the quantity ``bnb='auto'`` gates on (the sweep's twin is
    ``ops/semiring.py:max_padded_join_cells``): a separator simulation
    on the pad lattice, so an instance where no dispatch can clear
    ``BNB_AUTO_MIN_CELLS`` builds no pruning context."""
    dsize = {
        v: bucket_util_shape((len(dom),), pad)[0]
        for v, dom in inst.domains.items()
    }
    names = [
        n for root in inst.graph.roots
        for n in inst.graph.depth_first_order(root)
    ]
    util_dims: Dict[str, set] = {}
    mx = 1
    for name in reversed(names):  # children before parents
        node = inst.graph.node(name)
        sep: set = set()
        for dims, _ in inst.owned[name]:
            sep |= {d for d in dims if d != name}
        for c in node.children:
            sep |= util_dims[c] - {name}
        util_dims[name] = sep
        size = dsize[name]
        for d in sep:
            size *= dsize[d]
        mx = max(mx, size)
    return mx


def _host_pass1(aligned, sep_shape, budget) -> np.ndarray:
    """Pass 1 on the host: each row bounded by the sum of its parts'
    own-axis minima (exact f64, no join materialized), kept unless the
    bound exceeds ``budget`` (negated: a NaN bound is kept)."""
    with np.errstate(invalid="ignore"):
        rowb = np.zeros(sep_shape)
        for a in aligned:
            rowb = rowb + np.min(a, axis=-1)
        return np.logical_not(rowb > budget)


def _host_pass2(arrs, part_shapes, keep_b, w_own):
    """Pass 2 on the host: the exact f64 min and argmin of the SURVIVING
    rows only, gathered from the stacked parts ``arrs`` (``[rows,
    *part_shape]``); pruned cells get ``+inf`` and arg 0.  Returns
    ``(u, amin)`` shaped like ``keep_b``."""
    coords = np.nonzero(keep_b)
    n_surv = len(coords[0])
    M = np.zeros((n_surv, 1))
    for arr, ps in zip(arrs, part_shapes):
        idx = [coords[0]] + [
            coords[1 + j] if ps[j] != 1 else 0
            for j in range(keep_b.ndim - 1)
        ]
        M = M + arr[tuple(idx)]
    if M.shape[1] == 1:
        M = np.broadcast_to(M, (n_surv, w_own))
    u = np.full(keep_b.shape, np.inf)
    amin = np.zeros(keep_b.shape, dtype=np.intp)
    if n_surv:
        u[coords] = M.min(axis=1)
        amin[coords] = M.argmin(axis=1)
    return u, amin


def _util_phase_multi(
    insts: Sequence[_UtilInstance],
    t0: float,
    timeout: Optional[float],
    device: torch.device,
    max_util_size: int = 1 << 26,
    pad: PadPolicy = NO_PADDING,
    level_sync: bool = True,
):
    """Merged bottom-up UTIL sweep over one or many instances.

    Wave ``w`` holds, for every instance, the nodes of height ``w``
    (longest path down to a leaf) — a node always lands in a later wave
    than its children, and nodes of different instances never depend
    on each other, so each wave's device-eligible joins bucket by
    level-pack key (:func:`~pydcop_tpu_torch.ops.padding.util_level_key`)
    ACROSS instances and execute as ONE stacked
    join+project+argmin+margin dispatch per bucket.  Ghost cells from
    the padding are zero-filled, kept out of the certificate's error
    bound, guarded by a ``+inf`` own-axis mask, and sliced away before
    certification.  ``level_sync=False`` runs the same joins one
    dispatch per node.

    Per-instance ``device_min_cells=None`` forces that instance's pure
    host f64 path; otherwise joins of >= that many cells run on
    ``device`` with an f32 join under the error certificate, their
    parts stored at the instance's ``table_dtype`` (module docstring;
    the dtype joins the bucket key).  An instance's ``bnb`` mode (the
    bucket key again) prunes its device joins: the masked two-pass
    kernel, or, once the sweep's observed pruned fraction reaches
    ``BNB_HOST_FRAC``, a host pass 1 and, for a mostly-dead bucket, the
    compact host f64 pass 2 of its survivors.

    Returns one stats tuple ``(best_choice, util_cells, device_nodes,
    host_nodes, dispatches)`` per instance, or None for the whole call
    on timeout.
    """
    K = len(insts)
    met = get_metrics()
    tracer = get_tracer()
    sup = get_supervisor()
    utils: List[Dict[str, Tuple[List[str], np.ndarray, float]]] = [
        {} for _ in range(K)
    ]
    best_choice: List[Dict[str, Tuple[List[str], np.ndarray]]] = [
        {} for _ in range(K)
    ]
    util_cells = [0] * K
    device_nodes = [0] * K
    host_nodes = [0] * K
    dispatches = [0] * K
    _key_memo: Dict[tuple, tuple] = {}  # per call: pad is fixed here

    # branch-and-bound context per instance, and the call's running
    # pruned fraction: the host pass 1 costs a join-sized reduce, so it
    # runs only once the sweep has shown that most rows die
    obs = {"cells": 0, "pruned": 0}

    def try_host_pass2() -> bool:
        return (
            obs["cells"] >= (1 << 15)
            and obs["pruned"] >= _semiring.BNB_HOST_FRAC * obs["cells"]
        )

    ctxs: List[Any] = [None] * K
    for k, inst in enumerate(insts):
        if inst.bnb == "off" or inst.device_min_cells is None:
            continue
        if (
            inst.bnb == "auto"
            and _max_padded_util_cells(inst, pad)
            < _semiring.BNB_AUTO_MIN_CELLS
        ):
            # no join of this instance can clear the auto threshold:
            # no context, counted once
            if met.enabled:
                met.inc("semiring.bnb_skipped_small")
            continue
        names_pre = [
            n for root in inst.graph.roots
            for n in inst.graph.depth_first_order(root)
        ]
        ctxs[k] = _semiring._BnbContext(
            _semiring.MIN_SUM, names_pre, inst.domains, inst.owned,
            {n: list(inst.graph.node(n).children) for n in names_pre},
            table_dtype=inst.table_dtype,
        )
        if inst.bnb_seed is not None:
            # warm re-solve: the previous solution under the post-delta
            # tables is a valid incumbent (it IS an assignment), adopted
            # when it beats the greedy one
            ctxs[k].seed_incumbent(inst.owned, inst.bnb_seed)

    def finish(k, name, node, sep, u, amin, exact=True, budget_used=None,
               bmeta=None):
        # min-normalize the outgoing table (either path): argmin
        # decisions are shift-invariant, the final cost comes from
        # solution_cost(assignment), and keeping UTIL values at the
        # local cost scale keeps the per-node f32 rounding bounds small
        # up the whole tree.  Its finite abs-max is carried so the
        # parent's certificate bound needs no re-reduction (pruned rows
        # and hard constraints hold exact ±inf, not a rounding scale).
        best_choice[k][name] = (sep, amin)
        sh = 0.0
        mag = 0.0
        if node.parent is not None:
            if u.size:
                mn = u.min()
                if np.isfinite(mn):
                    sh = float(mn)
                    u = u - mn
            mag = _semiring._finite_amax(u)
            utils[k][name] = (sep, u, mag)
            util_cells[k] += u.size
        if ctxs[k] is not None:
            ctxs[k].record_shift(name, sh, node.children)
        memo = insts[k].memo
        if memo is not None:
            # a budget-pruned message (exact=False) is reusable only
            # under budget DOMINANCE next solve: store the budget used
            # and the metadata that recomputes the comparable budget.
            # Views into stack buffers are detached so an entry never
            # pins a whole level stack.
            mu = u if node.parent is not None else None
            if mu is not None and mu.base is not None:
                mu = mu.copy()
            ma = amin
            if isinstance(ma, np.ndarray) and ma.base is not None:
                ma = ma.copy()
            memo.store(
                name,
                (
                    sep, mu, mag, ma, sh, bool(exact),
                    None if budget_used is None else float(budget_used),
                    bmeta,
                ),
            )

    def note_pruned(keep, d_own, counted):
        """The pruned join cells of a keep mask, added to the running
        fraction unless pass 1 already added them."""
        pruned = int(keep.size - keep.sum()) * d_own
        if not counted:
            obs["cells"] += keep.size * d_own
            obs["pruned"] += pruned
        return pruned

    # wave plan: wave index = node HEIGHT, not depth — every leaf of
    # every instance lands in wave 0 whatever its depth
    waves: List[List[Tuple[int, str]]] = []
    for k, inst in enumerate(insts):
        names = [
            n
            for root in inst.graph.roots
            for n in inst.graph.depth_first_order(root)
        ]
        height: Dict[str, int] = {}
        for n in reversed(names):  # children before parents
            height[n] = 1 + max(
                (height[c] for c in inst.graph.node(n).children),
                default=-1,
            )
        for n in names:
            w = height[n]
            while len(waves) <= w:
                waves.append([])
            waves[w].append((k, n))

    for wave in waves:
        # -- prepare the wave: host joins run immediately, device joins
        # bucket by level-pack key across instances
        buckets: Dict[tuple, list] = {}
        order: List[tuple] = []
        for k, name in wave:
            if timeout is not None and time.perf_counter() - t0 > timeout:
                return None
            inst = insts[k]
            domains = inst.domains
            node = inst.graph.node(name)
            if inst.memo is not None:
                payload = inst.memo.lookup(name)
                if payload is not None:
                    (msep, mu, mmag, mamin, msh, mexact,
                     mbud, mbmeta) = payload
                    ok = mexact
                    if (
                        not ok
                        and ctxs[k] is not None
                        and mbud is not None
                        and mbmeta is not None
                    ):
                        # budget dominance: rows pruned last solve had a
                        # bound over the stored budget; under a budget
                        # no larger they are still provably dead
                        cur = ctxs[k].budget(
                            name, ctxs[k].shift_under(node.children),
                            *mbmeta,
                        )
                        ok = cur <= mbud
                    if ok:
                        # subtree fingerprint unchanged: every part of
                        # the subtree, and so the message, is
                        # bit-identical — reinstall it, skip the join
                        best_choice[k][name] = (msep, mamin)
                        if node.parent is not None:
                            utils[k][name] = (msep, mu, mmag)
                        if ctxs[k] is not None:
                            ctxs[k].record_shift(name, msh, node.children)
                        inst.memo.mark_hit()
                        continue
            # effective separator: ancestors referenced by own relations
            # or children's separators.  Owned relations are PRE-SUMMED
            # into one exact f64 part (the same join, left-associated
            # order preserved; fewer parts, one rounding of the sum)
            sep: List[str] = []
            parts: List[Tuple[List[str], np.ndarray]] = []
            parts_max = 0.0  # Σ max|part| for the certificate bound
            own_parts = inst.owned[name]
            if len(own_parts) > 1:
                odims: List[str] = []
                for dims, _ in own_parts:
                    odims.extend(d for d in dims if d not in odims)
                o = np.zeros(
                    [len(domains[d]) for d in odims], dtype=np.float64
                )
                for dims, table in own_parts:
                    o = o + _align(table, dims, odims)
                own_parts = [(odims, o)]
            for dims, table in own_parts:
                parts.append((dims, table))
                # finite-masked |max|: ±inf hard-constraint entries are
                # EXACT in f32 and must not void the certificate
                parts_max += _semiring._finite_amax(table)
                sep.extend(d for d in dims if d != name)
            for child in node.children:
                cdims, ctable, cmax = utils[k][child]
                parts.append((cdims, ctable))
                parts_max += cmax
                sep.extend(d for d in cdims if d != name)
            sep = sorted(set(sep), key=lambda n: inst.depth[n])
            target = sep + [name]
            shape = [len(domains[d]) for d in target]
            size = 1
            for s in shape:
                size *= s
            if size > max_util_size:
                raise ValueError(
                    f"DPOP UTIL table for {name!r} needs {size} cells "
                    f"(separator {sep}); exceeds max_util_size="
                    f"{max_util_size}.  The induced width is too large "
                    f"for exact DPOP — use a local-search or message-"
                    f"passing algorithm instead."
                )
            dmc = inst.device_min_cells
            if dmc is None or size < dmc:
                j = np.zeros(shape, dtype=np.float64)
                for dims, table in parts:
                    j = j + _align(table, dims, target)
                u = j.min(axis=-1)
                amin = np.argmin(j, axis=-1)
                del j
                host_nodes[k] += 1
                finish(k, name, node, sep, u, amin)
                continue
            # aligned in exact f64: the stacked path casts the whole
            # stack to f32 per part position; the per-node path casts
            # per part just before its dispatch
            aligned = [_align(t, dims, target) for dims, t in parts]
            ctx = ctxs[k]
            budget = None
            if ctx is not None:
                budget = ctx.budget(
                    name, ctx.shift_under(node.children), len(parts),
                    parts_max, shape[-1], size // max(shape[-1], 1),
                )
            # the bnb mode joins the bucket key: a pruned kernel (budget
            # operand, keep output) never stacks with an unpruned one
            mode = inst.bnb if ctx is not None else "off"
            raw = (
                tuple(shape), tuple(a.shape for a in aligned),
                mode, inst.table_dtype,
            )
            key = _key_memo.get(raw)
            if key is None:  # UTIL trees repeat shapes heavily; an int8
                # kernel's dequant operands never stack with f32 rows
                key = _key_memo[raw] = util_level_key(
                    raw[0], raw[1], pad
                ) + raw[2:]
            if key not in buckets:
                buckets[key] = []
                order.append(key)
            buckets[key].append(
                ((k, name, node, sep, target, shape, parts, parts_max,
                  budget), aligned)
            )

        # -- device joins: one stacked dispatch per level-pack bucket,
        # with the host glue (stack buffers, certification, exact-u
        # gather) vectorized per bucket too
        for key in order:
            entries = buckets[key]
            if timeout is not None and time.perf_counter() - t0 > timeout:
                return None
            pshape, part_shapes, bnb_mode, bucket_dt = key
            n_rows = len(entries)
            shape0 = entries[0][0][5]
            uniform = all(it[5] == shape0 for it, _ in entries)
            kshapes = part_shapes or ((1,) * len(pshape),)
            use_bnb = False
            if bnb_mode != "off":
                use_bnb = bnb_mode == "on" or (
                    int(np.prod(pshape)) >= _semiring.BNB_AUTO_MIN_CELLS
                )
                if not use_bnb and met.enabled:
                    met.inc("semiring.bnb_skipped_small")
            level_batched = False
            obs_counted = False
            if level_sync and uniform and n_rows > 1:
                stack_h = stack_bucket(n_rows) if pad.enabled else n_rows
                # f64 stack buffers: exact values for the batched
                # exact-u gather below; the f32 cast happens once per
                # part position on the way to the device
                bufs = [
                    np.zeros((stack_h,) + ps, dtype=np.float64)
                    for ps in part_shapes
                ]
                for r, (item, aligned) in enumerate(entries):
                    for i, a in enumerate(aligned):
                        bufs[i][r][
                            tuple(slice(0, s) for s in a.shape)
                        ] = a
                    if pad.enabled:  # own-axis ghost guard (mask)
                        bufs[-1][r][..., shape0[-1]:] = np.inf
                # f64 for the host pass 1, rounded to f32 for the kernel
                budgets = _semiring._budgets(
                    entries, stack_h, _semiring.MIN_SUM, np.float64
                ) if use_bnb else None
                if use_bnb and bufs and try_host_pass2():
                    # pass 1 on the host; a bucket with at least
                    # BNB_HOST_FRAC of its rows dead contracts its
                    # survivors on the host in f64 (no dispatch, no
                    # certificate); the others take the masked kernel
                    keep_b = np.stack([
                        _host_pass1(aligned, tuple(shape0[:-1]),
                                    budgets[r])
                        for r, (_, aligned) in enumerate(entries)
                    ])
                    pruned = note_pruned(keep_b, shape0[-1], False)
                    obs_counted = True
                    n_dead = keep_b.size - int(keep_b.sum())
                    if n_dead >= _semiring.BNB_HOST_FRAC * keep_b.size:
                        u_b, amin_b = _host_pass2(
                            bufs, part_shapes, keep_b, pshape[-1]
                        )
                        if met.enabled:
                            met.inc("semiring.bnb_passes")
                        _semiring._note_bnb(
                            met, tracer, _semiring.MIN_SUM, n_rows, pruned,
                            int(np.prod(shape0)) * n_rows, pass2="host",
                        )
                        for r, (item, _) in enumerate(entries):
                            (k, name, node, sep, _t, shape, parts,
                             sum_max_abs, _budget) = item
                            host_nodes[k] += 1
                            finish(
                                k, name, node, sep, u_b[r],
                                amin_b[r:r + 1].reshape(tuple(shape[:-1])),
                                exact=(
                                    _budget is None
                                    or bool(keep_b[r].all())
                                ),
                                budget_used=_budget,
                                bmeta=_bmeta(parts, sum_max_abs, shape),
                            )
                        continue
                fn = _semiring.contraction_kernel(
                    _semiring.MIN_SUM, pshape, kshapes, batched=True,
                    bnb=use_bnb, table_dtype=bucket_dt,
                )
                dequant, packed = _semiring.pack_rows(
                    _device_parts(bufs, len(pshape), (stack_h,)),
                    bucket_dt, n_rows, met,
                )
                casts = dequant + packed
                if use_bnb:
                    casts = [budgets.astype(np.float32)] + casts
                try:
                    # the outputs come back to the host inside the
                    # supervised call: a device failure surfaces there
                    outs_b = sup.dispatch(
                        lambda: _semiring._dispatch(fn, casts, device),
                        scope="dpop.level", width=stack_h,
                        table_bytes=table_dtype_bytes(bucket_dt)
                        * int(np.prod(pshape)),
                    )
                    level_batched = True
                except DeviceOOMError:
                    # OOM degradation ladder: a level stack that does
                    # not fit splits into one dispatch per node (the
                    # per-node path below); a node whose single join
                    # still does not fit runs the exact host f64 join
                    # there.  Exactness is untouched either way.
                    if met.enabled:
                        met.inc("engine.oom_splits")
            if level_batched:
                if met.enabled:
                    met.inc("dpop.level_dispatches")
                for k in sorted({item[0] for item, _ in entries}):
                    dispatches[k] += 1
                # certification, vectorized over the stack: slice the
                # real region once, one argwhere against the per-row
                # error bounds, repairs grouped by row
                region = (slice(0, n_rows),) + tuple(
                    slice(0, s) for s in shape0[:-1]
                )
                aminb, margb = outs_b[:2]
                amin_b = np.array(aminb[region])  # writable (repair)
                marg_b = np.asarray(margb[region], dtype=np.float64)
                keep_b = None
                if use_bnb:
                    keep_b = np.asarray(outs_b[2][region], dtype=bool)
                    pruned = note_pruned(keep_b, shape0[-1], obs_counted)
                    if met.enabled:
                        met.inc("semiring.bnb_passes")
                    _semiring._note_bnb(
                        met, tracer, _semiring.MIN_SUM, n_rows, pruned,
                        int(np.prod(shape0)) * n_rows,
                    )
                # certificate bound at the STORAGE precision: each part
                # arrived rounded to bucket_dt
                errs = np.array(
                    [
                        2.0 * _semiring.storage_error(
                            bucket_dt, len(it[6]), it[7]
                        )
                        for it, _ in entries
                    ]
                )
                bad = np.argwhere(
                    marg_b
                    < errs.reshape((n_rows,) + (1,) * (marg_b.ndim - 1))
                )
                n_bad = np.bincount(bad[:, 0], minlength=n_rows)
                _semiring.note_precision_repairs(met, bucket_dt, len(bad))
                bad_by_row: Dict[int, list] = {}
                for cell in bad:
                    bad_by_row.setdefault(int(cell[0]), []).append(
                        tuple(int(c) for c in cell[1:])
                    )
                sep_cells = int(marg_b.size // n_rows)
                # tie-heavy rows go to the host redo FIRST; everyone
                # else's near-tie cells are repaired in amin_b before
                # the batched exact-u gather reads it
                redone = set()
                for r, (item, aligned) in enumerate(entries):
                    if int(n_bad[r]) * 10 > sep_cells:
                        _host_redo(met, host_nodes, finish, item)
                        redone.add(r)
                        continue
                    target, shape, parts = item[4:7]
                    amin_r = amin_b[r:r + 1].reshape(tuple(shape[:-1]))
                    for cell in bad_by_row.get(r, ()):
                        row = np.zeros(shape[-1], dtype=np.float64)
                        for dims, table in parts:
                            row += _cell_slice(table, dims, target, cell)
                        amin_r[cell] = int(row.argmin())
                # exact u, vectorized over the whole stack: gather each
                # f64 part buffer AT the certified argmin; summation
                # order is the parts order, so values are bit-identical
                # to the per-node _exact_u_at
                u_b = _exact_u_stack(
                    bufs[:len(entries[0][1])], part_shapes, shape0,
                    amin_b, keep_b,
                )
                for r, (item, aligned) in enumerate(entries):
                    if r in redone:
                        continue
                    (k, name, node, sep, target, shape, parts,
                     sum_max_abs, _budget) = item
                    amin_r = amin_b[r:r + 1].reshape(tuple(shape[:-1]))
                    device_nodes[k] += 1
                    finish(
                        k, name, node, sep, u_b[r], amin_r,
                        exact=(
                            keep_b is None
                            or _budget is None
                            or bool(keep_b[r].all())
                        ),
                        budget_used=_budget,
                        bmeta=_bmeta(parts, sum_max_abs, shape),
                    )
                continue

            # per-node dispatches: util_batch='node', singleton buckets,
            # mixed real shapes under one padded key, or a level stack
            # that did not fit on the device
            fn = _semiring.contraction_kernel(
                _semiring.MIN_SUM, pshape, kshapes, bnb=use_bnb,
                table_dtype=bucket_dt,
            )
            for item, aligned in entries:
                (k, name, node, sep, target, shape, parts,
                 sum_max_abs, budget) = item
                if timeout is not None and time.perf_counter() - t0 > timeout:
                    return None
                if budget is None:
                    budget = _semiring._no_prune(_semiring.MIN_SUM)
                node_counted = False
                if use_bnb and aligned and len(shape) > 1 and (
                    try_host_pass2()
                ):
                    # pass 1 on the host; a mostly-dead node contracts
                    # its survivors on the host instead of dispatching
                    keep_r = _host_pass1(aligned, tuple(shape[:-1]), budget)
                    pruned = note_pruned(keep_r, shape[-1], False)
                    node_counted = True
                    n_dead = keep_r.size - int(keep_r.sum())
                    if n_dead >= _semiring.BNB_HOST_FRAC * keep_r.size:
                        u, amin = _host_pass2(
                            [np.asarray(a, dtype=np.float64)[None]
                             for a in aligned],
                            [a.shape for a in aligned], keep_r[None],
                            shape[-1],
                        )
                        if met.enabled:
                            met.inc("semiring.bnb_passes")
                        _semiring._note_bnb(
                            met, tracer, _semiring.MIN_SUM, 1, pruned,
                            int(np.prod(shape)), pass2="host",
                        )
                        host_nodes[k] += 1
                        finish(
                            k, name, node, sep, u[0], amin[0],
                            exact=bool(keep_r.all()),
                            budget_used=budget,
                            bmeta=_bmeta(parts, sum_max_abs, shape),
                        )
                        continue
                if pad.enabled:
                    aligned = pad_util_parts(aligned, shape, pshape)
                else:
                    aligned = [np.asarray(a, dtype=np.float32)
                               for a in aligned]
                packed = _semiring._pack_parts(
                    _device_parts(aligned, len(pshape), ()), bucket_dt, met
                )
                if use_bnb:
                    packed = [np.float32(budget)] + packed
                try:
                    outs_n = sup.dispatch(
                        lambda p=packed: _semiring._dispatch(fn, p, device),
                        scope="dpop.node", width=1,
                        table_bytes=table_dtype_bytes(bucket_dt)
                        * int(np.prod(pshape)),
                    )
                except DeviceOOMError:
                    # bottom of the OOM ladder: this single join does
                    # not fit on the device even alone — redo it
                    # wholesale on host f64 (exact) and keep sweeping
                    _host_redo(met, host_nodes, finish, item)
                    continue
                if met.enabled:  # per executed dispatch, as in the JAX
                    met.inc("dpop.level_dispatches")  # package
                    if use_bnb:
                        met.inc("semiring.bnb_passes")
                dispatches[k] += 1
                # slice the level-pack ghost cells away before
                # certification: only the real region is decided here
                region = tuple(slice(0, s) for s in shape[:-1])
                amin = np.array(outs_n[0][region])  # writable (repair)
                margins = np.asarray(outs_n[1][region], dtype=np.float64)
                keep_r = None
                if use_bnb:
                    keep_r = np.asarray(outs_n[2][region], dtype=bool)
                    pruned = note_pruned(keep_r, shape[-1], node_counted)
                    if pruned and met.enabled:
                        met.inc("semiring.bnb_pruned_cells", pruned)
                try:
                    n_bad = _certify_and_repair(
                        name, parts, target, shape, amin, margins,
                        sum_max_abs, table_dtype=bucket_dt,
                    )
                except _PrecisionFallback:
                    _host_redo(met, host_nodes, finish, item)
                    continue
                _semiring.note_precision_repairs(met, bucket_dt, n_bad)
                u = _exact_u_at(parts, target, shape, amin, keep_r)
                device_nodes[k] += 1
                finish(
                    k, name, node, sep, u, amin,
                    exact=keep_r is None or bool(keep_r.all()),
                    budget_used=budget,
                    bmeta=_bmeta(parts, sum_max_abs, shape),
                )
    return [
        (
            best_choice[k], util_cells[k], device_nodes[k],
            host_nodes[k], dispatches[k],
        )
        for k in range(K)
    ]


def _bmeta(parts, sum_max_abs, shape) -> tuple:
    """The budget metadata a memoized pruned message stores: the
    ``_BnbContext.budget`` arguments after the shift, so a later solve
    recomputes the comparable budget."""
    return (len(parts), sum_max_abs, shape[-1], int(np.prod(shape[:-1])))


def _exact_u_stack(bufs, part_shapes, shape0, amin_b, keep_b):
    """Exact f64 u of a whole stack: each f64 part buffer gathered AT the
    certified argmin, in parts order (the per-node :func:`_exact_u_at`'s
    bits).  ``keep_b`` (bnb) marks the surviving rows: pruned cells read
    ``+inf``, and with a quarter or more pruned only the survivors are
    gathered."""
    n_rows = amin_b.shape[0]
    nsep = len(shape0) - 1
    if keep_b is not None and 4 * int(keep_b.sum()) < 3 * keep_b.size:
        coords = np.nonzero(keep_b)
        a_sel = amin_b[coords]
        acc = np.zeros(len(coords[0]))
        for buf, ps in zip(bufs, part_shapes):
            idx = [coords[0]] + [
                coords[1 + j] if ps[j] != 1 else 0 for j in range(nsep)
            ]
            idx.append(a_sel if ps[-1] != 1 else 0)
            acc += buf[tuple(idx)]
        u_b = np.full((n_rows,) + tuple(shape0[:-1]), np.inf)
        u_b[coords] = acc
        return u_b
    grids = np.indices(shape0[:-1], dtype=np.intp) if nsep else None
    rows_ix = np.arange(n_rows).reshape((n_rows,) + (1,) * nsep)
    u_b = np.zeros((n_rows,) + tuple(shape0[:-1]))
    for buf, ps in zip(bufs, part_shapes):
        idx = [rows_ix] + [
            grids[j] if ps[j] != 1 else 0 for j in range(nsep)
        ]
        idx.append(amin_b if ps[-1] != 1 else 0)
        u_b += buf[tuple(idx)]
    if keep_b is not None:
        u_b = np.where(keep_b, u_b, np.inf)
    return u_b


def _certify_and_repair(name, parts, target, shape, amin, margins,
                        sum_max_abs, table_dtype="f32"):
    """Storage-precision argmin certificate + exact host repair of
    near-ties.

    Inputs to the device join are exact up to one rounding at the
    storage dtype (children's utils are exact f64, see
    :func:`_exact_u_at`), so |J_dt − J| ≤ local_err and a margin ≥
    2·local_err proves the device argmin is the true argmin.  The bound
    scales with Σᵢ max|partᵢ| (NOT max|J|): parts of mixed sign can
    cancel in J while each carries rounding error at its own magnitude.
    ``table_dtype`` is the storage dtype the join ran at
    (``ops/semiring.py:storage_error``: bf16 widens the roundoff, int8
    adds its quantization bound).
    Uncertifiable cells get their row recomputed exactly; returns the
    repaired-cell count.  Raises :class:`_PrecisionFallback` when the
    table is so tie-heavy that per-cell repair would dominate (>10% of
    cells).
    """
    local_err = _semiring.storage_error(table_dtype, len(parts), sum_max_abs)
    bad = np.argwhere(margins < 2.0 * local_err)
    if len(bad) * 10 > margins.size:
        raise _PrecisionFallback(
            f"{name}: {len(bad)} of {margins.size} cells below the "
            f"bound {2.0 * local_err}"
        )
    for cell in map(tuple, bad):
        row = np.zeros(shape[-1], dtype=np.float64)
        for dims, table in parts:
            row += _cell_slice(table, dims, target, cell)
        amin[cell] = int(row.argmin())
    return len(bad)


def _host_redo(met, host_nodes, finish, item):
    """Redo THIS node wholesale on host f64, the same join the pure host
    path runs, and keep the sweep going (a tie-heavy table, or a join
    that does not fit on the device); counted as
    ``dpop.cert_fallbacks``, as in the JAX package."""
    k, name, node, sep, target, shape, parts = item[:7]
    if met.enabled:
        met.inc("dpop.cert_fallbacks")
    j = np.zeros(shape, dtype=np.float64)
    for dims, table in parts:
        j = j + _align(table, dims, target)
    u = j.min(axis=-1)
    amin = np.argmin(j, axis=-1)
    host_nodes[k] += 1
    finish(k, name, node, sep, u, amin)


def _exact_u_at(parts, target, shape, amin, keep=None):
    """Exact f64 u: evaluate the join only AT the chosen argmin,
    ``u[cell] = Σ_parts part[cell, amin[cell]]`` — O(cells·parts)
    instead of the full O(cells·d·parts) join, and exact because every
    part (child utils included) is exact f64.  ``keep`` (bnb) marks the
    surviving rows: pruned cells read ``+inf`` (the ⊕-identity), and
    with a quarter or more pruned only the survivors are gathered."""
    own = target[-1]
    if keep is not None and len(shape) > 1 and (
        4 * int(keep.sum()) < 3 * keep.size
    ):
        coords = np.nonzero(keep)
        a_sel = amin[coords]
        acc = np.zeros(len(coords[0]), dtype=np.float64)
        for dims, table in parts:
            idx = [a_sel if d == own else coords[target.index(d)]
                   for d in dims]
            acc += np.asarray(table, dtype=np.float64)[tuple(idx)]
        u = np.full(shape[:-1], np.inf)
        u[coords] = acc
        return u
    grids = np.indices(shape[:-1], dtype=np.intp)
    u = np.zeros(shape[:-1], dtype=np.float64)
    for dims, table in parts:
        idx = []
        for d in dims:
            if d == own:
                idx.append(amin)
            else:
                idx.append(grids[target.index(d)])
        u += np.asarray(table, dtype=np.float64)[tuple(idx)]
    if keep is not None:
        u = np.where(keep, u, np.inf)
    return u


def _cell_slice(
    table: np.ndarray,
    dims: List[str],
    target: List[str],
    cell: tuple,
) -> np.ndarray:
    """Exact f64 row of one part at a fixed separator ``cell``: index
    the part's separator axes, broadcast over the own (last target)
    axis."""
    own = target[-1]
    idx = []
    for d in dims:
        if d == own:
            idx.append(slice(None))
        else:
            idx.append(cell[target.index(d)])
    row = np.asarray(table, dtype=np.float64)[tuple(idx)]
    if own not in dims:
        # every axis was scalar-indexed: row is 0-d, broadcast it over
        # the own axis as a length-1 row
        return np.full(1, float(row))
    return row


def _timeout_result(dcop, t0: float) -> Dict[str, Any]:
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


# -- distribution-layer footprint callbacks ------------------------------

UNIT_SIZE = 1
HEADER_SIZE = 0


def computation_memory(node: _pt.PseudoTreeNode) -> float:
    """UTIL table cells: d^(|separator| + 1) for the node's join."""
    d = max(len(node.variable.domain), 1)
    sep = ([node.parent] if node.parent else []) + list(node.pseudo_parents)
    return float(d ** (len(sep) + 1)) * UNIT_SIZE


def communication_load(node: _pt.PseudoTreeNode, neighbor_name: str) -> float:
    """UTIL message to the parent dominates: d^|separator| cells."""
    d = max(len(node.variable.domain), 1)
    sep = ([node.parent] if node.parent else []) + list(node.pseudo_parents)
    if neighbor_name == node.parent:
        return HEADER_SIZE + float(d ** len(sep))
    return HEADER_SIZE + UNIT_SIZE
