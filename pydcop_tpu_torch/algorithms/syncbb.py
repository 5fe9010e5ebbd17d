"""SyncBB — Synchronous Branch & Bound on an ordered variable chain.

A port of ``pydcop_tpu/algorithms/syncbb.py`` (ordered graph; a token
carrying the current partial assignment and bound walks the chain;
backtracking on bound violation; exact result).

Like DPOP, SyncBB is inherently sequential (one token), so it runs
host-side via the ``solve_host`` contract, in numpy: it uses no device,
so ``device`` is accepted for the host-path signature and unused.  The
per-level work is vectorized: when the token reaches position ``i``, the cost of
*every* candidate value of ``v_i`` against the partial assignment is
one vectorized table gather (a numpy row, the same aligned-table layout
the device compiler uses) instead of the reference's per-value python
loops — and candidate values are explored best-first, which tightens
the upper bound early and prunes harder.

Message accounting (reference semantics): every token hand-off along
the chain — one per forward extension and one per backtrack — counts
as one message; ``cycle`` reports the number of token hand-offs.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.graphs import ordered_graph as _og

GRAPH_TYPE = "ordered_graph"

algo_params: list = []


def build_computation(comp_def, seed: int = 0):
    """Host message-driven SyncBB (thread/sim runtimes) — the
    bound-token walk as real messages; the vectorized solver below
    remains the production engine."""
    from pydcop_tpu_torch.algorithms._host_syncbb import (
        build_computation as _build,
    )

    return _build(comp_def, seed=seed)


def solve_host(
    dcop: DCOP,
    params: Dict[str, Any],
    timeout: Optional[float] = None,
    max_util_size: int = 1 << 26,
    pad_policy: Any = None,
    device: Any = None,
) -> Dict[str, Any]:
    """Exact branch & bound; returns the JAX package's result dict.
    ``max_util_size``, ``pad_policy`` and ``device`` belong to the
    host-path signature (``algorithms/__init__.py``) and do not apply."""
    t0 = time.perf_counter()
    sign = -1.0 if dcop.objective == "max" else 1.0

    graph = _og.build_computation_graph(dcop)
    ordering = graph.ordering
    n = len(ordering)
    pos = {name: i for i, name in enumerate(ordering)}
    variables = [dcop.variables[name] for name in ordering]
    domains = [list(v.domain.values) for v in variables]
    ext_values = {e: ev.value for e, ev in dcop.external_variables.items()}

    # per position i: constraints that become fully assigned at i
    # (deepest scope variable is i), tabulated with scope sorted by
    # position so the cost of all candidate values of v_i given the
    # prefix is one fancy-index gather over the last axis.
    # Every table is shifted by its minimum so all increments are >= 0 —
    # without this, negative entries (any max problem, or negative
    # costs) would make the partial cost an invalid lower bound and the
    # ub-prune unsound.  The constant shift does not change the argmin.
    level_tables: List[List[Tuple[List[int], np.ndarray]]] = [
        [] for _ in range(n)
    ]
    for c in dcop.constraints.values():
        scope_ext = [s for s in c.scope_names if s in ext_values]
        if scope_ext:
            c = c.slice({s: ext_values[s] for s in scope_ext})
        scope = list(c.scope_names)
        if not scope:
            continue
        m = c.as_matrix()
        table = sign * np.asarray(m.matrix, dtype=np.float64)
        table = table - table.min()
        order = sorted(range(len(scope)), key=lambda j: pos[scope[j]])
        table = np.transpose(table, order)
        scope = [scope[j] for j in order]
        level = pos[scope[-1]]
        level_tables[level].append(([pos[s] for s in scope[:-1]], table))

    unary = []
    for v in variables:
        row = np.zeros(len(v.domain), dtype=np.float64)
        if v.has_cost:
            row += [sign * v.cost_for_val(x) for x in v.domain.values]
            row -= row.min()
        unary.append(row)

    def level_costs(i: int, idx: List[int]) -> np.ndarray:
        """Cost added by assigning each candidate value at position i,
        given the prefix assignment ``idx[0:i]``."""
        row = unary[i].copy()
        for prefix_pos, table in level_tables[i]:
            sel = table[tuple(idx[p] for p in prefix_pos)]
            row += sel[: len(row)]
        return row

    # -- depth-first search with best-first value ordering --------------
    ub = np.inf
    best_idx: Optional[List[int]] = None
    idx = [0] * n
    # per level: candidate value order, cursor, cost rows, prefix cost
    order_stack: List[np.ndarray] = [np.zeros(0, dtype=np.int64)] * n
    cursor = [0] * n
    prefix = [0.0] * (n + 1)
    rows: List[np.ndarray] = [np.zeros(0)] * n

    token_moves = 0
    i = 0
    rows[0] = level_costs(0, idx)
    order_stack[0] = np.argsort(rows[0], kind="stable")
    cursor[0] = 0
    status = "finished"
    t_search = time.perf_counter()
    while i >= 0:
        if timeout is not None and time.perf_counter() - t0 > timeout:
            status = "timeout"
            break
        if cursor[i] >= len(order_stack[i]):
            i -= 1  # exhausted: backtrack
            token_moves += 1
            continue
        v = int(order_stack[i][cursor[i]])
        cursor[i] += 1
        cost = prefix[i] + rows[i][v]
        if cost >= ub:  # best-first: every later value also fails
            i -= 1
            token_moves += 1
            continue
        idx[i] = v
        if i == n - 1:
            ub = cost
            best_idx = list(idx)
            continue  # keep scanning siblings (cursor already advanced)
        prefix[i + 1] = cost
        i += 1
        token_moves += 1
        rows[i] = level_costs(i, idx)
        order_stack[i] = np.argsort(rows[i], kind="stable")
        cursor[i] = 0

    from pydcop_tpu_torch.telemetry import get_tracer

    get_tracer().add_span(
        "search", "phase", t_search, time.perf_counter() - t_search,
        algo="syncbb", token_moves=token_moves,
    )
    if best_idx is None:
        return {
            "assignment": {},
            "cost": None,
            "final_assignment": {},
            "final_cost": None,
            "cycle": token_moves,
            "msg_count": token_moves,
            "msg_size": token_moves * n,
            "status": "timeout",
            "time": time.perf_counter() - t0,
            "cost_trace": [],
        }

    assignment = {
        name: domains[i][best_idx[i]] for i, name in enumerate(ordering)
    }
    cost = dcop.solution_cost(assignment)
    return {
        "assignment": assignment,
        "cost": cost,
        "final_assignment": assignment,
        "final_cost": cost,
        "cycle": token_moves,
        "msg_count": token_moves,
        "msg_size": token_moves * n,  # token carries the partial path
        "status": status,
        "time": time.perf_counter() - t0,
        "cost_trace": [cost],
    }


# -- distribution-layer footprint callbacks ------------------------------

UNIT_SIZE = 1


def computation_memory(node: _og.OrderedVariableNode) -> float:
    """Stores the current path: one value per predecessor."""
    return (node.position + 1) * UNIT_SIZE


def communication_load(
    node: _og.OrderedVariableNode, neighbor_name: str
) -> float:
    """The token: partial assignment + bound."""
    return (node.position + 2) * UNIT_SIZE
