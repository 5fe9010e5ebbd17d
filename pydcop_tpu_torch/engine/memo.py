"""Subtree-fingerprint message memoization: the O(delta) re-solve path
of serving sessions (port of ``pydcop_tpu/engine/memo.py``).

A ``set_values`` delta touches a handful of constraints, and a
bucket-tree UTIL/contraction message depends ONLY on its subtree:
``msg(v) = ⊕-project( ⊗ own parts(v) ⊗ children msgs )``.  So a node
whose subtree saw no touched constraint reproduces its previous message
bit for bit.

:class:`SweepMemo` stores per-node messages in a bytes-bounded LRU keyed
by a **subtree fingerprint**: the tuple of effective external values the
node's subtree depends on.  A re-solve then re-contracts ONLY the dirty
root-to-changed-constraint path; every other node is a memo hit that
reinstalls the stored message (exact f64 values + certificate metadata
for idempotent ⊕, the CUMULATIVE subtree error bound for logsumexp — so
the dirty path re-accounts only its own error).

The JAX package also pre-compiles, after a cold solve, the stack-height-1
XLA executable of every level-pack kernel the sweep used, so a warm
delta compiles nothing.  The port compiles no XLA program, so
:meth:`SweepMemo.prewarm` is a counted no-op: it keeps the method and
its return count, which is 0 (ROADMAP C, 'Memo prewarm').

Two session front-ends wrap the machinery:

- :class:`ExactSession` — DPOP (``algorithms/dpop.py``): memoized UTIL
  sweeps, previous-solution incumbent seeding for the bnb kernels, the
  DPOP result dicts.
- :class:`InferSession` — the semiring engine
  (``ops/semiring.py:contract_sweep``): memoized contraction sweeps for
  ``map`` / ``log_z`` / ``marginals`` / ``kbest:<k>`` queries.

Both take ``device`` (the CUDA device unless ``"cpu"`` is passed) for
their device contractions.

Telemetry: ``engine.memo_hits`` (nodes reused),
``engine.memo_recontractions`` (nodes re-contracted and re-stored),
``engine.memo_evictions`` (entries dropped by the bytes bound).
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

#: default per-session memo bound — a few thousand small UTIL tables;
#: large-separator trees evict LRU (the deep entries near the root,
#: which are also the cheapest to re-contract, evict last because the
#: sweep touches them last)
DEFAULT_MEMO_BYTES = 64 << 20


def _nbytes(obj: Any) -> int:
    """Recursive payload size estimate (arrays dominate; container
    overhead is charged a flat word per element)."""
    if isinstance(obj, np.ndarray):
        return int(obj.nbytes)
    from pydcop_tpu_torch.ops.sparse import SparseTable

    if isinstance(obj, SparseTable):
        # charge the PACKED footprint — memoizing a sparse message at
        # its dense box size would evict the very entries the format
        # exists to keep
        return int(obj.nbytes)
    if isinstance(obj, (tuple, list)):
        return 16 + sum(_nbytes(x) for x in obj)
    if isinstance(obj, dict):
        return 16 + sum(
            _nbytes(k) + _nbytes(v) for k, v in obj.items()
        )
    if isinstance(obj, str):
        return 48 + len(obj)
    return 32


class SweepMemo:
    """Bounded per-session store of per-node sweep messages (module
    docstring).

    ``max_bytes <= 0`` disables the memo entirely: :meth:`begin`
    returns None and the sweeps run exactly as before."""

    def __init__(self, max_bytes: int = DEFAULT_MEMO_BYTES):
        self.max_bytes = int(max_bytes)
        # name -> (fingerprint, payload, nbytes); OrderedDict = LRU
        self._entries: "OrderedDict[str, Tuple[tuple, Any, int]]" = (
            OrderedDict()
        )
        self._bytes = 0
        self.evictions = 0

    @property
    def enabled(self) -> bool:
        return self.max_bytes > 0

    def begin(
        self, fps: Mapping[str, tuple]
    ) -> Optional["SweepMemoView"]:
        """A per-solve view bound to the solve's current per-node
        subtree fingerprints; None when the memo is disabled."""
        if not self.enabled:
            return None
        return SweepMemoView(self, dict(fps))

    # -- store ------------------------------------------------------------

    def _get(self, name: str, fp: tuple):
        ent = self._entries.get(name)
        if ent is None or ent[0] != fp:
            return None
        self._entries.move_to_end(name)
        return ent[1]

    def _put(self, name: str, fp: tuple, payload: Any) -> None:
        old = self._entries.pop(name, None)
        if old is not None:
            self._bytes -= old[2]
        nb = _nbytes(payload)
        if nb > self.max_bytes:
            return  # one oversized table must not flush the session
        self._entries[name] = (fp, payload, nb)
        self._bytes += nb
        if self._bytes > self.max_bytes:
            from pydcop_tpu_torch.telemetry import get_metrics

            met = get_metrics()
            while self._bytes > self.max_bytes and self._entries:
                _, (_, _, enb) = self._entries.popitem(last=False)
                self._bytes -= enb
                self.evictions += 1
                if met.enabled:
                    met.inc("engine.memo_evictions")

    def prewarm(self, heights: Sequence[int] = (1,)) -> int:
        """The JAX package's post-solve pre-compile of the 1-row
        kernels.  The port compiles nothing ahead of a dispatch, so
        there is nothing to run: returns the number of kernel
        executions performed, 0."""
        return 0


class SweepMemoView:
    """One solve's window onto a :class:`SweepMemo`: lookups compare
    against THIS solve's fingerprints; stores record them."""

    __slots__ = ("memo", "fps", "hits", "stores")

    def __init__(self, memo: SweepMemo, fps: Dict[str, tuple]):
        self.memo = memo
        self.fps = fps
        self.hits = 0
        self.stores = 0

    def lookup(self, name: str):
        """The stored payload when the node's subtree fingerprint is
        unchanged, else None.  Does NOT count the hit — the sweep
        counts via :meth:`mark_hit` only once it decides the entry is
        reusable (bnb budget dominance can still reject it)."""
        fp = self.fps.get(name)
        if fp is None:
            return None
        return self.memo._get(name, fp)

    def mark_hit(self) -> None:
        self.hits += 1
        from pydcop_tpu_torch.telemetry import get_metrics

        met = get_metrics()
        if met.enabled:
            met.inc("engine.memo_hits")

    def store(self, name: str, payload: Any) -> None:
        fp = self.fps.get(name)
        if fp is None:
            return
        self.stores += 1
        self.memo._put(name, fp, payload)
        from pydcop_tpu_torch.telemetry import get_metrics

        met = get_metrics()
        if met.enabled:
            met.inc("engine.memo_recontractions")


def subtree_deps(
    names: Sequence[str],
    children: Mapping[str, Sequence[str]],
    own_deps: Mapping[str, set],
) -> Dict[str, Tuple[str, ...]]:
    """Per-node sorted tuple of external variables its SUBTREE depends
    on — the fingerprint key structure (fixed per session; only the
    values vary).  ``names`` lists parents before children (pre-order
    / reversed elimination order)."""
    deps: Dict[str, Tuple[str, ...]] = {}
    for n in reversed(list(names)):  # children before parents
        s = set(own_deps.get(n, ()))
        for c in children.get(n, ()):
            s.update(deps[c])
        deps[n] = tuple(sorted(s))
    return deps


def fingerprints(
    deps: Mapping[str, Tuple[str, ...]],
    ext_values: Mapping[str, Any],
) -> Dict[str, tuple]:
    """The per-node fingerprints at the given effective external
    values: a node with no subtree externals gets the empty tuple —
    a permanent hit after the cold solve; an A→B→A value flip
    re-hits the A entry (value-keyed, not version-keyed)."""
    return {
        n: tuple(repr(ext_values.get(e)) for e in d)
        for n, d in deps.items()
    }


def _ext_scope(dcop, cname: str) -> List[str]:
    ext = dcop.external_variables
    return [
        n for n in dcop.constraints[cname].scope_names if n in ext
    ]


def _clone_dcop(dcop):
    """A private copy whose externals the session may mutate (the
    session's effective values feed ``solution_cost``); sessions fed
    an unclonable in-process dcop fall back to mutating the shared
    object — the same values the caller streamed in, so the shared
    state stays consistent with the session."""
    import copy

    try:
        return copy.deepcopy(dcop)
    except Exception:  # noqa: BLE001 — exotic constraint closures
        return dcop


class ExactSession:
    """A pinned DPOP instance with memoized UTIL sweeps: ``solve``
    after ``set_values`` re-contracts only the dirty
    root-to-changed-constraint path (module docstring) and seeds the
    bnb incumbent from the previous solution so re-contracted nodes
    prune harder.

    ``memory_bound`` / ``max_util_bytes`` params route to the plain
    :func:`~pydcop_tpu_torch.algorithms.dpop.solve_host` (their sweeps
    are dependent pass/lane sequences the per-node memo does not
    model), as do sparse ``table_format`` solves.  The device joins run
    on ``device`` (the CUDA device unless ``"cpu"`` is passed).
    """

    def __init__(
        self,
        dcop,
        pad_policy: Any = None,
        memo_bytes: int = DEFAULT_MEMO_BYTES,
        clone: bool = True,
        device: Any = None,
    ):
        from pydcop_tpu_torch.algorithms import dpop as _dpop
        from pydcop_tpu_torch.device import resolve_device
        from pydcop_tpu_torch.ops.padding import as_pad_policy

        self._dpop = _dpop
        self.device = resolve_device(device)
        self.dcop = _clone_dcop(dcop) if clone else dcop
        self.pad = as_pad_policy(pad_policy)
        self.sign = -1.0 if self.dcop.objective == "max" else 1.0
        prov: Dict[str, Tuple[str, int]] = {}
        (
            self.graph, self.domains, self.depth, self.owned,
        ) = _dpop._prepare_instance(self.dcop, provenance=prov)
        self.prov = prov
        self.cons_ext = {
            cn: _ext_scope(self.dcop, cn) for cn in prov
        }
        own: Dict[str, set] = {n: set() for n in self.domains}
        for cn, (owner, _i) in prov.items():
            own[owner].update(self.cons_ext[cn])
        self.names = [
            n
            for r in self.graph.roots
            for n in self.graph.depth_first_order(r)
        ]
        self.deps = subtree_deps(
            self.names,
            {
                n: list(self.graph.node(n).children)
                for n in self.names
            },
            own,
        )
        self.memo = SweepMemo(memo_bytes)
        self.seed: Optional[Dict[str, int]] = None
        self.solves = 0
        self.last_memo: Dict[str, int] = {}

    def set_values(self, values: Mapping[str, Any]) -> List[str]:
        """Apply external-variable deltas (a partial or full
        {external: value} map) and re-tabulate ONLY the touched
        constraints, in place.  Returns the touched constraint
        names."""
        evs = self.dcop.external_variables
        changed = []
        for name, val in values.items():
            ev = evs.get(name)
            if ev is None:
                raise ValueError(
                    f"set_values names {name!r} — not an external "
                    "variable of this session's dcop"
                )
            if ev.value != val:
                ev.value = val  # validates against the domain
                changed.append(name)
        if not changed:
            return []
        cs = set(changed)
        ext_now = {n: ev.value for n, ev in evs.items()}
        touched = [
            cn
            for cn in self.prov
            if cs.intersection(self.cons_ext[cn])
        ]
        for cn in touched:
            c = self.dcop.constraints[cn]
            c2 = c.slice(
                {e: ext_now[e] for e in self.cons_ext[cn]}
            )
            scope = list(c2.scope_names)
            table = self.sign * np.asarray(
                c2.as_matrix().matrix, dtype=np.float64
            )
            owner, idx = self.prov[cn]
            self.owned[owner][idx] = (scope, table)
        return touched

    def solve(
        self,
        params: Optional[Mapping[str, Any]] = None,
        timeout: Optional[float] = None,
        max_util_size: int = 1 << 26,
    ) -> Dict[str, Any]:
        t0 = time.perf_counter()
        _dpop = self._dpop
        params = dict(params or {})
        if (
            int(params.get("memory_bound", 0) or 0)
            or int(params.get("max_util_bytes", 0) or 0)
            # sparse solves run the planner sweep (unmemoized) —
            # algorithms/dpop.py routes them to ops/membound.py
            or params.get("table_format", "dense") != "dense"
        ):
            return _dpop.solve_host(
                self.dcop, params, timeout=timeout,
                max_util_size=max_util_size, pad_policy=self.pad,
                device=self.device,
            )
        dmc = _dpop._resolve_device_min_cells(params)
        level_sync = params.get("util_batch", "level") != "node"
        from pydcop_tpu_torch.ops import semiring as _sr

        bnb = _sr.as_bnb(params.get("bnb"), "auto")
        table_dtype = _sr.as_table_dtype(params.get("table_dtype"))
        ext_now = {
            n: ev.value
            for n, ev in self.dcop.external_variables.items()
        }
        view = self.memo.begin(fingerprints(self.deps, ext_now))
        t_util = time.perf_counter()
        outs = _dpop._util_phase_multi(
            [
                _dpop._UtilInstance(
                    self.graph, self.domains, self.depth, self.owned,
                    dmc, table_dtype=table_dtype, bnb=bnb, memo=view,
                    bnb_seed=self.seed,
                )
            ],
            t0, timeout, self.device, max_util_size=max_util_size,
            pad=self.pad, level_sync=level_sync,
        )
        if outs is None:
            return _dpop._timeout_result(self.dcop, t0)
        (best_choice, cells, dev_nodes, host_nodes,
         dispatches) = outs[0]
        assignment = _dpop._value_phase(
            self.graph, self.domains, best_choice
        )
        result = _dpop._assemble_result(
            self.dcop, self.graph, self.domains, self.depth,
            assignment,
            {
                "util_time": time.perf_counter() - t_util,
                "util_backend": (
                    "device" if dmc is not None else "host"
                ),
                "util_cells": cells,
                "util_device_nodes": dev_nodes,
                "util_host_nodes": host_nodes,
                "util_dispatches": dispatches,
            },
            t0, 1,
        )
        self.last_memo = {
            "nodes": len(self.names),
            "hits": view.hits if view is not None else 0,
            "recontracted": (
                view.stores if view is not None else len(self.names)
            ),
            "evictions": self.memo.evictions,
        }
        result["memo"] = dict(self.last_memo)
        # the next solve's bnb incumbent: this solution re-evaluated
        # under the post-delta tables is a valid bound (it IS an
        # assignment), and usually a near-optimal one
        self.seed = {
            n: self.domains[n].index(v)
            for n, v in assignment.items()
        }
        self.solves += 1
        return result


class InferSession:
    """A pinned inference instance (``ops/semiring.py``; the device
    contractions run on ``torch_device``) with
    memoized contraction sweeps — ``map`` / ``log_z`` / ``marginals``
    / ``kbest:<k>`` follow-ups after ``set_values`` re-contract only
    the dirty path.  BnB-pruned instances run UNMEMOIZED sweeps (a
    budget-pruned message depends on the global incumbent, not just
    the subtree — ``contract_sweep`` drops the memo when it builds a
    pruning context for the instance)."""

    def __init__(
        self,
        dcop,
        query: str,
        *,
        order: str = "pseudo_tree",
        beta: float = 1.0,
        tol: float = 1e-6,
        device: str = "auto",
        device_min_cells: int = 1 << 14,
        pad_policy: Any = None,
        max_table_size: int = 1 << 26,
        bnb: str = "auto",
        table_dtype: str = "f32",
        table_format: str = "dense",
        memo_bytes: int = DEFAULT_MEMO_BYTES,
        clone: bool = True,
        torch_device: Any = None,
    ):
        from pydcop_tpu_torch.device import resolve_device
        from pydcop_tpu_torch.ops import semiring as _sr
        from pydcop_tpu_torch.ops.sparse import as_table_format as _as_fmt

        self._sr = _sr
        qkind, _ = _sr.parse_query(query)
        if qkind in ("marginal_map", "expectation"):
            raise ValueError(
                f"query {query!r} has no memoized session path — "
                "its plan carries query-specific structure "
                "(map_vars / external distributions); use "
                "api.infer per call"
            )
        self.dcop = _clone_dcop(dcop) if clone else dcop
        self.query = query
        self.kw = dict(
            order=order, beta=beta, tol=tol, device=device,
            device_min_cells=device_min_cells,
            pad_policy=pad_policy, max_table_size=max_table_size,
            bnb=bnb,
            table_dtype=_sr.as_table_dtype(table_dtype),
            table_format=_as_fmt(table_format),
            torch_device=resolve_device(torch_device),
        )
        self.sign = -1.0 if self.dcop.objective == "max" else 1.0
        prov: Dict[str, Any] = {}
        self.plan = _sr.build_plan(
            self.dcop, order=order, provenance=prov
        )
        self.prov = prov
        self.cons_ext = {
            cn: _ext_scope(self.dcop, cn) for cn in prov
        }
        # fully-external constraints fold into const_energy — track
        # their identities so a delta re-folds the constant exactly
        self.const_cons = [
            cn for cn, p in prov.items() if p[0] == "const"
        ]
        self.base_const = self.plan.const_energy - sum(
            self._const_val(cn) for cn in self.const_cons
        )
        own: Dict[str, set] = {
            n: set() for n in self.plan.order
        }
        for cn, p in prov.items():
            if p[0] != "const":
                own[p[0]].update(self.cons_ext[cn])
        self.deps = subtree_deps(
            list(reversed(self.plan.order)),  # parents first
            self.plan.children, own,
        )
        self.memo = SweepMemo(memo_bytes)
        self.solves = 0
        self.last_memo: Dict[str, int] = {}

    def _const_val(self, cn: str) -> float:
        evs = self.dcop.external_variables
        c = self.dcop.constraints[cn]
        c2 = c.slice(
            {
                e: evs[e].value
                for e in c.scope_names
                if e in evs
            }
        )
        return self.sign * float(
            np.asarray(c2.as_matrix().matrix, dtype=np.float64)
        )

    def set_values(self, values: Mapping[str, Any]) -> List[str]:
        evs = self.dcop.external_variables
        changed = []
        for name, val in values.items():
            ev = evs.get(name)
            if ev is None:
                raise ValueError(
                    f"set_values names {name!r} — not an external "
                    "variable of this session's dcop"
                )
            if ev.value != val:
                ev.value = val
                changed.append(name)
        if not changed:
            return []
        cs = set(changed)
        ext_now = {n: ev.value for n, ev in evs.items()}
        touched = [
            cn
            for cn in self.prov
            if cs.intersection(self.cons_ext[cn])
        ]
        refold = False
        for cn in touched:
            kind = self.prov[cn][0]
            if kind == "const":
                refold = True
                continue
            owner, idx = self.prov[cn]
            c = self.dcop.constraints[cn]
            c2 = c.slice(
                {e: ext_now[e] for e in self.cons_ext[cn]}
            )
            scope = list(c2.scope_names)
            table = self.sign * np.asarray(
                c2.as_matrix().matrix, dtype=np.float64
            )
            self.plan.buckets[owner][idx] = (scope, table)
        if refold:
            self.plan.const_energy = self.base_const + sum(
                self._const_val(cn) for cn in self.const_cons
            )
        return touched

    def solve(
        self, timeout: Optional[float] = None
    ) -> Dict[str, Any]:
        ext_now = {
            n: ev.value
            for n, ev in self.dcop.external_variables.items()
        }
        view = self.memo.begin(fingerprints(self.deps, ext_now))
        out = self._sr.run_infer_many(
            [self.dcop], self.query, timeout=timeout,
            _plans=[self.plan], _memos=[view], **self.kw
        )[0]
        self.last_memo = {
            "nodes": len(self.plan.order),
            "hits": view.hits if view is not None else 0,
            "recontracted": (
                view.stores
                if view is not None
                else len(self.plan.order)
            ),
            "evictions": self.memo.evictions,
        }
        out["memo"] = dict(self.last_memo)
        self.solves += 1
        return out
