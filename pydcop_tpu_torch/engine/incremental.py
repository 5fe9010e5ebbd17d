"""Incremental problem recompilation for dynamic runs (port of
``pydcop_tpu/engine/incremental.py``).

The dynamic engine (``engine/dynamic.py``) solves a *sequence* of
closely-related problems: each scenario event perturbs the active DCOP
(an external variable changes value, a lost variable freezes into an
external) and the next segment solves the perturbed problem.
Re-tabulating every constraint and rebuilding the whole
:class:`~pydcop_tpu_torch.ops.compile.CompiledProblem` on the host per
segment costs seconds of Python/numpy work per event on large problems.

:class:`IncrementalCompiler` removes that cost for the common cases:

- **Nothing changed** (delay events): the cached compiled problem and
  fingerprint are returned as they are: no host work, no transfers.
- **Only external VALUES changed** (``set_value`` events): the problem
  STRUCTURE (variables, scopes, shapes, static metadata) is unchanged,
  so only the constraints whose scope touches a changed external are
  re-tabulated, and their slices of ``tables_flat``, of each arity
  bucket's ``tables`` ``[m, d, …]`` and ``tables_t`` ``[d, …, d, m]``
  (written along the last axis) and the ``unary`` rows they fold into
  are written on the device with ``index_copy`` (unique indices, so the
  writes are deterministic on every device).  A touched unary row is
  folded again on the host exactly as the compiler folds it (the
  variable's own costs, then every constraint that slices onto it, in
  the problem's constraint order) and written once, however many
  updated constraints fold into it.  The JAX package adds each
  constraint's delta to the row instead (``.at[].add``), which drifts
  from a fresh compile by rounding when costs are not exact in the
  table dtype; the port's rows equal a fresh compile bit for bit, and
  the JAX package's rows wherever those do (ROADMAP.md, C,
  'Incremental unary rows').
- **Structure changed** (a variable froze, the frozen set changed): a
  full recompile, after which the edit plan is rebuilt.

Updates are functional, as in the JAX package: an update builds new
tensors for the leaves it patches (the untouched leaves are shared) and
returns a new problem, so a problem handed out by an earlier
``compile()`` stays valid and unchanged.  The copy costs one device
pass over each patched leaf (``last_update["copied_bytes"]``), which is
small against a segment's rounds.

bf16 tables (``dtype=torch.bfloat16``) take one cast of the host f32
tabulation, as the compiler does; patches go
through padded problems (``pad_policy``) unchanged, since the ghost
rows are never part of the plan.  Any bucket with a shared table turns
incremental updates off (a patch would change every constraint that
shares it): such problems recompile in full, as in the JAX package.

Fingerprints: full compiles hash the compiled arrays
(:func:`~pydcop_tpu_torch.ops.compile.problem_fingerprint`); incremental
updates derive the fingerprint from the base hash + the *effective*
external values (those actually read by some constraint), so delay
segments and no-op ``set_value`` events keep the fingerprint stable and
the engine's full-state carry intact.  Both equal the JAX package's.

Telemetry counters: ``compile.full``, ``compile.incremental``,
``compile.reused``; an ``incremental-update`` span per update.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.dcop.objects import ExternalVariable
from pydcop_tpu_torch.device import DeviceLike, resolve_device
from pydcop_tpu_torch.ops.compile import (
    BIG,
    CompiledProblem,
    _float_tensor,
    _tabulate_padded,
    compile_dcop,
    problem_fingerprint,
)


class IncrementalCompiler:
    """Compile the active problem of a dynamic run, reusing work
    across segments (see module docstring).

    ``compile(frozen, ext_overrides)`` returns ``(problem,
    fingerprint)`` for the current run state, or ``(None, None)`` when
    every variable is frozen/external.  Problems are never written in
    place: a later ``compile()`` returns a new problem and leaves the
    earlier ones as they were.  ``last_update`` describes the last
    incremental update (constraints re-tabulated, bytes written, bytes
    copied).
    """

    def __init__(
        self,
        dcop: DCOP,
        n_shards: int = 1,
        pad_policy="none",
        dtype: torch.dtype = torch.float32,
        device: DeviceLike = None,
    ):
        self.dcop = dcop
        self.n_shards = n_shards
        self.pad_policy = pad_policy
        self.dtype = dtype
        self.device = resolve_device(device)
        self._sign = -1.0 if dcop.objective == "max" else 1.0
        self._frozen_key: Optional[frozenset] = None
        self._problem: Optional[CompiledProblem] = None
        self._base_fp: Optional[str] = None
        self._fp: Optional[str] = None
        self._ext_state: Dict[str, Any] = {}
        # edit plan: per tracked constraint name, how its current
        # realization lands in the compiled arrays
        self._plan: Dict[str, Dict[str, Any]] = {}
        self._ext_to_cons: Dict[str, List[str]] = {}
        # per unary slot a tracked constraint folds into: how the
        # compiler folds the row (the variable, then each constraint
        # that slices onto it: a tracked name, or a fixed table)
        self._rows: Dict[int, Dict[str, Any]] = {}
        # incremental updates need the single-shard arity-major layout
        # and per-constraint (non-shared) tables
        self._incremental_ok = False
        self.last_update: Dict[str, int] = {}

    # -- public --------------------------------------------------------

    def compile(
        self,
        frozen: Mapping[str, Any],
        ext_overrides: Mapping[str, Any],
    ) -> Tuple[Optional[CompiledProblem], Optional[str]]:
        from pydcop_tpu_torch.telemetry import get_metrics, get_tracer

        met = get_metrics()
        ext_values = {
            name: ext_overrides.get(name, ev.value)
            for name, ev in self.dcop.external_variables.items()
        }
        fkey = frozenset(frozen.items())
        if self._problem is not None and fkey == self._frozen_key:
            changed = {
                n
                for n, v in ext_values.items()
                if self._ext_state.get(n) != v
            }
            if not changed:
                if met.enabled:
                    met.inc("compile.reused")
                return self._problem, self._fp
            if self._incremental_ok:
                affected = sorted(
                    {
                        cn
                        for e in changed
                        for cn in self._ext_to_cons.get(e, ())
                    }
                )
                if not affected:
                    # the changed externals feed no compiled constraint
                    # (fully-external ones are dropped by the compiler):
                    # arrays and fingerprint are untouched, a pure
                    # reuse, and the state carry survives
                    self._ext_state = ext_values
                    if met.enabled:
                        met.inc("compile.reused")
                    return self._problem, self._fp
                t0 = time.perf_counter()
                n_updates = self._apply_updates(
                    affected, {**ext_values, **frozen}
                )
                self._ext_state = ext_values
                self._fp = self._fingerprint(ext_values)
                if met.enabled:
                    met.inc("compile.incremental")
                tr = get_tracer()
                if tr.enabled:
                    tr.add_span(
                        "incremental-update", "compile", t0,
                        time.perf_counter() - t0,
                        constraints=n_updates,
                    )
                return self._problem, self._fp
        # structure changed (or first call, or incremental unsupported):
        # full rebuild
        problem = self._full_compile(frozen, ext_values)
        if problem is None:
            return None, None
        if met.enabled:
            met.inc("compile.full")
        return self._problem, self._fp

    # -- full compile + plan build -------------------------------------

    def _active_dcop(
        self, frozen: Mapping[str, Any], ext_values: Mapping[str, Any]
    ) -> DCOP:
        """The currently-solvable problem: frozen variables become
        external (constant at their last value), external overrides
        applied."""
        d = DCOP(self.dcop.name, objective=self.dcop.objective)
        for v in self.dcop.variables.values():
            if v.name in frozen:
                d.add_variable(
                    ExternalVariable(v.name, v.domain, frozen[v.name])
                )
            else:
                d.add_variable(v)
        for ev in self.dcop.external_variables.values():
            d.add_variable(
                ExternalVariable(ev.name, ev.domain, ext_values[ev.name])
            )
        for c in self.dcop.constraints.values():
            d.add_constraint(c)
        return d

    def _full_compile(
        self, frozen: Mapping[str, Any], ext_values: Dict[str, Any]
    ) -> Optional[CompiledProblem]:
        ad = self._active_dcop(frozen, ext_values)
        if not ad.variables:
            # everything frozen/external: nothing to solve
            self._problem = None
            self._frozen_key = None
            return None
        problem = compile_dcop(
            ad,
            dtype=self.dtype,
            n_shards=self.n_shards,
            pad_policy=self.pad_policy,
            device=self.device,
        )
        self._problem = problem
        self._frozen_key = frozenset(frozen.items())
        self._ext_state = dict(ext_values)
        self._base_fp = problem_fingerprint(problem)
        self._build_plan(problem, frozen, ext_values)
        self._fp = self._fingerprint(ext_values)
        return problem

    def _build_plan(
        self,
        problem: CompiledProblem,
        frozen: Mapping[str, Any],
        ext_values: Mapping[str, Any],
    ) -> None:
        """Record, for every constraint touching a DECLARED external
        variable, where its current realization lives in the compiled
        arrays.  Frozen variables never change value within a
        structure, so frozen-only constraints are static here."""
        self._plan = {}
        self._ext_to_cons = {}
        self._rows = {}
        self._incremental_ok = self.n_shards <= 1 and not any(
            b.shared_table for b in problem.buckets.values()
        )
        if not self._incremental_ok:
            return
        declared = set(self.dcop.external_variables)
        full_ext = {**ext_values, **frozen}
        d_max = problem.d_max
        con_idx = {name: i for i, name in enumerate(problem.con_names)}
        # arity-major layout: bucket row of constraint ci with arity k
        # is ci - (index of the first arity-k constraint)
        arity_base: Dict[int, int] = {}
        base = 0
        for k in sorted(problem.buckets):
            arity_base[k] = base
            base += problem.buckets[k].n_cons
        con_offset = problem.con_offset.cpu().numpy()
        var_slot = {
            name: i
            for i, name in enumerate(
                problem.var_names[: problem.n_real_vars]
            )
        }

        for cname, c in self.dcop.constraints.items():
            scope = list(c.scope_names)
            hot = [n for n in scope if n in declared]
            if not hot:
                continue
            scope_ext = [n for n in scope if n in full_ext]
            live = [n for n in scope if n not in full_ext]
            entry: Dict[str, Any] = {"ext": scope_ext}
            if not live:
                # fully-external constraint: the compiler drops it, so
                # its externals never touch the compiled arrays; keep
                # it OUT of _ext_to_cons or a set_value on one would
                # churn the fingerprint (and drop the state carry) over
                # byte-identical arrays
                continue
            elif len(live) == 1:
                slot = var_slot[live[0]]
                entry["kind"] = "unary"
                entry["slot"] = slot
                entry["table"] = self._tabulate(c, scope_ext, full_ext, d_max)
            else:
                ci = con_idx[cname]
                k = len(live)
                entry["kind"] = "multi"
                entry["ci"] = ci
                entry["k"] = k
                entry["offset"] = int(con_offset[ci])
                entry["row"] = ci - arity_base[k]
            self._plan[cname] = entry
            for n in hot:
                self._ext_to_cons.setdefault(n, []).append(cname)
        # the fold of every unary row a tracked constraint lands on
        for entry in self._plan.values():
            if entry["kind"] == "unary":
                self._rows.setdefault(entry["slot"], {"folds": []})
        if not self._rows:
            return
        slot_of = {var_slot[n]: n for n in var_slot}
        for cname, c in self.dcop.constraints.items():
            live = [n for n in c.scope_names if n not in full_ext]
            if len(live) == 1 and var_slot[live[0]] in self._rows:
                slot = var_slot[live[0]]
                if cname in self._plan:
                    fold = cname
                else:
                    ext = [n for n in c.scope_names if n in full_ext]
                    fold = self._tabulate(c, ext, full_ext, d_max)
                self._rows[slot]["folds"].append(fold)
        for slot, row in self._rows.items():
            v = self.dcop.variables[slot_of[slot]]
            base = np.zeros(d_max, dtype=np.float32)
            dlen = len(v.domain)
            if v.has_cost:
                for k in range(dlen):
                    base[k] = self._sign * v.cost_for_val(v.domain[k])
            base[dlen:] = BIG
            row["base"] = base
            row["dlen"] = dlen

    # -- incremental update --------------------------------------------

    def _tabulate(
        self, c, scope_ext, full_ext: Mapping[str, Any], d_max: int
    ) -> np.ndarray:
        sliced = c.slice({n: full_ext[n] for n in scope_ext})
        return _tabulate_padded(sliced, d_max) * self._sign

    def _apply_updates(
        self, names: List[str], full_ext: Dict[str, Any]
    ) -> int:
        p = self._problem
        dev = p.device
        d_max = p.d_max
        # gather every edit on the host, then write each patched leaf
        # once (one index_copy per leaf)
        flat_idx: List[np.ndarray] = []
        flat_val: List[np.ndarray] = []
        unary_slots: Dict[int, None] = {}  # touched rows, in order
        brow_updates: Dict[int, Tuple[List[int], List[np.ndarray]]] = {}
        n_updates = 0
        for cname in names:
            entry = self._plan[cname]
            c = self.dcop.constraints[cname]
            tbl = self._tabulate(c, entry["ext"], full_ext, d_max)
            n_updates += 1
            if entry["kind"] == "unary":
                unary_slots[entry["slot"]] = None
                entry["table"] = tbl
            else:
                size = d_max ** entry["k"]
                flat_idx.append(
                    np.arange(
                        entry["offset"],
                        entry["offset"] + size,
                        dtype=np.int64,
                    )
                )
                flat_val.append(tbl.reshape(-1))
                rows, tbls = brow_updates.setdefault(
                    entry["k"], ([], [])
                )
                rows.append(entry["row"])
                tbls.append(tbl)

        written = copied = 0

        def patch(leaf: torch.Tensor, dim: int, idx, values: torch.Tensor):
            nonlocal written, copied
            written += values.numel() * values.element_size()
            copied += leaf.numel() * leaf.element_size()
            return leaf.index_copy(
                dim, torch.as_tensor(idx, dtype=torch.long, device=dev),
                values,
            )

        tables_flat = p.tables_flat
        unary = p.unary
        if flat_idx:
            tables_flat = patch(
                tables_flat, 0, np.concatenate(flat_idx),
                _float_tensor(np.concatenate(flat_val), tables_flat.dtype,
                              dev),
            )
        if unary_slots:
            # each touched row folded again as the compiler folds it
            slots = list(unary_slots)
            rows = np.stack([self._fold_row(s) for s in slots])
            unary = patch(unary, 0, slots,
                          _float_tensor(rows, unary.dtype, dev))
        buckets = dict(p.buckets)
        for k, (rows, tbls) in brow_updates.items():
            b = buckets[k]
            stack = np.stack(tbls)
            buckets[k] = dataclasses.replace(
                b,
                tables=patch(
                    b.tables, 0, rows,
                    _float_tensor(stack, b.tables.dtype, dev),
                ),
                tables_t=patch(
                    b.tables_t, b.tables_t.dim() - 1, rows,
                    _float_tensor(np.moveaxis(stack, 0, -1),
                                  b.tables_t.dtype, dev),
                ),
            )
        self._problem = dataclasses.replace(
            p, unary=unary, tables_flat=tables_flat, buckets=buckets
        )
        self.last_update = {
            "constraints": n_updates,
            "written_bytes": written,
            "copied_bytes": copied,
        }
        return n_updates

    def _fold_row(self, slot: int) -> np.ndarray:
        """Unary row ``slot`` as ``compile_dcop`` folds it: the
        variable's own costs, then each constraint that slices onto it,
        in constraint order, added in f32."""
        row = self._rows[slot]
        out = row["base"].copy()
        dlen = row["dlen"]
        for fold in row["folds"]:
            tbl = self._plan[fold]["table"] if isinstance(fold, str) else fold
            out[:dlen] += tbl[:dlen]
        return out

    # -- fingerprint ---------------------------------------------------

    def _fingerprint(self, ext_values: Mapping[str, Any]) -> str:
        """Stable id of the current problem CONTENT: the base compile's
        array hash + the effective external values.  Externals no
        constraint reads are excluded, so changing them never breaks
        the engine's full-state carry."""
        effective = sorted(
            (n, v)
            for n, v in ext_values.items()
            if n in self._ext_to_cons
        )
        h = hashlib.sha256(self._base_fp.encode())
        h.update(repr(effective).encode())
        return h.hexdigest()[:16]
