"""Compiled LOCKSTEP island for GDBA, Generalized Distributed Breakout
(port of ``pydcop_tpu/algorithms/_island_gdba.py``).

Same schedule as the MGM/DBA lockstep islands (``_island_lockstep.py``):
one batched step of the whole sub-problem on the device per GLOBAL
two-phase round.  GDBA's breakout machinery is per-CELL — weight
matrices over each constraint table, with the three generalization axes
(modifier A/M, violation NZ/NM/MX, increase_mode E/R/C/T) — and its
flags are ``(constraint, cells)`` lists whose cells are LABEL tuples in
the constraint's dimension order (``_host_gdba.py``).  The island:

- keeps one weight matrix per arity bucket (``w[k]: f32[m, d^k]``, the
  batched state layout) and applies EVERY origin's flag list
  additively at phase 0 — its own pending flags and the remote
  endpoints' — through one label→cell-index mapping, so overlapping
  masks stack exactly as in the batched round and endpoint weight
  copies stay equal across the island seam;
- runs the weighted sweep and violation detection with the batched
  round's OWN formulas (``gdba.effective_metrics`` /
  ``gdba.qlm_mask`` — shared, so the axes cannot drift);
- decides winners with the NAME-RANK priority (bit-identical to the
  host tie-break), moves owned slots only;
- for each owned variable at a quasi-local minimum, generates the
  increase-mode cell lists from THAT round's assignment (E: the
  current cell; T: the whole table; C: own axis pinned; R: co-axes
  pinned — mirroring ``_host_gdba._mask_cells``), keeps them as its
  pending flags, and ships the boundary variables' lists on the next
  ``(value, flags)`` payload.

The weights and the flag algebra stay host-side numpy, as in the JAX
island; each phase uploads the weights.  Weights only steer search;
reported costs stay raw.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from pydcop_tpu_torch.algorithms._common import EPS, strict_winner
from pydcop_tpu_torch.algorithms._island_lockstep import (
    LockstepIsland,
    LockstepProxy,
)
from pydcop_tpu_torch.algorithms.gdba import effective_metrics, qlm_mask


class GdbaIsland(LockstepIsland):
    """Lockstep GDBA phase math over the compiled sub-problem."""

    def __init__(
        self,
        var_nodes: List[Any],
        dcop,
        algo_def,
        seed: int,
        pending_fn: Optional[Callable[[], int]] = None,
        device=None,
    ):
        super().__init__(
            var_nodes, dcop, algo_def, seed,
            f"gdba_island_{seed}", pending_fn=pending_fn, device=device,
        )
        p = self._problem
        init_w = 0.0 if self._params["modifier"] == "A" else 1.0
        self._imode = str(self._params["increase_mode"])
        self._weights = {
            k: np.full(
                (bucket.n_cons, p.d_max**k), init_w, dtype=np.float32
            )
            for k, bucket in sorted(p.buckets.items())
        }
        self._bucket_scopes = {
            k: bucket.scopes.cpu().numpy()
            for k, bucket in p.buckets.items()
        }

        # constraint metadata: name -> (arity, bucket row, scope label
        # lists in dimension order).  Bucket rows follow the global
        # constraint order filtered by arity — VERIFIED against
        # con_scopes below, so a compile reorder fails loudly here
        # instead of silently mis-addressing weight cells.
        strides_np = p.con_strides.cpu().numpy()
        scopes_np = p.con_scopes.cpu().numpy()
        by_arity: Dict[int, int] = {}
        self._con_meta: Dict[str, Tuple[int, int, List[List[Any]]]] = {}
        for ci, nm in enumerate(p.con_names):
            k = int((strides_np[ci] > 0).sum())
            row = by_arity.get(k, 0)
            by_arity[k] = row + 1
            bucket_scope = self._bucket_scopes[k][row]
            assert list(bucket_scope) == list(scopes_np[ci][:k]), (
                f"bucket row order diverged from con_names order for "
                f"{nm!r} — the island's weight addressing would be "
                "wrong"
            )
            scope_labels = [
                self._labels[p.var_names[int(s)]] for s in bucket_scope
            ]
            self._con_meta[nm] = (k, row, scope_labels)
        # incident constraint names per owned variable (flag emission)
        self._incident: Dict[str, List[str]] = {
            v: [] for v in self.owned_names
        }
        for nm, (k, row, _) in self._con_meta.items():
            for s in self._bucket_scopes[k][row]:
                vn = p.var_names[int(s)]
                if vn in self._incident:
                    self._incident[vn].append(nm)

        # pending flags, host format: [(cname, [cell label tuples])]
        self._pending: List[Tuple[str, List[Tuple[Any, ...]]]] = []
        self._improve = None
        self._candidate = None
        self._edge_violated = None  # device tensor between the phases
        self._violated = {}  # k -> bool[m], pre-move assignment

    def _metrics(self, values) -> None:
        """The weighted sweep under the current weights: records the
        improves, candidates and violations of the round."""
        improve, candidate, per_bucket, edge_violated = effective_metrics(
            self._problem,
            values,
            {k: self._to_device(w) for k, w in self._weights.items()},
            self._params,
        )
        self._improve = improve.cpu().numpy().astype(np.float64)
        self._candidate = candidate.cpu().numpy()
        self._edge_violated = edge_violated
        self._violated = {
            k: violated.cpu().numpy()
            for k, (_cell, violated, _vals) in per_bucket.items()
        }

    def _decide(self, improve, candidate, values, edge_violated):
        problem = self._problem
        win = strict_winner(problem, improve, self._prio) & (improve > EPS)
        new_values = torch.where(win, candidate, values)
        qlm = qlm_mask(problem, improve, edge_violated)
        return new_values.cpu().numpy(), qlm.cpu().numpy()

    # -- flag algebra ----------------------------------------------------

    def _apply_flags(self, flag_lists) -> None:
        """Add 1 to every named cell (label tuples → flat indices)."""
        d = self._problem.d_max
        for cname, cells in flag_lists:
            meta = self._con_meta.get(cname)
            if meta is None:
                continue
            k, row, scope_labels = meta
            w = self._weights[k]
            for cell in cells:
                cell = tuple(cell)
                if len(cell) != k:
                    continue
                flat = 0
                ok = True
                for q, lab in enumerate(cell):
                    try:
                        flat += scope_labels[q].index(lab) * (
                            d ** (k - 1 - q)
                        )
                    except ValueError:
                        ok = False
                        break
                if ok:
                    w[row, flat] += 1.0

    def _mask_cells(
        self, cname: str, var: str, assignment_idx: np.ndarray
    ) -> List[Tuple[Any, ...]]:
        """The increase-mode cells for ``var`` flagging ``cname``
        under the round's assignment — label tuples, mirroring
        ``_host_gdba._mask_cells``."""
        k, row, scope_labels = self._con_meta[cname]
        scope = self._bucket_scopes[k][row]
        cur = [
            scope_labels[q][int(assignment_idx[int(scope[q])])]
            for q in range(k)
        ]
        my_pos = [
            q
            for q in range(k)
            if self._problem.var_names[int(scope[q])] == var
        ]
        if self._imode == "E":
            return [tuple(cur)]
        if self._imode == "T":
            return list(itertools.product(*scope_labels))
        axes: List[List[Any]] = []
        for q in range(k):
            if self._imode == "C":
                # own axis pinned at the current value, co-cells free
                axes.append([cur[q]] if q in my_pos else scope_labels[q])
            else:  # R: own axis free, co-vars at current values
                axes.append(scope_labels[q] if q in my_pos else [cur[q]])
        return list(itertools.product(*axes))

    def _flags_of(self, v: str, pre_move: np.ndarray):
        """``v``'s flag list at a quasi-local minimum: its violated
        incident constraints with their increase-mode cells."""
        entries = []
        for cname in self._incident[v]:
            k, row, _ = self._con_meta[cname]
            if self._violated[k][row]:
                entries.append((cname, self._mask_cells(cname, v, pre_move)))
        return entries

    # -- lockstep hooks --------------------------------------------------

    def value_payload_of(self, got_payload: Any) -> Any:
        return got_payload[0]  # (value, flags)

    def phase0_complete(
        self, got: Dict[Tuple[str, str], Any]
    ) -> Dict[str, Any]:
        self._apply_flags(self._pending)
        # got is keyed by (boundary proxy, sender): a remote
        # neighboring TWO island variables delivers its broadcast
        # payload twice — apply each SENDER's flags once, as every
        # host endpoint does, or the additive per-cell increases
        # double and the seam weight copies diverge
        seen = set()
        for (_v, u), payload in got.items():
            if u in seen:
                continue
            seen.add(u)
            self._apply_flags(payload[1])
        self._pending = []
        self._metrics(self._values_t())
        return {
            v: float(self._improve[self._slot[v]])
            for v in self._remotes_of
        }

    def phase1_complete(
        self, got: Dict[Tuple[str, str], Any]
    ) -> Dict[str, Any]:
        improve = self._improve.copy()
        for (_v, u), payload in got.items():
            improve[self._shadow_slot[u]] = float(payload)
        pre_move = self._values.copy()
        new_values, qlm = self._decide(
            self._to_device(improve.astype(np.float32)),
            self._to_device(self._candidate),
            self._values_t(),
            self._edge_violated,
        )
        self._values[self._owned_slots] = new_values[self._owned_slots]
        # each owned QLM variable flags its violated incident
        # constraints with its increase-mode cells (the round's
        # PRE-MOVE assignment, as the host does)
        flags_by_var: Dict[str, List] = {}
        for v in self.owned_names:
            if not qlm[self._slot[v]]:
                continue
            entries = self._flags_of(v, pre_move)
            if entries:
                flags_by_var[v] = entries
                self._pending.extend(entries)
        return {
            v: (
                self._labels[v][int(self._values[self._slot[v]])],
                flags_by_var.get(v, []),
            )
            for v in self._remotes_of
        }

    def next_value_payloads(self) -> Dict[str, Any]:
        return {
            v: (self._labels[v][int(self._values[self._slot[v]])], [])
            for v in self._remotes_of
        }

    def interior_round(self) -> bool:
        self._apply_flags(self._pending)
        self._pending = []
        values = self._values_t()
        self._metrics(values)
        pre_move = self._values.copy()
        new_values, qlm = self._decide(
            self._to_device(self._improve.astype(np.float32)),
            self._to_device(self._candidate),
            values,
            self._edge_violated,
        )
        self._values = new_values.astype(np.int64)
        any_flag = False
        for v in self.owned_names:
            if qlm[self._slot[v]]:
                entries = self._flags_of(v, pre_move)
                self._pending.extend(entries)
                any_flag = any_flag or bool(entries)
        any_violated = any(v.any() for v in self._violated.values())
        return bool(any_violated or any_flag)


class IslandGdbaProxy(LockstepProxy):
    pass


def build_island(
    comp_defs: List[Any],
    dcop,
    seed: int = 0,
    pending_fn: Optional[Callable[[], int]] = None,
    device=None,
) -> List[Any]:
    """Build ONE lockstep island on ``device`` (default: the CUDA
    device) + per-variable proxies for an agent's placed GDBA
    computations."""
    if not comp_defs:
        return []
    island = GdbaIsland(
        [cd.node for cd in comp_defs],
        dcop,
        comp_defs[0].algo,
        seed,
        pending_fn=pending_fn,
        device=device,
    )
    return [IslandGdbaProxy(cd, island) for cd in comp_defs]
