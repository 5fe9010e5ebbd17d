"""Host message-driven GDBA computations (a copy of
``pydcop_tpu/algorithms/_host_gdba.py``).

Reference-shaped Generalized Distributed Breakout (reference:
``pydcop/algorithms/gdba.py``), sharing the batched kernel's semantics
(``algorithms/gdba.py``): per-CELL weight matrices with the three
generalization axes —

- ``modifier``  A (eff = cost + w, w init 0) / M (eff = cost · w, w
  init 1),
- ``violation`` NZ / NM / MX judged on the raw constraint table,
- ``increase_mode`` E / R / C / T selecting which weight cells grow.

Round structure is DBA's (ok?/improve on the shared
:class:`~pydcop_tpu_torch.algorithms._host_twophase.TwoPhaseComputation`
skeleton).  Weight synchronization matches the batched step's
``delta = Σ_p active_p · mask_p``: an endpoint at a quasi-local
minimum computes, per violated incident constraint, the exact CELLS
its increase-mode touches (using that round's assignment) and ships
``(constraint, cells)`` on the next round's value message; every
endpoint applies every origin's cell list additively, so endpoint
weight copies stay equal and overlapping masks stack exactly as in
the batched kernel.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Tuple

from pydcop_tpu_torch.algorithms._common import EPS
from pydcop_tpu_torch.algorithms._host_twophase import TwoPhaseComputation

Cell = Tuple[Any, ...]


class HostGdbaComputation(TwoPhaseComputation):
    def __init__(self, comp_def, seed: int = 0):
        super().__init__(comp_def, seed=seed)
        params = comp_def.algo.params
        self._modifier = str(params.get("modifier", "A"))
        self._vmode = str(params.get("violation", "NZ"))
        self._imode = str(params.get("increase_mode", "E"))
        self._w0 = 0.0 if self._modifier == "A" else 1.0
        self._by_name = {c.name: c for c in self._constraints}
        self._weights: Dict[str, Dict[Cell, float]] = {
            c.name: {} for c in self._constraints
        }
        # raw-table min/max per constraint (for NM/MX violation modes)
        self._table_minmax: Dict[str, Tuple[float, float]] = {}
        for c in self._constraints:
            costs = [
                self._sign * c.get_value_for_assignment(
                    dict(zip((d.name for d in c.dimensions), cell))
                )
                for cell in itertools.product(
                    *(d.domain.values for d in c.dimensions)
                )
            ]
            self._table_minmax[c.name] = (min(costs), max(costs))
        self._candidate: Any = None
        self._improve = 0.0
        self._violated: List[str] = []
        self._flag_values: Dict[str, Any] = {}
        self._pending_flags: List[Tuple[str, List[Cell]]] = []

    # -- weighted evaluation --------------------------------------------

    def _w(self, cname: str, cell: Cell) -> float:
        return self._weights[cname].get(cell, self._w0)

    def _cell_of(self, c, assignment: Dict[str, Any]) -> Cell:
        return tuple(assignment[d.name] for d in c.dimensions)

    def _eff_cost(self, value: Any, nv: Dict[str, Any]) -> float:
        cost = self._raw_unary(value)
        for c in self._constraints:
            assignment = {self._variable.name: value}
            for dim in c.dimensions:
                if dim.name != self._variable.name:
                    assignment[dim.name] = nv[dim.name]
            base = self._sign * c.get_value_for_assignment(assignment)
            w = self._w(c.name, self._cell_of(c, assignment))
            cost += base + w if self._modifier == "A" else base * w
        return cost

    def _is_violated(self, c, value: Any, nv: Dict[str, Any]) -> bool:
        assignment = {self._variable.name: value}
        for dim in c.dimensions:
            if dim.name != self._variable.name:
                assignment[dim.name] = nv[dim.name]
        raw = self._sign * c.get_value_for_assignment(assignment)
        tmin, tmax = self._table_minmax[c.name]
        if self._vmode == "NZ":
            return raw > EPS
        if self._vmode == "NM":
            return raw > tmin + EPS
        return raw >= tmax - EPS and tmax > tmin + EPS  # MX

    def _mask_cells(self, c, assignment: Dict[str, Any]) -> List[Cell]:
        """Cells the increase-mode touches, from THIS round's
        assignment — identical to the batched step's mask_p."""
        my = self._variable.name
        if self._imode == "E":
            return [self._cell_of(c, assignment)]
        if self._imode == "T":
            return list(
                itertools.product(
                    *(d.domain.values for d in c.dimensions)
                )
            )
        cells = []
        for cell in itertools.product(
            *(d.domain.values for d in c.dimensions)
        ):
            ok = True
            for dim, val in zip(c.dimensions, cell):
                if self._imode == "C":
                    # own axis pinned at the current value, co free
                    if dim.name == my and val != assignment[my]:
                        ok = False
                        break
                else:  # R: own axis free, co-vars at current values
                    if dim.name != my and val != assignment[dim.name]:
                        ok = False
                        break
            if ok:
                cells.append(cell)
        return cells

    # -- phases ---------------------------------------------------------

    def initial_payload(self) -> Tuple[Any, List]:
        return (self.current_value, [])

    def finish_phase1(self, got: Dict[str, Any]) -> float:
        # 1. synchronized per-cell weight increases: every origin's
        # (constraint, cells) list applies additively (batched delta
        # sums per-position masks, so overlapping masks stack)
        for cname, cells in self._pending_flags:
            wt = self._weights[cname]
            for cell in cells:
                cell = tuple(cell)
                wt[cell] = wt.get(cell, self._w0) + 1.0
        for _, their_flags in got.values():
            for cname, cells in their_flags:
                if cname not in self._by_name:
                    continue
                wt = self._weights[cname]
                for cell in cells:
                    cell = tuple(cell)
                    wt[cell] = wt.get(cell, self._w0) + 1.0
        self._pending_flags = []
        # 2. best effective move under the neighbors' values
        values = {n: payload[0] for n, payload in got.items()}
        current = self._eff_cost(self.current_value, values)
        best_val, best_cost = self.current_value, current
        for val in self._variable.domain.values:
            c = self._eff_cost(val, values)
            if c < best_cost:
                best_val, best_cost = val, c
        self._candidate = best_val
        self._improve = current - best_cost
        self._violated = [
            c.name
            for c in self._constraints
            if self._is_violated(c, self.current_value, values)
        ]
        self._flag_values = dict(values)
        return self._improve

    def finish_round(self, got: Dict[str, float]) -> Tuple[Any, List]:
        if self.strict_winner(self._improve, got):
            self.value_selection(self._candidate)
        elif (
            self._violated
            and self._improve <= EPS
            and all(g <= EPS for g in got.values())
        ):
            assignment = dict(self._flag_values)
            assignment[self._variable.name] = self.current_value
            self._pending_flags = [
                (
                    cname,
                    self._mask_cells(
                        self._by_name[cname], assignment
                    ),
                )
                for cname in self._violated
            ]
        return (self.current_value, list(self._pending_flags))


def build_computation(comp_def, seed: int = 0):
    return HostGdbaComputation(comp_def, seed=seed)
