"""Host message-driven DBA computations (a copy of
``pydcop_tpu/algorithms/_host_dba.py``).

Reference-shaped Distributed Breakout (reference:
``pydcop/algorithms/dba.py``), sharing the batched kernel's semantics
(``algorithms/dba.py``): weighted local search with quasi-local-
minimum breakout, round-synchronized over real messages —

1. *ok?* : broadcast the current value PLUS the list of constraints
   this variable flagged for a weight increase at the END of the
   previous round.  With every neighbor's payload in, each endpoint
   first merges the flags (its own and its neighbors', OR per
   constraint) and raises each flagged incident constraint's weight
   ONCE — exactly the batched step's ``touch_qlm = any(qlm over the
   scope)`` rule, so endpoint weight copies stay equal — then
   computes its best WEIGHTED improvement,
2. *improve* : broadcast the weighted gain; the strict neighborhood
   winner moves.  A variable at a **quasi-local minimum** — some
   incident constraint violated but nobody in the closed neighborhood
   improves — flags its violated incident constraints for the next
   round's synchronized weight increase.

The round synchronization (tagged buffers, duplicate-broadcast guard,
isolated variables, winner rule) lives in
:class:`~pydcop_tpu_torch.algorithms._host_twophase.TwoPhaseComputation`.
Reported costs use the raw problem; weights only steer search.  Like
MGM, DBA keeps exchanging messages at a fixed point, so runs end on
the runtime's message budget or timeout (docs/termination.md).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

from pydcop_tpu_torch.algorithms._common import EPS
from pydcop_tpu_torch.algorithms._host_twophase import TwoPhaseComputation


class HostDbaComputation(TwoPhaseComputation):
    def __init__(self, comp_def, seed: int = 0):
        super().__init__(comp_def, seed=seed)
        self._increase = float(comp_def.algo.params.get("increase", 1.0))
        self._weights: Dict[str, float] = {
            c.name: 1.0 for c in self._constraints
        }
        self._by_name = {c.name: c for c in self._constraints}
        self._candidate: Any = None
        self._improve = 0.0
        self._violated: List[str] = []
        self._pending_flags: List[str] = []  # my QLM flags, applied
        # (merged with neighbors') at the NEXT round's value phase

    def _weighted_cost(self, value: Any, nv: Dict[str, Any]) -> float:
        cost = self._raw_unary(value)
        for c in self._constraints:
            cost += self._weights[c.name] * self._constraint_cost(
                c, value, nv
            )
        return cost

    # phase 1 payload: (value, constraint names flagged last round)
    def initial_payload(self) -> Tuple[Any, List[str]]:
        return (self.current_value, [])

    def finish_phase1(self, got: Dict[str, Any]) -> float:
        # 1. synchronized weight increase: my flags OR any neighbor's,
        # once per constraint per round (= the batched touch_qlm rule)
        flagged = set(self._pending_flags)
        for _, their_flags in got.values():
            flagged.update(
                n for n in their_flags if n in self._by_name
            )
        for name in flagged:
            self._weights[name] += self._increase
        self._pending_flags = []
        # 2. best weighted move under the neighbors' values
        values = {n: payload[0] for n, payload in got.items()}
        current = self._weighted_cost(self.current_value, values)
        best_val, best_cost = self.current_value, current
        for val in self._variable.domain.values:
            c = self._weighted_cost(val, values)
            if c < best_cost:
                best_val, best_cost = val, c
        self._candidate = best_val
        self._improve = current - best_cost
        self._violated = [
            c.name
            for c in self._constraints
            if self._constraint_cost(c, self.current_value, values) > EPS
        ]
        return self._improve

    def finish_round(self, got: Dict[str, float]) -> Tuple[Any, List[str]]:
        if self.strict_winner(self._improve, got):
            self.value_selection(self._candidate)
        elif (
            self._violated
            and self._improve <= EPS
            and all(g <= EPS for g in got.values())
        ):
            # quasi-local minimum: flag the violated incident
            # constraints — the increase lands at the start of the
            # next round, merged with every endpoint's flags
            self._pending_flags = list(self._violated)
        return (self.current_value, list(self._pending_flags))


def build_computation(comp_def, seed: int = 0):
    return HostDbaComputation(comp_def, seed=seed)
