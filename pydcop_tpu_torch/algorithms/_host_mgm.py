"""Host message-driven MGM computations (a copy of
``pydcop_tpu/algorithms/_host_mgm.py``).

Reference-shaped Maximum Gain Messages (reference:
``pydcop/algorithms/mgm.py``): one computation per variable on the
constraints hypergraph, two synchronized phases per round —

1. *value*: broadcast the current value; with every neighbor's value
   known, evaluate the best local improvement
   (gain = current cost − best candidate cost),
2. *gain*: broadcast the gain; the strict neighborhood winner (name
   tie-break) moves.

The round synchronization (tagged buffers, duplicate-broadcast guard,
isolated variables, winner rule) lives in
:class:`~pydcop_tpu_torch.algorithms._host_twophase.TwoPhaseComputation`.

Like the reference, MGM keeps exchanging messages at a fixed point
(the values simply stop changing), so runs end on the runtime's
message budget or timeout rather than by quiescence — see
``docs/termination.md``.

Implemented from scratch against the model objects (NOT the batched
kernels in ``algorithms/mgm.py``), like the other host computations.
"""

from __future__ import annotations

from typing import Any, Dict

from pydcop_tpu_torch.algorithms._host_twophase import TwoPhaseComputation


class HostMgmComputation(TwoPhaseComputation):
    def __init__(self, comp_def, seed: int = 0):
        super().__init__(comp_def, seed=seed)
        self._candidate: Any = None
        self._gain = 0.0

    def _local_cost(self, value: Any, nv: Dict[str, Any]) -> float:
        cost = self._raw_unary(value)
        for c in self._constraints:
            cost += self._constraint_cost(c, value, nv)
        return cost

    # phase 1 payload: the current value
    def initial_payload(self) -> Any:
        return self.current_value

    # all neighbor values in → gain out
    def finish_phase1(self, got: Dict[str, Any]) -> float:
        current = self._local_cost(self.current_value, got)
        best_val, best_cost = self.current_value, current
        for val in self._variable.domain.values:
            c = self._local_cost(val, got)
            if c < best_cost:
                best_val, best_cost = val, c
        self._candidate = best_val
        self._gain = current - best_cost
        return self._gain

    # all neighbor gains in → the strict winner moves
    def finish_round(self, got: Dict[str, float]) -> Any:
        if self.strict_winner(self._gain, got):
            self.value_selection(self._candidate)
        return self.current_value


def build_computation(comp_def, seed: int = 0):
    return HostMgmComputation(comp_def, seed=seed)
