"""Host message-driven DSA computations (A-DSA semantics; a copy of
``pydcop_tpu/algorithms/_host_dsa.py``).

Reference-shaped asynchronous DSA (reference:
``pydcop/algorithms/adsa.py``): one computation per variable on the
constraints hypergraph; every received neighbor-value message triggers
a local re-evaluation — change to the best value with probability
``probability`` when it improves (variant A), improves-or-ties with a
violation present (B), or always when tied (C).

Implemented from scratch against the model objects (NOT the batched
kernels in ``algorithms/dsa.py``) so the async-parity tests compare
two independent derivations.  The computation goes
quiescent at a local optimum — no messages are sent when the value
does not change — which the runtime detects as termination.
"""

from __future__ import annotations

import random
from typing import Any, Dict, Optional

from pydcop_tpu_torch.infrastructure.computations import (
    Message,
    VariableComputation,
    register,
    stable_seed,
)


class DsaValueMessage(Message):
    def __init__(self, value: Any):
        super().__init__("dsa_value", value)

    @property
    def value(self) -> Any:
        return self._content


class HostDsaComputation(VariableComputation):
    def __init__(
        self,
        comp_def,
        seed: int = 0,
        variant: Optional[str] = None,
        probability: Optional[float] = None,
    ):
        super().__init__(comp_def.node.variable, comp_def)
        self._constraints = list(comp_def.node.constraints)
        params = comp_def.algo.params
        self._p = float(
            probability
            if probability is not None
            else params.get("probability", 0.7)
        )
        self._variant = str(
            variant if variant is not None else params.get("variant", "B")
        )
        # 'max' objectives flip the comparison sign (the batched engine
        # instead negates all costs at compile time, ops/compile.py)
        self._sign = -1.0 if comp_def.algo.mode == "max" else 1.0
        self._rnd = random.Random(stable_seed(seed, self.name))
        self._neighbor_values: Dict[str, Any] = {}

    def on_start(self) -> None:
        # migration restart: resume from the pre-failure value when
        # the runtime provided one (restart_value), else random
        self.value_selection(
            self.initial_value_or(lambda: self.random_value(self._rnd))
        )
        self.post_to_all_neighbors(DsaValueMessage(self.current_value))

    def on_peer_restarted(self, peer: str) -> None:
        # a migrated neighbor starts with no view of this variable —
        # re-announce the current value to that one peer so it can
        # evaluate its constraints again (quiescence-safe: one message,
        # no loop: the peer only answers if it MOVES)
        if self.current_value is not None:
            self.post_msg(peer, DsaValueMessage(self.current_value))

    def _known_constraint_costs(self, value: Any):
        """Yield the cost of each constraint whose other variables'
        values are all known (unknown neighbors: constraint skipped, as
        the reference does before the first cycle completes)."""
        v = self._variable
        for c in self._constraints:
            assignment = {v.name: value}
            ok = True
            for d in c.dimensions:
                if d.name == v.name:
                    continue
                if d.name not in self._neighbor_values:
                    ok = False
                    break
                assignment[d.name] = self._neighbor_values[d.name]
            if ok:
                yield float(c.get_value_for_assignment(assignment))

    def _cost_of(self, value: Any) -> float:
        """Local (signed) cost of taking ``value``: lower is better
        regardless of the objective direction."""
        total = 0.0
        v = self._variable
        if v.has_cost:
            total += float(v.cost_for_val(value))
        total += sum(self._known_constraint_costs(value))
        return self._sign * total

    def _violations(self, value: Any) -> bool:
        """Any known-neighbor constraint at a non-zero cost?"""
        return any(c != 0 for c in self._known_constraint_costs(value))

    @register("dsa_value")
    def _on_value(self, sender: str, msg: DsaValueMessage, t: float) -> None:
        self._neighbor_values[sender] = msg.value
        self._evaluate()

    @register("dsa_tick")
    def _on_tick(self, sender: str, msg: Message, t: float) -> None:
        self._evaluate()

    def _evaluate(self) -> None:
        current_cost = self._cost_of(self.current_value)
        costs = {val: self._cost_of(val) for val in self._variable.domain}
        best_val = min(costs, key=costs.get)
        best_cost = costs[best_val]

        move = False
        if best_cost < current_cost:
            move = True
        elif best_cost == current_cost and best_val != self.current_value:
            if self._variant == "B":
                move = self._violations(self.current_value)
            elif self._variant == "C":
                move = True
        if not move:
            return
        if self._rnd.random() < self._p:
            self.value_selection(best_val)
            self.post_to_all_neighbors(DsaValueMessage(self.current_value))
        else:
            # the probability gate skipped a wanted move; without a new
            # neighbor message nothing would ever re-trigger evaluation
            # and the move would be lost forever.  The reference avoids
            # this with the agents' periodic-action scheduler; here a
            # self-addressed tick re-fires the evaluation later.
            self.post_msg(self.name, Message("dsa_tick"))


def build_computation(
    comp_def,
    seed: int = 0,
    variant: Optional[str] = None,
    probability: Optional[float] = None,
):
    return HostDsaComputation(
        comp_def, seed=seed, variant=variant, probability=probability
    )
