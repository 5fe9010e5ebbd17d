"""Host message-driven Max-Sum computations (A-Max-Sum semantics; a
copy of ``pydcop_tpu/algorithms/_host_maxsum.py``).

This is the reference-shaped asynchronous Max-Sum (reference:
``pydcop/algorithms/amaxsum.py`` + ``maxsum.py``): one computation per
variable and per factor, each reacting to every incoming cost message
independently — no round barrier.  It is intentionally implemented
from scratch against the model objects (relations, variables), NOT
against the batched kernels in ``algorithms/maxsum.py``, so the
async-parity tests compare two independent derivations of the
algorithm.

Stability-based termination as in the reference: a computation only
re-sends a message when it differs from the last sent one by more than
``STABILITY`` — once all messages are stable the system goes quiescent
and the runtime detects termination.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, Optional

from pydcop_tpu_torch.infrastructure.computations import (
    DcopComputation,
    Message,
    VariableComputation,
    register,
)

# must stay well below the symmetry-breaking noise scale (the `noise`
# algo param, default 1e-3), or tie-breaking differences are suppressed
# as "stable" and message propagation dies on cost-free problems
STABILITY = 1e-6


class MaxSumCostMessage(Message):
    """costs: {value: cost} — a cost vector over the target's domain."""

    def __init__(self, costs: Dict[Any, float]):
        super().__init__("maxsum_costs", dict(costs))

    @property
    def costs(self) -> Dict[Any, float]:
        return self._content

    @property
    def size(self) -> int:
        return len(self._content)


def _stable(
    new: Dict[Any, float], old: Optional[Dict[Any, float]]
) -> bool:
    if old is None or set(new) != set(old):
        return False
    return all(abs(new[k] - old[k]) <= STABILITY for k in new)


def _normalize(costs: Dict[Any, float]) -> Dict[Any, float]:
    m = min(costs.values())
    return {k: v - m for k, v in costs.items()}


class HostFactorComputation(DcopComputation):
    """One factor node: marginalizes its relation + incoming variable
    costs towards each neighbor variable."""

    def __init__(self, comp_def):
        super().__init__(comp_def.node.name, comp_def)
        self._factor = comp_def.node.factor
        self._scope = [v for v in self._factor.dimensions]
        # 'max' objectives flip the sign inside the min-sum math (the
        # batched engine instead negates costs at compile time)
        self._sign = -1.0 if comp_def.algo.mode == "max" else 1.0
        self._incoming: Dict[str, Dict[Any, float]] = {}
        self._last_sent: Dict[str, Dict[Any, float]] = {}

    def on_start(self) -> None:
        self._send_all()

    @register("maxsum_costs")
    def _on_costs(self, sender: str, msg: MaxSumCostMessage, t: float) -> None:
        self._incoming[sender] = msg.costs
        self._send_all(exclude=None)

    def _marginal_for(self, target) -> Dict[Any, float]:
        others = [v for v in self._scope if v.name != target.name]
        out: Dict[Any, float] = {}
        for tval in target.domain:
            best = None
            for combo in itertools.product(*(v.domain for v in others)):
                assignment = {target.name: tval}
                extra = 0.0
                for v, val in zip(others, combo):
                    assignment[v.name] = val
                    extra += self._incoming.get(v.name, {}).get(val, 0.0)
                c = (
                    self._sign
                    * self._factor.get_value_for_assignment(assignment)
                    + extra
                )
                if best is None or c < best:
                    best = c
            out[tval] = best if best is not None else 0.0
        return _normalize(out)

    def _send_all(self, exclude: Optional[str] = None) -> None:
        for v in self._scope:
            if v.name == exclude:
                continue
            costs = self._marginal_for(v)
            if _stable(costs, self._last_sent.get(v.name)):
                continue
            self._last_sent[v.name] = costs
            self.post_msg(v.name, MaxSumCostMessage(costs))

    def on_peer_restarted(self, peer: str) -> None:
        # a migrated variable lost this factor's last r message AND
        # this factor's memory of what it last sent must be voided, or
        # the change-only send gate would keep the fresh instance
        # blind forever; its stale incoming q is dropped too
        self._incoming.pop(peer, None)
        self._last_sent.pop(peer, None)
        for v in self._scope:
            if v.name == peer:
                costs = self._marginal_for(v)
                self._last_sent[v.name] = costs
                self.post_msg(v.name, MaxSumCostMessage(costs))


class HostVariableComputation(VariableComputation):
    """One variable node: sums incoming factor costs (+ own value
    costs), selects the argmin value, and reflects per-factor sums."""

    def __init__(self, comp_def, seed: int = 0):
        super().__init__(comp_def.node.variable, comp_def)
        self._incoming: Dict[str, Dict[Any, float]] = {}
        self._last_sent: Dict[str, Dict[Any, float]] = {}
        # deterministic per-(variable, value) symmetry-breaking noise in
        # the message math only — same device as the batched kernel's
        # `noise` param and the reference's VariableNoisyCostFunc
        import random

        from pydcop_tpu_torch.infrastructure.computations import stable_seed

        self._sign = -1.0 if comp_def.algo.mode == "max" else 1.0
        rnd = random.Random(stable_seed(seed, self.name))
        level = float(comp_def.algo.params.get("noise", 0.001) or 0.0)
        self._noise = {
            val: rnd.uniform(0.0, level) for val in self._variable.domain
        }

    def _own_costs(self) -> Dict[Any, float]:
        v = self._variable
        if v.has_cost:
            return {
                val: self._sign * float(v.cost_for_val(val))
                + self._noise[val]
                for val in v.domain
            }
        return {val: self._noise[val] for val in v.domain}

    def on_start(self) -> None:
        own = self._own_costs()
        # migration restart: resume from the pre-failure value when
        # the runtime provided one; message flow restarts from own
        # costs either way (messages are not part of the carried state)
        self.value_selection(
            self.initial_value_or(lambda: min(own, key=own.get))
        )
        for f in self.neighbors:
            costs = _normalize(own)
            self._last_sent[f] = costs
            self.post_msg(f, MaxSumCostMessage(costs))

    def on_peer_restarted(self, peer: str) -> None:
        # re-seed a migrated factor with this variable's current q and
        # void the stale bookkeeping for it (see the factor-side hook)
        self._incoming.pop(peer, None)
        self._last_sent.pop(peer, None)
        if peer not in self.neighbors:
            return
        own = self._own_costs()
        belief = {
            val: own[val]
            + sum(c.get(val, 0.0) for c in self._incoming.values())
            for val in self._variable.domain
        }
        costs = _normalize(belief)
        self._last_sent[peer] = costs
        self.post_msg(peer, MaxSumCostMessage(costs))

    @register("maxsum_costs")
    def _on_costs(self, sender: str, msg: MaxSumCostMessage, t: float) -> None:
        self._incoming[sender] = msg.costs
        own = self._own_costs()
        belief = {
            val: own[val]
            + sum(c.get(val, 0.0) for c in self._incoming.values())
            for val in self._variable.domain
        }
        self.value_selection(min(belief, key=belief.get))
        for f in self.neighbors:
            costs = _normalize(
                {
                    val: belief[val]
                    - self._incoming.get(f, {}).get(val, 0.0)
                    for val in self._variable.domain
                }
            )
            if _stable(costs, self._last_sent.get(f)):
                continue
            self._last_sent[f] = costs
            self.post_msg(f, MaxSumCostMessage(costs))


def build_computation(comp_def, seed: int = 0):
    """Reference-contract factory: graph node → host computation."""
    from pydcop_tpu_torch.graphs.factor_graph import FactorComputationNode

    if isinstance(comp_def.node, FactorComputationNode):
        return HostFactorComputation(comp_def)
    return HostVariableComputation(comp_def, seed=seed)
