"""Shared N-phase round synchronization for host computations (a copy of
``pydcop_tpu/algorithms/_host_phased.py``).

Generalizes the two-phase skeleton (MGM's value/gain, DBA's
ok?/improve) to any fixed number of synchronized phases per round —
MGM-2 needs five (value / offer / accept / gain / go, reference:
``pydcop/algorithms/mgm2.py``).  One class owns the
synchronization machinery so the per-algorithm engines stay pure
decision logic:

- round+phase-tagged buffers with stale-message dropping (bounded
  memory),
- the monotone (cycle, phase) cursor: a phase's completion fires
  exactly once, and buffered messages for future phases/rounds wait
  their turn (the generalization of the two-phase skeleton's
  "phase-2-already-sent" guard),
- per-neighbor payloads (wrap a ``{neighbor: payload}`` mapping in
  :class:`PerNeighbor`) for phases where different neighbors must see
  different content (offers go to ONE partner; everyone else gets
  ``None`` so the barrier still closes),
- the strict neighborhood winner rule with name tie-break (``EPS``
  matches the batched kernels' ``algorithms._common.EPS``),
- isolated-variable settling (no neighbors → no phases ever fire →
  pick the best unary value at start).

Subclasses implement two hooks:

- :meth:`initial_payload` — the phase-0 payload opening round 0,
- :meth:`finish_phase` — all neighbor payloads of the current phase
  in; return the next phase's payload (the last phase returns the
  NEXT round's phase-0 payload and is where the round's decision is
  applied).
"""

from __future__ import annotations

import random
from typing import Any, Dict, Mapping, Tuple

from pydcop_tpu_torch.algorithms._common import EPS
from pydcop_tpu_torch.infrastructure.computations import (
    Message,
    VariableComputation,
    register,
    stable_seed,
)


class PerNeighbor:
    """Wrapper marking a phase payload as per-neighbor: ``mapping``
    maps neighbor name → payload (missing neighbors get ``None``)."""

    __slots__ = ("mapping",)

    def __init__(self, mapping: Mapping[str, Any]):
        self.mapping = dict(mapping)


class PhaseMessage(Message):
    def __init__(self, cycle: int, phase: int, payload: Any):
        super().__init__("np_phase", (cycle, phase, payload))

    @property
    def cycle(self) -> int:
        return self._content[0]

    @property
    def phase(self) -> int:
        return self._content[1]

    @property
    def payload(self) -> Any:
        return self._content[2]


class PhasedComputation(VariableComputation):
    """Round-synchronized N-phase computation (see module docs)."""

    N_PHASES = 2

    def __init__(self, comp_def, seed: int = 0):
        super().__init__(comp_def.node.variable, comp_def)
        self._constraints = list(comp_def.node.constraints)
        self._sign = -1.0 if comp_def.algo.mode == "max" else 1.0
        self._initial = comp_def.algo.params.get("initial", "random")
        self._rnd = random.Random(stable_seed(seed, self.name))
        self._cycle = 0
        self._phase = 0  # the phase we have SENT and are waiting on
        self._buf: Dict[Tuple[int, int], Dict[str, Any]] = {}

    # -- subclass hooks -------------------------------------------------

    def initial_payload(self) -> Any:
        raise NotImplementedError

    def finish_phase(self, phase: int, got: Dict[str, Any]) -> Any:
        """All neighbor payloads of ``phase`` in; return the payload
        for the next phase (the last phase returns the next round's
        phase-0 payload after applying the round's decision)."""
        raise NotImplementedError

    # -- shared cost helpers --------------------------------------------

    def _raw_unary(self, value: Any) -> float:
        v = self._variable
        return self._sign * (v.cost_for_val(value) if v.has_cost else 0.0)

    def _constraint_cost(self, c, value: Any, nv: Dict[str, Any]) -> float:
        assignment = {self._variable.name: value}
        for dim in c.dimensions:
            if dim.name != self._variable.name:
                assignment[dim.name] = nv[dim.name]
        return self._sign * c.get_value_for_assignment(assignment)

    def strict_winner(self, mine: float, got: Dict[str, float]) -> bool:
        """Positive metric, strictly best in the neighborhood (exact
        ties broken by name so symmetric instances cannot stall)."""
        return mine > EPS and all(
            mine > g + EPS
            or (abs(mine - g) <= EPS and self.name < n)
            for n, g in got.items()
        )

    # -- the synchronization skeleton ----------------------------------

    def _neighbor_set(self):
        return set(self.neighbors)

    def _broadcast(self, payload: Any) -> None:
        if isinstance(payload, PerNeighbor):
            for n in self._neighbors:
                self.post_msg(
                    n,
                    PhaseMessage(
                        self._cycle, self._phase,
                        payload.mapping.get(n),
                    ),
                )
        else:
            for n in self._neighbors:
                self.post_msg(
                    n, PhaseMessage(self._cycle, self._phase, payload)
                )

    def on_start(self) -> None:
        if self._initial == "declared" and (
            self._variable.initial_value is not None
        ):
            self.value_selection(self._variable.initial_value)
        else:
            self.value_selection(self.random_value(self._rnd))
        if not self._neighbor_set():
            # unconstrained variable: the phases are neighbor-driven
            # and never fire — settle the best unary value now
            best = min(
                self._variable.domain.values, key=self._raw_unary
            )
            self.value_selection(best)
            return
        self._broadcast(self.initial_payload())

    @register("np_phase")
    def _on_phase(self, sender: str, msg: PhaseMessage, t: float) -> None:
        if msg.cycle < self._cycle or (
            msg.cycle == self._cycle and msg.phase < self._phase
        ):
            return  # stale duplicate for a completed phase
        self._buf.setdefault((msg.cycle, msg.phase), {})[sender] = (
            msg.payload
        )
        self._advance()

    def _advance(self) -> None:
        """Fire every phase whose inputs are complete, in order."""
        while True:
            got = self._buf.get((self._cycle, self._phase), {})
            if set(got) != self._neighbor_set():
                return
            self._buf.pop((self._cycle, self._phase), None)
            payload = self.finish_phase(self._phase, got)
            if self._phase + 1 < self.N_PHASES:
                self._phase += 1
            else:
                self._cycle += 1
                self._phase = 0
            self._broadcast(payload)
