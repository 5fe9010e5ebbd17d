"""Host message-driven MGM-2 computations (a copy of
``pydcop_tpu/algorithms/_host_mgm2.py``).

Reference-shaped coordinated 2-opt (reference:
``pydcop/algorithms/mgm2.py``: offerer/receiver roles, offer / accept
/ gain / go message phases, pairwise coordinated moves), sharing the
batched kernel's semantics (``algorithms/mgm2.py``) — the same
Bernoulli(``probability``) role draw, one offer per offerer to one
uniformly random neighbor, best-pair acceptance, and the strict
neighborhood winner rule with the partner excluded for committed
pairs; a committed pair moves iff BOTH partners win.

Five synchronized phases per round on the
:class:`~pydcop_tpu_torch.algorithms._host_phased.PhasedComputation`
skeleton:

0. *value*  — broadcast the current value,
1. *offer*  — offerers send their chosen partner the offer payload
   (everyone else receives ``None`` so the barrier closes),
2. *accept* — receivers evaluate incoming offers' joint gains and
   accept the single best positive one back to its offerer,
3. *gain*   — committed pairs broadcast the joint gain, everyone else
   the unilateral MGM gain,
4. *go*     — broadcast the win bit; committed pairs move together,
   everyone else takes the plain MGM move.

Joint gains decompose exactly as in the batched step
(``algorithms/mgm2.py`` module docs): the offerer ships, per candidate
value ``a``, its local cost with the shared (offerer∩receiver)
constraints removed at the receiver's current value —
``nonshared_v(a) = local_v(a) − shared(a, cur_r)`` — plus its
current nonshared cost; the receiver owns every shared constraint
too (the constraints hypergraph guarantees it), so it completes

  gain(a, b) = [ns_v(cur_v) + ns_r(cur_r) + shared(cur_v, cur_r)]
             − [ns_v(a)     + ns_r(b)     + shared(a, b)]

with other scope variables fixed at this round's values.

Implemented from scratch against the model objects (NOT the batched
kernels), like the other host computations.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from pydcop_tpu_torch.algorithms._common import EPS
from pydcop_tpu_torch.algorithms._host_phased import PerNeighbor, PhasedComputation


class HostMgm2Computation(PhasedComputation):
    N_PHASES = 5

    def __init__(self, comp_def, seed: int = 0):
        super().__init__(comp_def, seed=seed)
        self._probability = float(
            comp_def.algo.params.get("probability", 0.5)
        )
        # constraints shared with each neighbor (scope contains both)
        self._shared_with: Dict[str, List[Any]] = {}
        for n in self.neighbors:
            self._shared_with[n] = [
                c
                for c in self._constraints
                if any(d.name == n for d in c.dimensions)
            ]
        # per-round state
        self._nv: Dict[str, Any] = {}
        self._local: Dict[Any, float] = {}
        self._uni_candidate: Any = None
        self._uni_gain = 0.0
        self._is_offerer = False
        self._partner: Optional[str] = None
        self._committed = False
        self._planned: Any = None
        self._gain_msg = 0.0
        self._win = False

    # -- cost pieces ----------------------------------------------------

    def _local_cost(self, value: Any, nv: Dict[str, Any]) -> float:
        cost = self._raw_unary(value)
        for c in self._constraints:
            cost += self._constraint_cost(c, value, nv)
        return cost

    def _shared_cost(
        self, other: str, mine: Any, theirs: Any, nv: Dict[str, Any]
    ) -> float:
        """Sum of constraints shared with ``other``, me at ``mine``,
        them at ``theirs``, remaining scope at this round's values."""
        total = 0.0
        me = self._variable.name
        for c in self._shared_with[other]:
            assignment = {me: mine, other: theirs}
            for dim in c.dimensions:
                if dim.name not in assignment:
                    assignment[dim.name] = nv[dim.name]
            total += self._sign * c.get_value_for_assignment(assignment)
        return total

    # -- phases ---------------------------------------------------------

    def initial_payload(self) -> Any:
        return self.current_value

    def finish_phase(self, phase: int, got: Dict[str, Any]) -> Any:
        return [
            self._ph_value, self._ph_offer, self._ph_accept,
            self._ph_gain, self._ph_go,
        ][phase](got)

    def _ph_value(self, got: Dict[str, Any]) -> Any:
        nv = dict(got)
        self._nv = nv
        cur = self.current_value
        self._local = {
            x: self._local_cost(x, nv) for x in self._variable.domain.values
        }
        current = self._local[cur]
        best_val, best_cost = cur, current
        for x, c in self._local.items():
            if c < best_cost:
                best_val, best_cost = x, c
        self._uni_candidate = best_val
        self._uni_gain = current - best_cost
        self._committed = False
        self._partner = None
        self._is_offerer = self._rnd.random() < self._probability
        if not self._is_offerer:
            return PerNeighbor({})
        partner = self._neighbors[
            self._rnd.randrange(len(self._neighbors))
        ]
        self._partner = partner
        # nonshared_v(a) = local_v(a) − shared(a, cur_partner)
        pairs: List[Tuple[Any, float]] = [
            (
                x,
                self._local[x]
                - self._shared_cost(partner, x, nv[partner], nv),
            )
            for x in self._variable.domain.values
        ]
        cur_ns = self._local[cur] - self._shared_cost(
            partner, cur, nv[partner], nv
        )
        return PerNeighbor({partner: {"cur": cur_ns, "pairs": pairs}})

    def _ph_offer(self, got: Dict[str, Any]) -> Any:
        if self._is_offerer:  # offerers never accept (batched parity)
            return PerNeighbor({})
        nv = self._nv
        cur = self.current_value
        best: Optional[Tuple[str, Any, Any, float]] = None
        for o in sorted(got):  # deterministic scan order
            offer = got[o]
            if offer is None:
                continue
            # my side with the o-shared constraints factored out
            ns_me = {
                b: self._local[b] - self._shared_cost(o, b, nv[o], nv)
                for b in self._variable.domain.values
            }
            base = (
                offer["cur"]
                + ns_me[cur]
                + self._shared_cost(o, cur, nv[o], nv)
            )
            for a, ns_a in offer["pairs"]:
                for b in self._variable.domain.values:
                    gain = base - (
                        ns_a + ns_me[b] + self._shared_cost(o, b, a, nv)
                    )
                    if best is None or gain > best[3] + EPS:
                        best = (o, a, b, gain)
        if best is None or best[3] <= EPS:
            return PerNeighbor({})
        o, a, b, gain = best
        self._committed = True
        self._partner = o
        self._planned = b
        self._gain_msg = gain
        return PerNeighbor({o: (a, b, gain)})

    def _ph_accept(self, got: Dict[str, Any]) -> Any:
        if self._is_offerer:
            acc = got.get(self._partner) if self._partner else None
            if acc is not None:
                a, _b, gain = acc
                self._committed = True
                self._planned = a
                self._gain_msg = gain
        if not self._committed:
            self._partner = None
            self._planned = self._uni_candidate
            self._gain_msg = self._uni_gain
        return self._gain_msg  # phase 3: broadcast the gain

    def _ph_gain(self, got: Dict[str, float]) -> Any:
        compare = {
            n: g
            for n, g in got.items()
            if not (self._committed and n == self._partner)
        }
        self._win = self.strict_winner(self._gain_msg, compare)
        return self._win  # phase 4: broadcast the win bit

    def _ph_go(self, got: Dict[str, Any]) -> Any:
        move = self._win and (
            not self._committed or bool(got.get(self._partner))
        )
        if move:
            self.value_selection(self._planned)
        return self.current_value  # next round's value phase


def build_computation(comp_def, seed: int = 0):
    return HostMgm2Computation(comp_def, seed=seed)
