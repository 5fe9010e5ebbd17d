"""Host message-driven SyncBB computations (a copy of
``pydcop_tpu/algorithms/_host_syncbb.py``).

Reference-shaped Synchronous Branch & Bound (reference:
``pydcop/algorithms/syncbb.py``): a token carrying the current partial
assignment and bound walks the ordered variable chain — forward on
extension, backward on exhaustion — as real messages over the host
runtimes (sim / thread / hostnet).  The vectorized host solver
(``algorithms/syncbb.py:solve_host``) remains the production engine;
this one exists so SyncBB deploys on the message-driven runtimes like
every other algorithm.

Protocol (three message types):

- ``bb_token`` (forward): ``{path: [(var, value)…], cost, ub, best}``
  — the sender extended the partial assignment; the receiver explores
  its candidate values best-first against it,
- ``bb_back`` (backward): ``{ub, best}`` — the receiver's subtree
  under the current prefix is exhausted (possibly with an improved
  bound); the sender advances its own cursor,
- ``bb_done``: the first variable exhausted its domain — the search
  is complete; the optimum assignment propagates down the chain, each
  node selecting its value.  Nothing more is sent afterwards, so the
  run terminates by quiescence with the exact optimum.

Constraint ownership is dynamic: a node evaluates exactly the
constraints whose other scope variables all appear in the incoming
prefix (each constraint is thus counted once, at its deepest
variable, whatever the ordering).  Like the vectorized engine, every
constraint table and unary row is shifted by its minimum so all
increments are non-negative — without this the partial cost is not a
lower bound and the ub-prune is unsound (the constant shift moves
every complete assignment equally, so the argmin — and the reported
cost, which the runtime re-evaluates natively — is unchanged.  The
token's ``cost``/``ub`` fields are therefore in shifted units and
never reported).  Candidate values are explored best-first, which
also means the first complete extension at the last node is optimal
for its prefix.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from pydcop_tpu_torch.infrastructure.computations import (
    Message,
    VariableComputation,
    register,
)


class HostSyncBBComputation(VariableComputation):
    def __init__(self, comp_def, seed: int = 0):
        super().__init__(comp_def.node.variable, comp_def)
        node = comp_def.node
        self._sign = -1.0 if comp_def.algo.mode == "max" else 1.0
        self._prev: Optional[str] = getattr(node, "prev", None)
        self._next: Optional[str] = getattr(node, "next", None)
        self._constraints = list(node.constraints)
        # min-shifted unary row (bound soundness, see module docs)
        me = self._variable
        row = np.zeros(len(me.domain), dtype=np.float64)
        if me.has_cost:
            row += [self._sign * me.cost_for_val(x) for x in me.domain.values]
            row -= row.min()
        self._unary = row
        self._shifts: Dict[str, float] = {}  # per-constraint table min
        # search state for the current prefix
        self._path: List[Tuple[str, Any]] = []
        self._prefix_cost = 0.0
        self._ub = float("inf")
        self._best: Optional[List[Tuple[str, Any]]] = None
        self._order: List[int] = []
        self._rows: np.ndarray = row
        self._cursor = 0

    # -- cost of my candidates under a prefix ---------------------------

    def _table_shift(self, c) -> float:
        s = self._shifts.get(c.name)
        if s is None:
            s = min(
                self._sign * c.get_value_for_assignment(
                    dict(
                        zip((d.name for d in c.dimensions), cell)
                    )
                )
                for cell in itertools.product(
                    *(d.domain.values for d in c.dimensions)
                )
            )
            self._shifts[c.name] = s
        return s

    def _candidate_costs(self, prefix: Dict[str, Any]) -> np.ndarray:
        """Shifted cost added by each of my values, given ``prefix`` —
        evaluating exactly the constraints fully assigned at me."""
        me = self._variable.name
        row = self._unary.copy()
        for c in self._constraints:
            others = [d.name for d in c.dimensions if d.name != me]
            if not all(o in prefix for o in others):
                continue  # a deeper variable owns this constraint
            shift = self._table_shift(c)
            for i, x in enumerate(self._variable.domain.values):
                assignment = dict(prefix)
                assignment[me] = x
                row[i] += (
                    self._sign * c.get_value_for_assignment(
                        {d.name: assignment[d.name] for d in c.dimensions}
                    )
                    - shift
                )
        return row

    # -- the walk -------------------------------------------------------

    def _begin(self, path: List[Tuple[str, Any]], cost: float) -> None:
        self._path = path
        self._prefix_cost = cost
        self._rows = self._candidate_costs(dict(path))
        self._order = list(np.argsort(self._rows, kind="stable"))
        self._cursor = 0
        self._advance()

    def _advance(self) -> None:
        values = self._variable.domain.values
        while self._cursor < len(self._order):
            i = self._order[self._cursor]
            self._cursor += 1
            cost = self._prefix_cost + float(self._rows[i])
            if cost >= self._ub:
                break  # best-first: every later candidate also fails
            if self._next is None:  # last in the chain: complete
                self._ub = cost
                self._best = self._path + [(self.name, values[i])]
                break  # best-first: siblings cannot beat the new ub
            self.post_msg(
                self._next,
                Message(
                    "bb_token",
                    {
                        "path": self._path + [(self.name, values[i])],
                        "cost": cost,
                        "ub": self._ub,
                        "best": self._best,
                    },
                ),
            )
            return  # wait for bb_back
        # exhausted (or pruned out) under this prefix
        if self._prev is None:
            self._finish()
        else:
            self.post_msg(
                self._prev,
                Message("bb_back", {"ub": self._ub, "best": self._best}),
            )

    def _finish(self) -> None:
        """First variable exhausted: search done, propagate optimum."""
        best = dict(self._best or [])
        if best:
            self.value_selection(best[self.name])
        if self._next is not None:
            self.post_msg(
                self._next, Message("bb_done", list(best.items()))
            )

    def on_start(self) -> None:
        if self._prev is None:  # chain head opens the search
            self._begin([], 0.0)

    @register("bb_token")
    def _on_token(self, sender: str, msg: Message, t: float) -> None:
        c = msg.content
        self._ub = c["ub"]
        self._best = c["best"]
        self._begin([tuple(p) for p in c["path"]], c["cost"])

    @register("bb_back")
    def _on_back(self, sender: str, msg: Message, t: float) -> None:
        self._ub = msg.content["ub"]
        self._best = msg.content["best"]
        self._advance()

    @register("bb_done")
    def _on_done(self, sender: str, msg: Message, t: float) -> None:
        best = dict(tuple(p) for p in msg.content)
        if self.name in best:
            self.value_selection(best[self.name])
        if self._next is not None:
            self.post_msg(self._next, Message("bb_done", msg.content))


def build_computation(comp_def, seed: int = 0):
    return HostSyncBBComputation(comp_def, seed=seed)
