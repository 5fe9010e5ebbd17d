"""Host message-driven DPOP computations (a copy of
``pydcop_tpu/algorithms/_host_dpop.py``).

Reference-shaped exact dynamic programming (reference:
``pydcop/algorithms/dpop.py``): one computation per variable on the
pseudo-tree, UTIL hypercubes joined bottom-up, VALUE assignments
top-down — real ``UtilMessage`` / ``ValueMessage`` traffic over the
host runtimes (sim / thread / hostnet), the reference's deployment
model.  The batched/device path (``algorithms/dpop.py:solve_host``)
remains the production engine; this one exists so DPOP deploys on the
message-driven runtimes like every other algorithm.

Protocol:

- every node owns the constraints whose other scope variables are all
  among its ancestors (parent + pseudo-parents) — the pseudo-tree
  invariant makes exactly one node (the deepest in the scope) own
  each constraint;
- a leaf joins its owned constraint tables (+ its unary costs),
  projects out its own axis by min (keeping the argmin table), and
  sends the projection to its parent as a ``dpop_util`` message
  (dims = its separator, with each dim's domain values so any
  ancestor can consume tables mentioning variables it never shares a
  constraint with);
- an internal node waits for all children's UTILs, joins them with
  its own tables, projects, forwards; the root instead picks its
  argmin value and starts the ``dpop_value`` wave down, each node
  conditioning its stored argmin table on the accumulated ancestor
  assignment and extending it for its children;
- after the VALUE wave nothing more is sent — the run terminates by
  quiescence, and exactness means the runtime's collected assignment
  is the optimum.

All host arithmetic is f64 numpy (like the reference); message size
counts table cells, matching the batched engine's accounting.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from pydcop_tpu_torch.infrastructure.computations import (
    Message,
    VariableComputation,
    register,
)

# joined-table size guard (cells): exponential separators fail with a
# clear error instead of a MemoryError, matching the device path
MAX_UTIL_CELLS = 1 << 26


class UtilMessage(Message):
    """UTIL table: dims (var names), their domain values, flat data."""

    def __init__(
        self,
        dims: Sequence[str],
        domains: Dict[str, List[Any]],
        table: List[float],
    ):
        super().__init__(
            "dpop_util",
            {"dims": list(dims), "domains": domains, "table": table},
        )

    # SimpleRepr reconstructs from constructor-parameter-named
    # attributes — required for the TCP (hostnet) wire format
    @property
    def dims(self) -> List[str]:
        return self._content["dims"]

    @property
    def domains(self) -> Dict[str, List[Any]]:
        return self._content["domains"]

    @property
    def table(self) -> List[float]:
        return self._content["table"]

    @property
    def size(self) -> int:
        return max(len(self._content["table"]), 1)


class ValueMessage(Message):
    def __init__(self, assignment: Dict[str, Any]):
        super().__init__("dpop_value", assignment)

    @property
    def assignment(self) -> Dict[str, Any]:
        return self._content

    @property
    def size(self) -> int:
        return max(len(self._content), 1)


from pydcop_tpu_torch.algorithms._tables import align_table as _align  # noqa: E402


class HostDpopComputation(VariableComputation):
    def __init__(self, comp_def, seed: int = 0):
        super().__init__(comp_def.node.variable, comp_def)
        node = comp_def.node
        self._sign = -1.0 if comp_def.algo.mode == "max" else 1.0
        self._parent: Optional[str] = node.parent
        self._children: List[str] = list(node.children)
        ancestors = set(
            ([] if node.parent is None else [node.parent])
            + list(node.pseudo_parents)
        )
        me = self.name
        # constraints this node owns: every other scope var an ancestor
        self._owned = [
            c
            for c in node.constraints
            if all(
                d.name == me or d.name in ancestors for d in c.dimensions
            )
        ]
        self._util_in: Dict[str, Tuple[List[str], Dict, np.ndarray]] = {}
        self._argmin: Optional[np.ndarray] = None
        self._sep_dims: List[str] = []
        self._domains: Dict[str, List[Any]] = {}

    # -- UTIL phase -----------------------------------------------------

    def _own_tables(self) -> List[Tuple[List[str], np.ndarray]]:
        """Owned constraints + unary costs as (dims, f64 array)."""
        out: List[Tuple[List[str], np.ndarray]] = []
        me = self._variable
        row = np.zeros(len(me.domain), dtype=np.float64)
        if me.has_cost:
            row += [
                self._sign * me.cost_for_val(x) for x in me.domain.values
            ]
        out.append(([me.name], row))
        self._domains.setdefault(me.name, list(me.domain.values))
        for c in self._owned:
            dims = [d.name for d in c.dimensions]
            for d in c.dimensions:
                self._domains.setdefault(d.name, list(d.domain.values))
            shape = tuple(len(d.domain) for d in c.dimensions)
            table = np.empty(shape, dtype=np.float64)
            for cell in itertools.product(*(range(s) for s in shape)):
                assignment = {
                    d.name: d.domain.values[i]
                    for d, i in zip(c.dimensions, cell)
                }
                table[cell] = self._sign * c.get_value_for_assignment(
                    assignment
                )
            out.append((dims, table))
        return out

    def _send_util(self) -> None:
        me = self.name
        parts = self._own_tables()
        for child, (dims, domains, table) in self._util_in.items():
            self._domains.update(domains)
            parts.append((dims, table))
        # join axes: me first, then every other dim in first-seen order
        target: List[str] = [me]
        for dims, _ in parts:
            for d in dims:
                if d not in target:
                    target.append(d)
        cells = 1
        for d in target:
            cells *= len(self._domains[d])
        if cells > MAX_UTIL_CELLS:
            raise ValueError(
                f"DPOP UTIL table at {me} needs {cells} cells "
                f"(separator {target[1:]}); exceeds {MAX_UTIL_CELLS}"
            )
        joined = np.zeros(
            tuple(len(self._domains[d]) for d in target), dtype=np.float64
        )
        for dims, table in parts:
            joined = joined + _align(table, dims, target)
        # project out my own axis (axis 0): min + argmin retained
        self._sep_dims = target[1:]
        self._argmin = np.argmin(joined, axis=0)
        projected = np.min(joined, axis=0)
        if self._parent is None:  # root: decide and start VALUE wave
            # projected is a scalar (roots own no non-unary upward
            # constraints, children separators ⊆ {root})
            idx = tuple()
            my_val = self._variable.domain.values[
                int(self._argmin[idx]) if self._argmin.shape else
                int(self._argmin)
            ]
            self.value_selection(my_val)
            for child in self._children:
                self.post_msg(child, ValueMessage({me: my_val}))
        else:
            self.post_msg(
                self._parent,
                UtilMessage(
                    self._sep_dims,
                    {d: self._domains[d] for d in self._sep_dims},
                    projected.reshape(-1).tolist(),
                ),
            )

    def on_start(self) -> None:
        if not self._children:
            self._send_util()

    @register("dpop_util")
    def _on_util(self, sender: str, msg: UtilMessage, t: float) -> None:
        c = msg.content
        domains = c["domains"]
        table = np.asarray(c["table"], dtype=np.float64).reshape(
            tuple(len(domains[d]) for d in c["dims"])
        )
        self._util_in[sender] = (list(c["dims"]), domains, table)
        if set(self._util_in) == set(self._children):
            self._send_util()

    # -- VALUE phase ----------------------------------------------------

    @register("dpop_value")
    def _on_value(self, sender: str, msg: ValueMessage, t: float) -> None:
        assignment = dict(msg.content)
        idx = tuple(
            self._domains[d].index(assignment[d]) for d in self._sep_dims
        )
        my_val = self._variable.domain.values[int(self._argmin[idx])]
        self.value_selection(my_val)
        assignment[self.name] = my_val
        for child in self._children:
            self.post_msg(child, ValueMessage(assignment))


def build_computation(comp_def, seed: int = 0):
    return HostDpopComputation(comp_def, seed=seed)
