"""Compiled LOCKSTEP island for DBA, Distributed Breakout (port of
``pydcop_tpu/algorithms/_island_dba.py``).

Same schedule as MGM's lockstep island (``_island_lockstep.py``): one
batched step of the whole sub-problem on the device per GLOBAL two-phase
round, preserving the no-two-adjacent-movers invariant.  DBA adds the
breakout machinery to the phase math, following the HOST protocol's
timing exactly (``_host_dba.py``):

- *phase 0 (ok?)*: payloads are ``(value, flags)`` — the flags name
  the constraints the sender's variable flagged at the END of the
  previous round.  The island merges remote flags with its own
  pending per-constraint flags and raises each flagged constraint's
  weight ONCE, then runs the WEIGHTED candidate sweep
  (``algorithms.dba.candidate_metrics`` — the batched round's own
  formula) and records the raw per-constraint violations under the
  pre-move assignment.  Boundary improves go out.
- *phase 1 (improve)*: remote improves inject at the shadow slots;
  winners move (name-rank priority).  A quasi-local minimum —
  violated incident constraint, nobody in the closed neighborhood
  improves — is detected with the batched formulas
  (``algorithms.dba.qlm_mask``); each owned QLM variable flags its
  violated incident constraints: interior flags become next round's
  pending weight increases, boundary variables' flags ride the next
  ``(value, flags)`` payload so REMOTE endpoints raise their weight
  copies too — endpoint weight tables stay equal, exactly as the
  host engine's merge rule keeps them.

The flag algebra and the weights stay host-side numpy, as in the JAX
island.  Weights only steer search; reported costs stay raw.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from pydcop_tpu_torch.algorithms._common import EPS, strict_winner
from pydcop_tpu_torch.algorithms._island_lockstep import (
    LockstepIsland,
    LockstepProxy,
)
from pydcop_tpu_torch.algorithms.dba import candidate_metrics, qlm_mask


class DbaIsland(LockstepIsland):
    """Lockstep DBA phase math over the compiled sub-problem."""

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
            f"dba_island_{seed}", pending_fn=pending_fn, device=device,
        )
        p = self._problem
        self._increase = float(self._params.get("increase", 1.0))
        self._weights = np.ones(p.n_cons, dtype=np.float32)
        self._pending = np.zeros(p.n_cons, dtype=bool)  # my QLM flags
        self._con_idx = {nm: i for i, nm in enumerate(p.con_names)}
        # constraint names incident to each owned variable, and the
        # owned-slot mask for the touch rule
        cs = p.con_scopes.cpu().numpy()
        mask = p.con_strides.cpu().numpy() > 0
        self._con_scopes = cs
        self._incident: Dict[str, List[int]] = {
            v: [] for v in self.owned_names
        }
        for c in range(p.n_cons):
            for s, real in zip(cs[c], mask[c]):
                if real:
                    nm = p.var_names[int(s)]
                    if nm in self._incident:
                        self._incident[nm].append(c)
        owned_mask = np.zeros(p.n_vars, dtype=bool)
        owned_mask[self._owned_slots] = True
        self._scope_owned = owned_mask[cs] & mask  # [C, k_max]

        self._improve = None
        self._candidate = None
        self._violated = None  # bool[C] under the pre-move assignment

    def _decide(self, improve, candidate, values, violated):
        problem = self._problem
        win = strict_winner(problem, improve, self._prio) & (improve > EPS)
        new_values = torch.where(win, candidate, values)
        qlm = qlm_mask(problem, improve, violated)
        return new_values.cpu().numpy(), qlm.cpu().numpy()

    # -- lockstep hooks --------------------------------------------------

    def value_payload_of(self, got_payload: Any) -> Any:
        return got_payload[0]  # (value, flags)

    def _raise_and_sweep(self, remote_flags) -> None:
        """The shared round opening: merge flags (mine + the remote
        endpoints'), raise each flagged constraint's weight ONCE, run
        the weighted sweep, record the pre-move violations."""
        flagged = self._pending.copy()
        for names in remote_flags:
            for nm in names:
                c = self._con_idx.get(nm)
                if c is not None:
                    flagged[c] = True
        self._weights[flagged] += self._increase
        self._pending = np.zeros_like(self._pending)
        # the batched round's OWN formulas (algorithms.dba), so the
        # island cannot drift from the engine
        improve, candidate, violated = candidate_metrics(
            self._problem, self._values_t(), self._to_device(self._weights)
        )
        self._improve = improve.cpu().numpy().astype(np.float64)
        self._candidate = candidate.cpu().numpy()
        self._violated = violated.cpu().numpy()

    def _owned_pending_from(self, qlm: np.ndarray) -> np.ndarray:
        """pending[c] = violated[c] & any owned QLM endpoint of c."""
        return self._violated & np.any(
            qlm[self._con_scopes] & self._scope_owned, axis=1
        )

    def phase0_complete(
        self, got: Dict[Tuple[str, str], Any]
    ) -> Dict[str, Any]:
        self._raise_and_sweep(payload[1] for payload in got.values())
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
        new_values, qlm = self._decide(
            self._to_device(improve.astype(np.float32)),
            self._to_device(self._candidate),
            self._values_t(),
            self._to_device(self._violated),
        )
        self._values[self._owned_slots] = new_values[self._owned_slots]
        # owned QLM variables flag their violated incident constraints:
        # interior flags feed next round's weight increase directly...
        self._pending = self._owned_pending_from(qlm)
        # ...and boundary variables' own flags ride the payload so the
        # REMOTE endpoints raise their weight copies too
        p = self._problem
        payloads = {}
        for v in self._remotes_of:
            flags: List[str] = []
            if qlm[self._slot[v]]:
                flags = [
                    p.con_names[c]
                    for c in self._incident[v]
                    if self._violated[c]
                ]
            payloads[v] = (
                self._labels[v][int(self._values[self._slot[v]])],
                flags,
            )
        return payloads

    def next_value_payloads(self) -> Dict[str, Any]:
        # phase-0 payloads carry (value, flags); the opening round has
        # no flags yet (the host initial_payload is (value, []))
        return {
            v: (self._labels[v][int(self._values[self._slot[v]])], [])
            for v in self._remotes_of
        }

    def interior_round(self) -> bool:
        self._raise_and_sweep(())  # no remote endpoints exist
        new_values, qlm = self._decide(
            self._to_device(self._improve.astype(np.float32)),
            self._to_device(self._candidate),
            self._values_t(),
            self._to_device(self._violated),
        )
        self._values = new_values.astype(np.int64)
        self._pending = self._owned_pending_from(qlm)
        # continue while anything is violated or flagged (breakout may
        # still reshape the landscape); a violation-free assignment is
        # a fixed point for the raw problem
        return bool(self._violated.any() or self._pending.any())


class IslandDbaProxy(LockstepProxy):
    pass


def build_island(
    comp_defs: List[Any],
    dcop,
    seed: int = 0,
    pending_fn: Optional[Callable[[], int]] = None,
    device=None,
) -> List[Any]:
    """Build ONE lockstep island on ``device`` (default: the CUDA
    device) + per-variable proxies for an agent's placed DBA
    computations."""
    if not comp_defs:
        return []
    island = DbaIsland(
        [cd.node for cd in comp_defs],
        dcop,
        comp_defs[0].algo,
        seed,
        pending_fn=pending_fn,
        device=device,
    )
    return [IslandDbaProxy(cd, island) for cd in comp_defs]
