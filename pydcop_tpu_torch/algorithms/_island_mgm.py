"""Compiled LOCKSTEP island for MGM (port of
``pydcop_tpu/algorithms/_island_mgm.py``): one agent's variables on the
device, stepping once per GLOBAL two-phase round.

The DSA-family islands run extra interior rounds per boundary wave —
legal for uncoordinated local search, but fatal for MGM: its monotone
guarantee rests on "no two adjacent movers per round", enforced by the
gain comparison, and an island replaying stale remote gains across
extra interior rounds could let two adjacent variables move together.
The lockstep schedule (``_island_lockstep.py``) keeps the guarantee
intact:

- *phase 0 (value)*: remote values pin the shadows; ONE
  ``local_cost_sweep`` evaluates every owned variable's candidates;
  the boundary gains go out (f32 gains cast to f64 payloads, as the
  JAX island sends them).
- *phase 1 (gain)*: remote gains inject at the shadow slots; the
  batched ``strict_winner`` under the NAME-RANK priority decides all
  owned movers at once (bit-identical tie-break to the host rule).

What it buys: interior value/gain messages become tensor ops — wire
traffic shrinks to the boundary — while the per-round trajectory is
IDENTICAL to the all-host run (MGM with lexic tie-break is
deterministic).  What it cannot buy, by the invariant itself: an
interior round multiplier — one round per round is the lockstep trade.

Remote agents run plain ``_host_mgm`` computations and cannot tell an
island from per-variable Python computations.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from pydcop_tpu_torch.algorithms._common import (
    EPS,
    current_best,
    strict_winner,
)
from pydcop_tpu_torch.algorithms._island_lockstep import (
    LockstepIsland,
    LockstepProxy,
)
from pydcop_tpu_torch.ops.costs import local_cost_sweep


class MgmIsland(LockstepIsland):
    """Lockstep MGM phase math over the compiled sub-problem."""

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
            f"mgm_island_{seed}", pending_fn=pending_fn, device=device,
        )
        self._gain = None  # np[n] gains after phase 0
        self._candidate = None  # np[n] argmin candidates after phase 0
        self._values_dev = None  # device copy threaded through the
        # no-boundary interior loop (avoids an upload per round)

    def _sweep(self, values):
        """``(gain, candidate)`` for every slot under ``values``."""
        local = local_cost_sweep(self._problem, values)  # [n, d]
        current, best = current_best(local, values)
        candidate = local.argmin(dim=-1).to(values.dtype)
        return current - best, candidate

    def _decide(self, gain, candidate, values):
        win = strict_winner(self._problem, gain, self._prio) & (gain > EPS)
        return torch.where(win, candidate, values)

    # -- lockstep hooks --------------------------------------------------

    def phase0_complete(
        self, got: Dict[Tuple[str, str], Any]
    ) -> Dict[str, Any]:
        gain, candidate = self._sweep(self._values_t())
        self._gain = gain.cpu().numpy().astype(np.float64)
        self._candidate = candidate.cpu().numpy()
        return {
            v: float(self._gain[self._slot[v]])
            for v in self._remotes_of
        }

    def phase1_complete(
        self, got: Dict[Tuple[str, str], Any]
    ) -> Dict[str, Any]:
        gain = self._gain.copy()
        for (_v, u), payload in got.items():
            gain[self._shadow_slot[u]] = float(payload)
        new_values = self._decide(
            self._to_device(gain.astype(np.float32)),
            self._to_device(self._candidate),
            self._values_t(),
        ).cpu().numpy()
        # moves apply to OWNED slots only (shadows change only through
        # next round's value messages)
        self._values[self._owned_slots] = new_values[self._owned_slots]
        return self.next_value_payloads()

    def interior_round(self) -> bool:
        values = (
            self._values_dev
            if self._values_dev is not None
            else self._values_t()
        )
        gain, candidate = self._sweep(values)
        new_values = self._decide(gain, candidate, values)
        # the changed check syncs the device anyway; values stay on the
        # device across rounds
        changed = bool((new_values != values).any())
        self._values_dev = new_values
        self._values = new_values.cpu().numpy().astype(np.int64)
        return changed  # 1-opt fixed point: further rounds are no-ops


class IslandMgmProxy(LockstepProxy):
    pass


def build_island(
    comp_defs: List[Any],
    dcop,
    seed: int = 0,
    pending_fn: Optional[Callable[[], int]] = None,
    device=None,
) -> List[Any]:
    """Build ONE lockstep island on ``device`` (default: the CUDA
    device) + per-variable proxies for an agent's placed MGM
    computations."""
    if not comp_defs:
        return []
    island = MgmIsland(
        [cd.node for cd in comp_defs],
        dcop,
        comp_defs[0].algo,
        seed,
        pending_fn=pending_fn,
        device=device,
    )
    return [IslandMgmProxy(cd, island) for cd in comp_defs]
