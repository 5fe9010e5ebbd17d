"""Two-phase round synchronization for host computations (a copy of
``pydcop_tpu/algorithms/_host_twophase.py``).

MGM and DBA/GDBA (and the reference's other coordinated local-search
algorithms) share one message-driven skeleton: per round, every
variable broadcasts a phase-1 payload to its hypergraph neighbors,
completes phase 1 once all neighbor payloads for the round arrived,
broadcasts a phase-2 payload, and completes the round once all
phase-2 payloads arrived.

The synchronization machinery (tagged buffers, monotone phase cursor,
winner rule, isolated variables) lives in the N-phase generalization
:class:`~pydcop_tpu_torch.algorithms._host_phased.PhasedComputation`
(MGM-2's five phases forced the generalization); this class only maps
the two-phase hook names onto it:

- :meth:`initial_payload` — the phase-1 payload opening a round,
- :meth:`finish_phase1` — all neighbor phase-1 payloads in; return
  the phase-2 payload to broadcast,
- :meth:`finish_round` — all phase-2 payloads in; apply the round's
  decision and return the NEXT round's phase-1 payload.
"""

from __future__ import annotations

from typing import Any, Dict

from pydcop_tpu_torch.algorithms._host_phased import PhasedComputation


class TwoPhaseComputation(PhasedComputation):
    """Round-synchronized two-phase computation (see module docs)."""

    N_PHASES = 2

    # -- subclass hooks -------------------------------------------------

    def finish_phase1(self, got: Dict[str, Any]) -> Any:
        """All phase-1 payloads for the round in; return phase 2's."""
        raise NotImplementedError

    def finish_round(self, got: Dict[str, Any]) -> Any:
        """All phase-2 payloads in; decide, return next phase 1's."""
        raise NotImplementedError

    # -- mapping onto the N-phase skeleton ------------------------------

    def finish_phase(self, phase: int, got: Dict[str, Any]) -> Any:
        if phase == 0:
            return self.finish_phase1(got)
        return self.finish_round(got)
