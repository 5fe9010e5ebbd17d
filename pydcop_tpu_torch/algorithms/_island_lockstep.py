"""Lockstep-island skeleton for round-barrier local search (MGM, DBA,
GDBA; port of ``pydcop_tpu/algorithms/_island_lockstep.py``).

The burst schedule of the DSA islands (extra interior rounds per
boundary wave) is illegal for algorithms whose guarantee rests on the
per-round "no two adjacent movers" invariant.  A LOCKSTEP island
instead participates in the exact two-phase protocol of
``_host_phased.PhasedComputation`` — one batched step of the whole
sub-problem on the island's device per GLOBAL round:

- phase 0: remotes broadcast their value payloads; once every
  boundary proxy has its remote payloads for the round, the subclass
  pins shadows and computes ALL owned variables' metrics in one
  batched sweep, answering with the boundary metric payloads,
- phase 1: remote metric payloads arrive; the subclass injects them
  at the shadow slots, decides winners for every owned variable with
  the batched ``strict_winner`` under a NAME-RANK priority (so the
  tie-break is bit-identical to the host rule ``name < name``), and
  broadcasts the new boundary value payloads, opening the next round.

This base class owns the protocol plumbing — phase buffers with
stale-message dropping, the expected-pair barrier, name-rank priority,
host-parity initial draws, payload emission, proxy value publishing,
the device scope and the ``island.flushes`` / ``island.boundary_msgs``
counters (one flush per phase that dispatches to the device) — so the
per-algorithm islands (``_island_mgm.py``, ``_island_dba.py``,
``_island_gdba.py``) are pure phase math.
"""

from __future__ import annotations

import random
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from pydcop_tpu_torch.algorithms._host_phased import PhaseMessage
from pydcop_tpu_torch.algorithms._island_common import (
    SHADOW,
    build_subproblem,
    device_scope,
)
from pydcop_tpu_torch.infrastructure.computations import (
    VariableComputation,
    register,
    stable_seed,
)


class LockstepIsland:
    """Protocol plumbing shared by the lockstep islands."""

    def __init__(
        self,
        var_nodes: List[Any],
        dcop,
        algo_def,
        seed: int,
        island_name: str,
        pending_fn: Optional[Callable[[], int]] = None,  # unused:
        # phases are message-counted, not drain-triggered
        device=None,
    ):
        params = dict(algo_def.params)
        self._params = params
        start_rounds = params.get("island_start_rounds")
        self._start_rounds = (
            64 if start_rounds is None else int(start_rounds)
        )

        sp = build_subproblem(var_nodes, dcop, island_name, device=device)
        self.owned_names = sp.owned_names
        self._remotes_of = sp.remotes_of
        self._problem = sp.problem
        self.device = sp.problem.device
        self._slot = sp.slot
        self._labels = sp.labels
        self._shadow_slot = sp.shadow_slot
        self._owned_slots = sp.owned_slots

        # name-rank priority: the host winner rule breaks exact-gain
        # ties by variable NAME (lower wins); the batched
        # strict_winner breaks them by HIGHER prio — so
        # prio = -rank(real name)
        real_name = {i: nm for nm, i in self._slot.items()}
        for real, s in self._shadow_slot.items():
            real_name[s] = real
        order = sorted(real_name, key=lambda s: real_name[s])
        prio = np.empty(self._problem.n_vars, dtype=np.float32)
        for rank, s in enumerate(order):
            prio[s] = -float(rank)
        self._prio = torch.from_numpy(prio).to(self.device)

        # initial values: EXACTLY the host draw (PhasedComputation.
        # on_start) per owned variable, so a mixed run replays the
        # all-host run bit for bit
        initial = params.get("initial", "random")
        values = np.zeros(self._problem.n_vars, dtype=np.int64)
        for node in var_nodes:
            var = node.variable
            labels = self._labels[var.name]
            if initial == "declared" and var.initial_value is not None:
                val = var.initial_value
            else:
                rnd = random.Random(stable_seed(seed, var.name))
                val = var.domain[rnd.randrange(len(var.domain))]
            values[self._slot[var.name]] = labels.index(val)
        self._values = values  # i64[n] current indices (host-side)

        self._cycle = 0
        self._phase = 0
        self._buf: Dict[Tuple[int, int], Dict[Tuple[str, str], Any]] = {}
        self._expected = {
            (v, u) for v, us in self._remotes_of.items() for u in us
        }
        self._proxies: Dict[str, "LockstepProxy"] = {}
        self._n_started = 0
        #: phases dispatched to the device and boundary messages sent
        #: (also counted as ``island.flushes`` / ``island.boundary_msgs``
        #: in a session)
        self.flushes = 0
        self.boundary_msgs = 0

    # -- subclass hooks --------------------------------------------------

    def phase0_complete(
        self, got: Dict[Tuple[str, str], Any]
    ) -> Dict[str, Any]:
        """Remote phase-0 payloads in (shadows already PINNED by
        ``_pin_values``); compute the round's metrics for every owned
        variable and return the phase-1 payload per boundary var."""
        raise NotImplementedError

    def phase1_complete(
        self, got: Dict[Tuple[str, str], Any]
    ) -> Dict[str, Any]:
        """Remote phase-1 payloads in; apply the round's moves and
        return the next round's phase-0 payload per boundary var."""
        raise NotImplementedError

    def interior_round(self) -> bool:
        """One no-boundary round; return False at a fixed point."""
        raise NotImplementedError

    def value_payload_of(self, got_payload: Any) -> Any:
        """Extract the VALUE from a phase-0 payload (identity for
        value-only protocols; DBA's payloads are (value, flags))."""
        return got_payload

    # -- device helpers ----------------------------------------------------

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        """A host array as a tensor on the island's device."""
        return torch.from_numpy(np.ascontiguousarray(array)).to(self.device)

    def _values_t(self) -> torch.Tensor:
        """The current indices as an i32 tensor on the device (the
        compiled problem's index type)."""
        return self._to_device(self._values.astype(np.int32))

    def _count_flush(self) -> None:
        from pydcop_tpu_torch.telemetry import get_metrics

        self.flushes += 1
        met = get_metrics()
        if met.enabled:
            met.inc("island.flushes")

    # -- wiring ----------------------------------------------------------

    def attach(self, proxy) -> None:
        self._proxies[proxy.name] = proxy

    def node_started(self) -> None:
        self._n_started += 1
        if self._n_started != len(self._proxies):
            return
        self._publish_values()
        if not self._shadow_slot:
            # the whole problem lives on this island: no phases will
            # ever fire — run the interior rounds to a fixed point now
            with device_scope(self.device):
                for _ in range(self._start_rounds):
                    self._count_flush()
                    if not self.interior_round():
                        break
            self._publish_values()
            return
        self._emit(0, self.next_value_payloads())
        self._advance()  # thread mode buffers pre-start messages

    def receive(self, dest: str, sender: str, msg) -> None:
        cycle, phase = msg.cycle, msg.phase
        if cycle < self._cycle or (
            cycle == self._cycle and phase < self._phase
        ):
            return  # stale duplicate for a completed phase
        self._buf.setdefault((cycle, phase), {})[(dest, sender)] = (
            msg.payload
        )
        self._advance()

    def _pin_values(self, got: Dict[Tuple[str, str], Any]) -> None:
        for (_v, u), payload in got.items():
            labels = self._labels[SHADOW.format(u)]
            try:
                self._values[self._shadow_slot[u]] = labels.index(
                    self.value_payload_of(payload)
                )
            except ValueError:
                pass  # out-of-domain: keep the previous pin

    def _advance(self) -> None:
        while True:
            got = self._buf.get((self._cycle, self._phase), {})
            if set(got) != self._expected:
                return
            self._buf.pop((self._cycle, self._phase), None)
            self._count_flush()
            with device_scope(self.device):
                if self._phase == 0:
                    self._pin_values(got)
                    payloads = self.phase0_complete(got)
                    self._phase = 1
                    self._emit(1, payloads)
                else:
                    payloads = self.phase1_complete(got)
                    self._publish_values()
                    self._cycle += 1
                    self._phase = 0
                    self._emit(0, payloads)

    def next_value_payloads(self) -> Dict[str, Any]:
        """Default phase-0 payload: the boundary variable's value."""
        return {
            v: self._labels[v][int(self._values[self._slot[v]])]
            for v in self._remotes_of
        }

    def _emit(self, phase: int, payloads: Dict[str, Any]) -> None:
        from pydcop_tpu_torch.telemetry import get_metrics

        met = get_metrics()
        for v, us in self._remotes_of.items():
            msg = PhaseMessage(self._cycle, phase, payloads[v])
            for u in us:
                self._proxies[v].post_msg(u, msg)
            self.boundary_msgs += len(us)
            if met.enabled:
                met.inc("island.boundary_msgs", len(us))

    def _publish_values(self) -> None:
        for v in self.owned_names:
            self._proxies[v].value_selection(
                self._labels[v][int(self._values[self._slot[v]])]
            )


class LockstepProxy(VariableComputation):
    """Routing/collect stand-in for one island-hosted variable."""

    def __init__(self, comp_def, island: LockstepIsland):
        super().__init__(comp_def.node.variable, comp_def)
        self._island = island
        island.attach(self)

    @property
    def island(self) -> LockstepIsland:
        return self._island

    def on_start(self) -> None:
        self._island.node_started()

    @register("np_phase")
    def _on_phase(self, sender: str, msg, t: float) -> None:
        self._island.receive(self.name, sender, msg)
