"""Compiled-island DSA: one agent's variables on the device (port of
``pydcop_tpu/algorithms/_island_dsa.py``).

The constraints-hypergraph counterpart of
:mod:`pydcop_tpu_torch.algorithms._island_maxsum`: one agent hosts its
placed variables as a single compiled sub-problem stepped by the batched
DSA-family round (dsa's sweep, adsa's activation schedule, dsatuto's
fixed rule) through its ``draws``/``apply`` seam, while remote agents
run the plain message-driven computations of ``_host_dsa``.  Boundary
traffic stays ``DsaValueMessage`` frames, so remote agents cannot tell
an island from per-variable Python computations.

Mechanism:

- The island's owned variables plus every constraint touching them form
  a sub-DCOP; each remote scope variable is represented by ONE **shadow
  variable** ``__shadow__<name>`` with its domain (shared across all
  boundary constraints that reference it).
- An incoming ``DsaValueMessage`` from remote ``u`` pins ``u``'s shadow:
  before every internal round burst the shadow's state value is set to
  the received index and its unary row carries BIG off that index, so
  the DSA sweep can neither move it nor profit from moving it.  No burst
  runs until EVERY boundary neighbor has announced at least once (host
  DSA skips constraints whose neighbors are unknown).
- After each burst, owned boundary variables whose value changed are
  announced to their remote neighbor computations; interior updates stay
  on the device.  No message is sent when nothing changed, so
  quiescence-based termination works unchanged.

Scheduling: DSA islands run NO start burst; they wait for the initial
value wave, then step ``island_rounds`` whenever the inbox drains.

Random state: the JAX island folds its flush count into a jax key; the
port draws each round from a ``torch.Generator`` on the island's device,
seeded once with the same ``stable_seed`` (ROADMAP C, 'Island noise').
:meth:`DsaIsland.draws` is the seam: tests feed it the JAX island's
draws, and ``chip_smoke.py`` feeds the card and the CPU the same
CPU-made draws.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from pydcop_tpu_torch.algorithms._host_dsa import DsaValueMessage
from pydcop_tpu_torch.algorithms._island_common import SHADOW as _SHADOW
from pydcop_tpu_torch.algorithms._island_common import (
    device_scope,
    with_unary,
)
from pydcop_tpu_torch.infrastructure.computations import (
    VariableComputation,
    register,
)

# consecutive bursts that changed nothing (while a probability-gated
# improving move exists) before the island stops self-re-firing: keeps
# quiescence-based termination even when the move gate never opens
# (probability/activation ~ 0).  Any boundary message or any actual
# change re-arms the budget.
_MAX_IDLE_TICKS = 16

#: torch generators take seeds below 2**64
_SEED_MASK = (1 << 64) - 1


class DsaIsland:
    """Shared core behind one agent's island proxies."""

    def __init__(
        self,
        var_nodes: List[Any],
        dcop,
        algo_def,
        seed: int,
        pending_fn: Optional[Callable[[], int]] = None,
        device=None,
    ):
        import torch

        from pydcop_tpu_torch.algorithms import load_algorithm_module
        from pydcop_tpu_torch.algorithms._island_common import (
            build_subproblem,
        )
        from pydcop_tpu_torch.infrastructure.computations import (
            stable_seed,
        )

        # the island steps the ACTUAL algorithm's batched round
        self._module = load_algorithm_module(algo_def.algo)
        self._pending_fn = pending_fn or (lambda: 0)
        params = dict(algo_def.params)
        self._params = params
        rounds = params.get("island_rounds")
        self._rounds = 4 if rounds is None else int(rounds)
        start_rounds = params.get("island_start_rounds")
        self._start_rounds = (
            64 if start_rounds is None else int(start_rounds)
        )

        sp = build_subproblem(
            var_nodes, dcop, f"dsa_island_{seed}", device=device
        )
        self.owned_names = sp.owned_names
        self._remote_neighbors_of = sp.remotes_of
        self._problem = sp.problem
        self.device = sp.problem.device
        self._slot = sp.slot
        self._labels = sp.labels
        self._shadow_slot = sp.shadow_slot
        self._base_unary = sp.base_unary
        self._owned_slots = sp.owned_slots
        self._owned_slots_t = torch.from_numpy(sp.owned_slots).to(
            self.device
        )

        self._pin: Dict[str, int] = {}  # remote var -> pinned index
        self._heard: set = set()  # remote vars announced at least once
        self._last_sent: Dict[str, Any] = {}
        self._proxies: Dict[str, "IslandDsaProxy"] = {}
        self._n_started = 0
        self._dirty = False
        self._started = False
        self._flushes = 0
        self._idle_ticks = 0  # consecutive no-change self-re-fires

        # per-island stream: two structurally identical islands (a
        # symmetric split) must not draw correlated move gates, or they
        # oscillate in lockstep — same rule as _host_dsa's
        # stable_seed(seed, name) per computation
        self.seed = stable_seed(seed, "|".join(sorted(self.owned_names)))
        with device_scope(self.device):
            self._problem.var_edges_t, self._problem.slot_sentinels  # noqa: B018
            self._state = self._module.init_state(
                self._problem, self.seed & _SEED_MASK, params
            )
            self._gen = torch.Generator(device=self.device)
            self._gen.manual_seed(self.seed & _SEED_MASK)

    @property
    def flushes(self) -> int:
        """Bursts run so far."""
        return self._flushes

    # -- wiring ----------------------------------------------------------

    def attach(self, proxy) -> None:
        self._proxies[proxy.name] = proxy

    def node_started(self) -> None:
        self._n_started += 1
        if self._n_started == len(self._proxies):
            self._started = True
            if not self._shadow_slot:
                # no boundary at all (whole problem on this island):
                # there are no unknown neighbors to wait for, and no
                # message will ever trigger a flush — converge now
                self._rounds, burst = self._start_rounds, self._rounds
                try:
                    self._flush()
                finally:
                    self._rounds = burst
                return
            # announce initial values; internal rounds wait for the
            # neighbor value wave
            self._emit(announce_all=True)
            # boundary values can arrive BEFORE the proxies start
            # (thread mode buffers pre-start messages): a drained inbox
            # with pins already set must burst now
            if self._dirty and self._ready() and self._pending_fn() == 0:
                self._flush()

    # -- inbound ---------------------------------------------------------

    def receive(self, dest: str, sender: str, value: Any) -> None:
        # NOTE: every path falls through to the flush check — a dropped
        # message may be the LAST queued item
        if dest in self.owned_names and sender in self._shadow_slot:
            # "heard" even when the value is unusable (see the JAX
            # island): one malformed announcement must not gate the
            # island shut for the whole run
            self._heard.add(sender)
            labels = self._labels[_SHADOW.format(sender)]
            try:
                self._pin[sender] = labels.index(value)
                self._dirty = True
                self._idle_ticks = 0  # boundary news re-arms re-fires
            except ValueError:
                pass  # value outside the declared domain: drop
        if (
            self._started
            and self._dirty
            and self._ready()
            and self._pending_fn() == 0
        ):
            self._flush()

    def tick(self) -> None:
        """Self-addressed re-fire (see the tick note in ``_flush``)."""
        self._dirty = True
        if self._started and self._ready() and self._pending_fn() == 0:
            self._flush()

    def peer_restarted(self, owner: str, peer: str) -> None:
        """Re-announce ``owner``'s current value to a migrated peer."""
        if owner not in self.owned_names:
            return
        values = self._state["values"].cpu().numpy()
        label = self._labels[owner][int(values[self._slot[owner]])]
        self._proxies[owner].post_msg(peer, DsaValueMessage(label))

    def _ready(self) -> bool:
        """Every boundary neighbor announced at least once?"""
        return len(self._heard) == len(self._shadow_slot)

    # -- the device burst ------------------------------------------------

    def draws(self, problem, n_rounds: int) -> List[Dict[str, Any]]:
        """The random tensors of the flush's ``n_rounds`` rounds, one
        ``module.draws`` dict a round from the island's generator (the
        seam tests and ``chip_smoke.py`` replace)."""
        return [
            self._module.draws(problem, self._params, self._gen)
            for _ in range(n_rounds)
        ]

    def _flush(self) -> None:
        import torch

        from pydcop_tpu_torch.ops.compile import BIG
        from pydcop_tpu_torch.telemetry import get_metrics

        self._dirty = False
        self._flushes += 1
        met = get_metrics()
        if met.enabled:
            met.inc("island.flushes")
        unary = self._base_unary.copy()
        values = self._state["values"].cpu().numpy().copy()
        for real, slot in self._shadow_slot.items():
            pin = self._pin.get(real)
            if pin is None:
                # heard but never a USABLE value: pin at the init value
                pin = int(values[slot])
            row = np.full(unary.shape[1], BIG, dtype=unary.dtype)
            row[pin] = 0.0
            unary[slot] = row
            values[slot] = pin
        with device_scope(self.device):
            problem = with_unary(
                self._problem, torch.from_numpy(unary).to(self.device)
            )
            state = {
                **self._state,
                "values": torch.from_numpy(values).to(self.device),
            }
            for drawn in self.draws(problem, self._rounds):
                state = self._module.apply(
                    problem, state, self._params, drawn
                )
            self._state = state
            self._emit()
            # interior progress must not depend on boundary traffic: a
            # burst that changed values or left a strictly-improving
            # move wanted (probability-gated) re-fires via a
            # self-addressed tick — the island analogue of
            # _host_dsa._evaluate's dsa_tick
            new_values = self._state["values"].cpu().numpy()
            changed = bool(
                (new_values[self._owned_slots] != values[self._owned_slots])
                .any()
            )
            if changed:
                self._idle_ticks = 0
            else:
                self._idle_ticks += 1
            # a move gate that never opens would otherwise re-fire
            # forever: the idle-tick cap restores quiescence
            if changed or (
                self._idle_ticks < _MAX_IDLE_TICKS
                and self._wants_move(problem)
            ):
                anchor = next(iter(self._proxies.values()))
                from pydcop_tpu_torch.infrastructure.computations import (
                    Message,
                )

                anchor.post_msg(anchor.name, Message("dsa_tick"))

    def _wants_move(self, problem) -> bool:
        """Any owned variable with a strictly better value under the
        current (pinned) assignment?"""
        from pydcop_tpu_torch.algorithms._common import current_best
        from pydcop_tpu_torch.ops.costs import local_cost_sweep

        values = self._state["values"]
        current, best = current_best(
            local_cost_sweep(problem, values), values
        )
        gain = (current - best)[self._owned_slots_t]
        return bool((gain > 1e-6).any())

    # -- outbound ---------------------------------------------------------

    def _emit(self, announce_all: bool = False) -> None:
        values = self._state["values"].cpu().numpy()
        for v in self.owned_names:
            label = self._labels[v][int(values[self._slot[v]])]
            self._proxies[v].value_selection(label)
            remotes = self._remote_neighbors_of.get(v)
            if not remotes:
                continue
            if not announce_all and self._last_sent.get(v) == label:
                continue
            self._last_sent[v] = label
            for u in remotes:
                self._proxies[v].post_msg(u, DsaValueMessage(label))


class IslandDsaProxy(VariableComputation):
    """Routing/collect stand-in for one island-hosted variable."""

    def __init__(self, comp_def, island: DsaIsland):
        super().__init__(comp_def.node.variable, comp_def)
        self._island = island
        island.attach(self)

    @property
    def island(self) -> DsaIsland:
        return self._island

    def on_start(self) -> None:
        self._island.node_started()

    @register("dsa_value")
    def _on_value(self, sender: str, msg: DsaValueMessage, t: float) -> None:
        self._island.receive(self.name, sender, msg.value)

    @register("dsa_tick")
    def _on_tick(self, sender: str, msg, t: float) -> None:
        self._island.tick()

    def on_peer_restarted(self, peer: str) -> None:
        self._island.peer_restarted(self.name, peer)


def build_island(
    comp_defs: List[Any],
    dcop,
    seed: int = 0,
    pending_fn: Optional[Callable[[], int]] = None,
    device=None,
) -> List[Any]:
    """Build ONE island on ``device`` (default: the CUDA device) +
    per-variable proxies for an agent's placed constraints-hypergraph
    computations."""
    if not comp_defs:
        return []
    island = DsaIsland(
        [cd.node for cd in comp_defs],
        dcop,
        comp_defs[0].algo,
        seed,
        pending_fn=pending_fn,
        device=device,
    )
    return [IslandDsaProxy(cd, island) for cd in comp_defs]
