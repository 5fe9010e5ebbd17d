"""Compiled-island Max-Sum: one agent's subgraph on the device (port of
``pydcop_tpu/algorithms/_island_maxsum.py``).

The heterogeneous deployment mode of the host runtime (reference
analogue: ``pydcop/infrastructure/agents.py`` hosts many Python
computations per agent; here ONE strong agent — the machine with the
card — hosts its computations as a single *compiled island* while every
other agent runs the plain message-driven computations of
``_host_maxsum``).  Boundary messages stay ``MaxSumCostMessage`` frames,
so remote agents cannot tell an island from a thousand Python
computations.

Mechanism (exact, not approximate):

- The island's owned variables + factors form a sub-DCOP.  For every
  boundary edge (owned factor ``f``, remote variable ``u``) a **shadow
  variable** ``__shadow__f__u`` with ``u``'s domain joins the sub-DCOP
  in ``u``'s scope position.  The sub-DCOP compiles through
  ``ops.compile.compile_dcop`` onto the island's device, and the island
  runs the batched :func:`pydcop_tpu_torch.algorithms.maxsum.step` on
  it: on the card, the per-factor factor kernel and the q-update kernel
  of ``ops/maxsum_kernels.py`` (every DCOP-compiled table is
  per-factor).
- An incoming ``u → f`` cost message is pinned as the shadow's outgoing
  ``q`` on its single edge before every internal round (``q`` is
  recomputed in-step, so the pin is re-applied each round; the shadow's
  noise column is zeroed so the authoritative message is not
  perturbed).  The pin builds a new ``q`` tensor (``index_copy``): no
  step writes into carried tensors.  Padded domain positions are pinned
  to ``BIG``.
- An incoming ``g → v`` cost message from a remote factor ``g`` to an
  owned variable ``v`` folds into ``v``'s unary rows.  Each flush builds
  a NEW problem around the folded rows (``_island_common.with_unary``):
  ``CompiledProblem.unary_t`` is a cached property, so writing the old
  problem's ``unary`` in place would leave ``step`` reading stale rows.
- Outgoing boundary messages are read back from device state (one
  ``.cpu()`` each of ``r``, ``noise`` and ``values``: the flush's only
  host syncs): the ``r`` row on a shadow edge IS ``f``'s message to
  ``u``; an owned ``v``'s message to a remote factor ``g`` is
  ``belief_v`` minus the last message received FROM ``g``, with the same
  normalization + stability filter as ``_host_maxsum`` so
  quiescence-based termination works unchanged.

Each owned graph node is represented by a lightweight proxy computation,
so routing, ``current_value`` collection and the quiescence monitor all
see ordinary computations.

Scheduling: the island steps ``island_start_rounds`` internal rounds
when started and ``island_rounds`` more whenever its agent's inbox
drains after new boundary messages.

Random state: the noise comes from the port's ``maxsum.init_state``,
seeded with the JAX island's seed expression ``(seed · 0x9E3779B1) &
0x7FFFFFFF`` — a ``torch.Generator`` stream, not jax's (ROADMAP C,
'Island noise'); parity tests hand both packages' islands the same
noise.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from pydcop_tpu_torch.algorithms._host_maxsum import (
    MaxSumCostMessage,
    _normalize,
    _stable,
)
from pydcop_tpu_torch.algorithms._island_common import (
    device_scope,
    with_unary,
)
from pydcop_tpu_torch.infrastructure.computations import (
    DcopComputation,
    VariableComputation,
    register,
)

_SHADOW = "__shadow__{}__{}"


def _shadow_name(factor_name: str, var_name: str) -> str:
    return _SHADOW.format(factor_name, var_name)


def island_noise_seed(seed: int) -> int:
    """The seed of an island's noise draw (the JAX island's key seed)."""
    return (seed * 0x9E3779B1) & 0x7FFFFFFF


class MaxSumIsland:
    """Shared core behind one agent's island proxies."""

    def __init__(
        self,
        var_nodes: List[Any],
        factor_nodes: List[Any],
        dcop,
        algo_def,
        seed: int,
        pending_fn: Optional[Callable[[], int]] = None,
        device=None,
    ):
        import torch

        from pydcop_tpu_torch.algorithms import load_algorithm_module
        from pydcop_tpu_torch.dcop.dcop import DCOP
        from pydcop_tpu_torch.dcop.objects import Variable
        from pydcop_tpu_torch.dcop.relations import NAryMatrixRelation
        from pydcop_tpu_torch.ops.compile import compile_dcop

        self._module = load_algorithm_module("maxsum")
        self._pending_fn = pending_fn or (lambda: 0)
        params = dict(algo_def.params)
        self._params = params
        rounds = params.get("island_rounds")
        self._rounds = 4 if rounds is None else int(rounds)
        start_rounds = params.get("island_start_rounds")
        self._start_rounds = (
            64 if start_rounds is None else int(start_rounds)
        )

        owned_vars = {n.variable.name: n.variable for n in var_nodes}
        owned_factors = {n.factor.name: n.factor for n in factor_nodes}
        self.owned_var_names = set(owned_vars)
        self.owned_factor_names = set(owned_factors)

        # -- boundary discovery -----------------------------------------
        # (owned factor, remote var) -> shadow; (owned var, remote
        # factor) -> unary fold + host-side outgoing q
        sub = DCOP(f"island_{seed}", objective=dcop.objective)
        for v in owned_vars.values():
            sub.add_variable(v)
        self._shadow_of: Dict[Tuple[str, str], str] = {}
        shadow_vars: Dict[str, Variable] = {}
        for f in owned_factors.values():
            scope = []
            for v in f.dimensions:
                if v.name in owned_vars:
                    scope.append(v)
                    continue
                sname = _shadow_name(f.name, v.name)
                if sname not in shadow_vars:
                    shadow_vars[sname] = Variable(sname, v.domain)
                    sub.add_variable(shadow_vars[sname])
                self._shadow_of[(f.name, v.name)] = sname
                scope.append(shadow_vars[sname])
            # any relation kind -> table, dims remapped to the
            # island-local scope (shadows standing in for remote vars)
            sub.add_constraint(
                NAryMatrixRelation(
                    scope, f.as_matrix().matrix, name=f.name
                )
            )
        # remote factors each owned variable hears from: graph
        # neighbors of the variable node that are not owned factors
        self._remote_factors_of: Dict[str, List[str]] = {}
        for n in var_nodes:
            remote = [
                f for f in n.neighbors if f not in owned_factors
            ]
            if remote:
                self._remote_factors_of[n.variable.name] = remote

        self._problem = p = compile_dcop(sub, device=device)
        self.device = p.device
        self._slot = {name: i for i, name in enumerate(p.var_names)}
        self._labels = {
            name: list(p.domain_labels[self._slot[name]])
            for name in list(owned_vars) + list(shadow_vars)
        }
        self._d_max = p.d_max
        self._n_edges = p.n_edges
        ve = p.var_edges.cpu().numpy()
        self._var_edges = {
            name: [int(e) for e in ve[self._slot[name]] if e < p.n_edges]
            for name in self._slot
        }
        # shadow vars have exactly one (incoming) edge: their factor's
        self._shadow_edge = {
            s: self._var_edges[s][0] for s in shadow_vars
        }
        self._shadow_edges = sorted(self._shadow_edge.values())
        self._se = torch.tensor(
            self._shadow_edges, dtype=torch.long, device=self.device
        )

        # -- device state -------------------------------------------------
        with device_scope(self.device):
            # the unary-free index fields, derived once here (the
            # sentinel check syncs the device) and carried into every
            # flush's problem by with_unary
            p.var_edges_t, p.slot_sentinels  # noqa: B018
            state = self._module.init_state(
                p, island_noise_seed(seed), params
            )
            if shadow_vars:
                cols = torch.tensor(
                    [self._slot[s] for s in shadow_vars],
                    dtype=torch.long, device=self.device,
                )
                state["noise"] = state["noise"].index_fill(-1, cols, 0.0)
        self._state = state
        self._base_unary = p.unary.cpu().numpy().copy()

        # received boundary messages, as padded float rows
        self._q_in: Dict[Tuple[str, str], np.ndarray] = {}  # (f,u)->q
        self._r_in: Dict[Tuple[str, str], np.ndarray] = {}  # (v,g)->r
        self._last_sent: Dict[Tuple[str, str], Dict[Any, float]] = {}
        self._proxies: Dict[str, "MessagePassingComputation"] = {}
        self._n_started = 0
        self._dirty = False
        self._flushed_once = False
        #: flushes run and boundary messages sent (also counted as
        #: ``island.flushes`` / ``island.boundary_msgs`` in a session)
        self.flushes = 0
        self.boundary_msgs = 0

    # -- wiring ----------------------------------------------------------

    def attach(self, proxy) -> None:
        self._proxies[proxy.name] = proxy

    def node_started(self) -> None:
        self._n_started += 1
        if self._n_started == len(self._proxies):
            self._flush(self._start_rounds)

    # -- inbound ---------------------------------------------------------

    def _row(
        self,
        costs: Dict[Any, float],
        labels: List[Any],
        pad: float = 0.0,
    ) -> np.ndarray:
        """Cost dict -> padded [d_max] row.  ``pad`` fills positions
        beyond the real domain: q pins need BIG there (a padded value
        must never win a factor marginalization — normal edges get
        this through the BIG unary flowing into q, which the pin
        bypasses), while r folds need 0 (the base unary already
        carries BIG on padded positions)."""
        row = np.full(self._d_max, pad, dtype=np.float32)
        for i, lab in enumerate(labels):
            row[i] = float(costs.get(lab, 0.0))
        return row

    def receive(self, dest: str, sender: str, costs: Dict[Any, float]) -> None:
        from pydcop_tpu_torch.ops.compile import BIG

        # NOTE: dropped messages (stale destination / non-boundary
        # edge) still fall through to the flush check — the drop may
        # be the LAST queued item and must not strand _dirty pins
        if dest in self.owned_factor_names:
            # q from a remote variable: pin on the shadow edge
            key = (dest, sender)
            if key in self._shadow_of:
                sname = self._shadow_of[key]
                self._q_in[key] = self._row(
                    costs, self._labels[sname], pad=BIG
                )
                self._dirty = True
        elif dest in self.owned_var_names:
            # r from a remote factor: folds into dest's unary rows
            self._r_in[(dest, sender)] = self._row(
                costs, self._labels[dest]
            )
            self._dirty = True
        if (
            self._dirty
            and self._flushed_once
            and self._pending_fn() == 0
        ):
            self._flush(self._rounds)

    def peer_restarted(self, owner: str, peer: str) -> None:
        """A migrated neighbor lost everything this island ever sent:
        void the change-only send cache for that pair and re-flush, so
        the next emit re-sends the current boundary message even at a
        fixed point (where no periodic traffic would re-sync it)."""
        self._last_sent.pop((owner, peer), None)
        self._dirty = True
        if self._flushed_once and self._pending_fn() == 0:
            self._flush(self._rounds)

    # -- the device rounds --------------------------------------------------

    def q_pin(self) -> np.ndarray:
        """The pin matrix ``[d, n_shadow_edges]`` (column order = sorted
        shadow edges).  A column with no message yet holds zeros on the
        real domain (the host factor's "no message yet" assumption) and
        BIG on the padded tail, so a padded value can never win the
        marginalization."""
        from pydcop_tpu_torch.ops.compile import BIG

        q_pin = np.zeros(
            (self._d_max, len(self._shadow_edges)), dtype=np.float32
        )
        col = {e: i for i, e in enumerate(self._shadow_edges)}
        for sname, e in self._shadow_edge.items():
            q_pin[len(self._labels[sname]):, col[e]] = BIG
        for (f, u), srow in self._q_in.items():
            sname = self._shadow_of[(f, u)]
            q_pin[:, col[self._shadow_edge[sname]]] = srow
        return q_pin

    def folded_unary(self) -> np.ndarray:
        """The base unary rows plus every received remote-factor row."""
        unary = self._base_unary.copy()
        for (v, _g), row in self._r_in.items():
            unary[self._slot[v]] += row
        return unary

    def _run_rounds(self, unary: np.ndarray, n_rounds: int) -> None:
        """``n_rounds`` Max-Sum rounds on the device with the current
        pins: the real ``maxsum.step`` on a problem built around
        ``unary``."""
        import torch

        dev = self.device
        problem = with_unary(
            self._problem, torch.from_numpy(unary).to(dev)
        )
        state = self._state
        pin = None
        if self._shadow_edges:
            pin = torch.from_numpy(self.q_pin()).to(
                device=dev, dtype=state["q"].dtype
            )
        for _ in range(n_rounds):
            if pin is not None:
                state = {**state, "q": state["q"].index_copy(-1, self._se, pin)}
            state = self._module.step(problem, state, self._params)
        self._state = state

    def _flush(self, n_rounds: int) -> None:
        """Run internal rounds with current boundary pins, then emit
        changed boundary messages and refresh proxy values."""
        from pydcop_tpu_torch.telemetry import get_metrics

        self._flushed_once = True
        self._dirty = False
        self.flushes += 1
        met = get_metrics()
        if met.enabled:
            met.inc("island.flushes")
        unary = self.folded_unary()
        with device_scope(self.device):
            self._run_rounds(unary, n_rounds)
            self._emit(unary)

    # -- outbound ---------------------------------------------------------

    def _post(self, proxy, target: str, costs) -> None:
        from pydcop_tpu_torch.telemetry import get_metrics

        self.boundary_msgs += 1
        met = get_metrics()
        if met.enabled:
            met.inc("island.boundary_msgs")
        proxy.post_msg(target, MaxSumCostMessage(costs))

    def _emit(self, unary: np.ndarray) -> None:
        # the flush's host syncs: one read-back of each
        r = self._state["r"].float().cpu().numpy()
        noise = self._state["noise"].cpu().numpy()
        values = self._state["values"].cpu().numpy()

        # factor -> remote variable: the r row on the shadow edge
        for (f, u), sname in self._shadow_of.items():
            e = self._shadow_edge[sname]
            labels = self._labels[sname]
            costs = _normalize(
                {
                    lab: float(r[i, e])
                    for i, lab in enumerate(labels)
                }
            )
            if _stable(costs, self._last_sent.get((f, u))):
                continue
            self._last_sent[(f, u)] = costs
            self._post(self._proxies[f], u, costs)

        # owned variable: value refresh for every proxy (cheap — the
        # device already argmin'ed), belief recomputation ONLY for
        # boundary variables (the ones with remote factors): the
        # interior can be thousands of variables per flush
        for v in self.owned_var_names:
            self._proxies[v].value_selection(
                self._labels[v][int(values[self._slot[v]])]
            )
        for v, remote in self._remote_factors_of.items():
            slot = self._slot[v]
            labels = self._labels[v]
            proxy = self._proxies[v]
            belief = unary[slot].astype(np.float64) + noise[:, slot]
            for e in self._var_edges[v]:
                belief += r[:, e]
            for g in remote:
                rcv = self._r_in.get((v, g))
                out = belief[: len(labels)].copy()
                if rcv is not None:
                    out -= rcv[: len(labels)]
                costs = _normalize(
                    {lab: float(c) for lab, c in zip(labels, out)}
                )
                if _stable(costs, self._last_sent.get((v, g))):
                    continue
                self._last_sent[(v, g)] = costs
                self._post(proxy, g, costs)


class IslandVariableProxy(VariableComputation):
    """Routing/collect stand-in for one island-hosted variable."""

    def __init__(self, comp_def, island: MaxSumIsland):
        super().__init__(comp_def.node.variable, comp_def)
        self._island = island
        island.attach(self)

    @property
    def island(self) -> MaxSumIsland:
        return self._island

    def on_start(self) -> None:
        self._island.node_started()

    @register("maxsum_costs")
    def _on_costs(self, sender: str, msg: MaxSumCostMessage, t: float) -> None:
        self._island.receive(self.name, sender, msg.costs)

    def on_peer_restarted(self, peer: str) -> None:
        self._island.peer_restarted(self.name, peer)


class IslandFactorProxy(DcopComputation):
    """Routing stand-in for one island-hosted factor."""

    def __init__(self, comp_def, island: MaxSumIsland):
        super().__init__(comp_def.node.name, comp_def)
        self._island = island
        island.attach(self)

    @property
    def island(self) -> MaxSumIsland:
        return self._island

    def on_start(self) -> None:
        self._island.node_started()

    @register("maxsum_costs")
    def _on_costs(self, sender: str, msg: MaxSumCostMessage, t: float) -> None:
        self._island.receive(self.name, sender, msg.costs)

    def on_peer_restarted(self, peer: str) -> None:
        self._island.peer_restarted(self.name, peer)


def build_island(
    comp_defs: List[Any],
    dcop,
    seed: int = 0,
    pending_fn: Optional[Callable[[], int]] = None,
    device=None,
) -> List[Any]:
    """Build ONE island on ``device`` (default: the CUDA device) + its
    per-node proxies for an agent's placed factor-graph computations.
    Returns the proxy list (deployable like ordinary computations)."""
    from pydcop_tpu_torch.graphs.factor_graph import FactorComputationNode

    var_defs = [
        cd for cd in comp_defs
        if not isinstance(cd.node, FactorComputationNode)
    ]
    factor_defs = [
        cd for cd in comp_defs
        if isinstance(cd.node, FactorComputationNode)
    ]
    if not var_defs and not factor_defs:
        return []
    algo_def = comp_defs[0].algo
    island = MaxSumIsland(
        [cd.node for cd in var_defs],
        [cd.node for cd in factor_defs],
        dcop,
        algo_def,
        seed,
        pending_fn=pending_fn,
        device=device,
    )
    return [IslandVariableProxy(cd, island) for cd in var_defs] + [
        IslandFactorProxy(cd, island) for cd in factor_defs
    ]
