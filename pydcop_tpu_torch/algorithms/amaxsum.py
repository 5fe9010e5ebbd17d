"""A-Max-Sum — Asynchronous Max-Sum, run as a batched edge schedule.

Port of ``pydcop_tpu/algorithms/amaxsum.py`` for the batched engine:
each round every directed edge draws an independent
Bernoulli(``activation``); activated edges take the message synchronous
Max-Sum computes this round, the others keep their previous message.
``activation=1.0`` is synchronous Max-Sum.  The round calls
:func:`pydcop_tpu_torch.algorithms.maxsum.step`, so on the card it runs
the CUDA factor kernel and the q-update kernel once each per round.

Draws per round (the JAX step's ``k_sync, k_q, k_r = split(key, 3)``;
``k_sync`` goes unused): ``fire_q`` and ``fire_r``, ``f32[*batch, 1,
E]`` uniforms, an edge firing where its uniform is below
``activation``.  Restarts and instances take Max-Sum's batch axes
(``[R, ...]``, ``[I, R, ...]`` on a stacked problem); ``activation`` may
then be an f32 tensor of one value per instance.

Message accounting: only activated edges carry a message, so the
expected per-round count is ``activation · 2 · n_real_edges``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from pydcop_tpu_torch.algorithms import AlgoParameterDef
from pydcop_tpu_torch.algorithms import maxsum as _maxsum
from pydcop_tpu_torch.algorithms._common import draw_apply_step, uniform
from pydcop_tpu_torch.ops.compile import CompiledProblem

GRAPH_TYPE = "factor_graph"

# the host runtime's k_target migration rebuilds a dead agent's
# computations: these terminate by QUIESCENCE and re-sync a migrated
# neighbor via on_peer_restarted; phased round-barrier algorithms
# (mgm/mgm2/dba/gdba) would deadlock at the cycle barrier instead
# and are rejected at deploy time.
MIGRATION_SAFE = True

algo_params = [
    AlgoParameterDef("damping", "float", None, 0.5),
    AlgoParameterDef("noise", "float", None, 0.001),
    # probability that a directed edge fires in a given round — the
    # asynchrony knob (1.0 == synchronous Max-Sum)
    AlgoParameterDef("activation", "float", None, 0.5),
    AlgoParameterDef("initial", "str", ["declared", "random", "zero"], "zero"),
    # host-runtime island scheduling (not used by the batched engine)
    AlgoParameterDef("island_rounds", "int", None, 4),
    AlgoParameterDef("island_start_rounds", "int", None, 64),
]

# state layout (and its batch axes) and footprints are synchronous
# Max-Sum's
init_state = _maxsum.init_state
values_from_state = _maxsum.values_from_state
state_specs = _maxsum.state_specs
INSTANCE_AXIS = _maxsum.INSTANCE_AXIS
computation_memory = _maxsum.computation_memory
communication_load = _maxsum.communication_load

_DEFAULT_ACTIVATION = next(
    p.default for p in algo_params if p.name == "activation"
)


def draws(
    problem: CompiledProblem,
    params: Dict[str, Any],
    gen: torch.Generator,
    batch: Tuple[int, ...] = (),
) -> Dict[str, torch.Tensor]:
    E = problem.n_edges
    return {
        "fire_q": uniform(gen, batch + (1, E)),
        "fire_r": uniform(gen, batch + (1, E)),
    }


def apply(
    problem: CompiledProblem,
    state: Dict[str, torch.Tensor],
    params: Dict[str, Any],
    drawn: Dict[str, torch.Tensor],
    axis=None,
) -> Dict[str, torch.Tensor]:
    sync = _maxsum.step(problem, state, params, axis=axis)
    act = params["activation"]
    if isinstance(act, torch.Tensor):  # one per instance: [I, 1, .., 1]
        act = act.reshape((-1,) + (1,) * (drawn["fire_q"].dim() - 1))
    q = torch.where(drawn["fire_q"] < act, sync["q"], state["q"])
    r = torch.where(drawn["fire_r"] < act, sync["r"], state["r"])
    # re-select values from the messages actually updated
    unary_t = problem.unary_t + state["noise"]
    belief = _maxsum.belief_from_r(problem, r, unary_t, axis=axis)
    values = torch.argmin(belief, dim=-2).to(state["values"].dtype)
    return {"q": q, "r": r, "values": values, "noise": state["noise"]}


def draw_specs(problem) -> Dict[str, Any]:
    """Placement of the draws over a shard mesh: the engine draws one
    global ``[1, E]`` fire mask of each kind and hands every shard its
    edges' slice (the JAX step folds the shard index into its keys
    instead; ROADMAP.md, C, 'Random streams')."""
    from pydcop_tpu_torch.parallel.mesh import SHARD_AXIS, P

    return {"fire_q": P(None, SHARD_AXIS), "fire_r": P(None, SHARD_AXIS)}


step = draw_apply_step(draws, apply)


def messages_per_round(
    problem: CompiledProblem, params: Optional[Dict[str, Any]] = None
) -> int:
    """Expected directed messages per round: activation · 2 · n_edges."""
    activation = float(
        (params or {}).get("activation", _DEFAULT_ACTIVATION)
    )
    return max(1, round(activation * 2 * problem.n_real_edges))


# -- host-runtime hooks (mode="sim"/"thread") ----------------------------


def build_computation(comp_def, seed: int = 0):
    """Host message-driven computation (async semantics parity path —
    see ``pydcop_tpu_torch.infrastructure``); solving runs on the batched
    engine via ``init_state``/``step``."""
    from pydcop_tpu_torch.algorithms import _host_maxsum

    return _host_maxsum.build_computation(comp_def, seed=seed)


def build_island(comp_defs, dcop, seed: int = 0, pending_fn=None, device=None):
    """Compiled-island deployment (shared with ``maxsum``): the island
    steps its subgraph synchronously per boundary wave — one more legal
    schedule for the same fixed point (``_island_maxsum.py``)."""
    from pydcop_tpu_torch.algorithms import _island_maxsum

    return _island_maxsum.build_island(
        comp_defs, dcop, seed=seed, pending_fn=pending_fn, device=device
    )
