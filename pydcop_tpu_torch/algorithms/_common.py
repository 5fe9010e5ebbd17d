"""Shared rules of the local-search family (port of
``pydcop_tpu/algorithms/_common.py``): the initial-value policy, the DSA
decision rule and the strict-winner rule of the gain exchange, plus the
draw helpers of the random seam (see the registry's docstring).

Every function takes a leading batch (restart) axis on its per-variable
inputs.  Comparisons stay in f32 as in the JAX package: a Python float
on the other side of ``<``/``<=`` is cast to the tensor's dtype.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from pydcop_tpu_torch.ops.compile import CompiledProblem
from pydcop_tpu_torch.ops.costs import neighbor_gather

EPS = 1e-6


def batch_shape(state: Dict[str, torch.Tensor]) -> Tuple[int, ...]:
    """The state's leading batch (restart) axes: ``()`` or ``(K,)``."""
    return tuple(state["values"].shape[:-1])


def uniform(gen: torch.Generator, shape: Tuple[int, ...]) -> torch.Tensor:
    """f32 uniforms in [0, 1) of ``shape`` from ``gen``, on its device."""
    return torch.rand(
        shape, generator=gen, dtype=torch.float32, device=gen.device
    )


def init_values(
    problem: CompiledProblem,
    seed: int,
    params: Dict[str, Any],
    batch: Tuple[int, ...] = (),
) -> torch.Tensor:
    """i32[*batch, n_vars] starting assignment per the ``initial`` param:
    'random' (uniform in-domain, default; drawn on a CPU generator seeded
    with ``seed``) or 'declared' (the declared initial values, zeros
    when absent)."""
    n = problem.n_vars
    if params.get("initial", "random") == "random":
        gen = torch.Generator().manual_seed(int(seed))
        sizes = problem.domain_sizes.cpu().to(torch.float64)
        u = torch.rand(batch + (n,), generator=gen, dtype=torch.float64)
        values = torch.floor(u * sizes).to(problem.init_idx.dtype)
        return values.to(problem.device)
    return problem.init_idx.expand(batch + (n,)).clone()


def values_state(
    problem: CompiledProblem,
    seed: int,
    params: Dict[str, Any],
    batch: Tuple[int, ...] = (),
) -> Dict[str, torch.Tensor]:
    """The ``init_state`` of algorithms whose state is ``values`` alone."""
    return {"values": init_values(problem, seed, params, batch)}


def draw_apply_step(draws: Callable, apply: Callable) -> Callable:
    """``step(problem, state, params, gen)``: ``apply`` of the round's
    ``draws`` from ``gen``, batched like the state.  (Over a shard mesh
    the engine draws in its own thread and calls ``apply`` per shard.)"""

    def step(problem, state, params, gen):
        drawn = draws(problem, params, gen, batch_shape(state))
        return apply(problem, state, params, drawn)

    return step


def current_best(
    local: torch.Tensor, values: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(current, best)``: each variable's local cost at its value and
    its minimum over the domain, from the sweep ``local [..., n, d]``."""
    current = local.gather(-1, values.long()[..., None])[..., 0]
    return current, local.amin(dim=-1)


def dsa_candidate_eligibility(
    local: torch.Tensor,
    values: torch.Tensor,
    tie: torch.Tensor,
    variant: str,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The DSA decision rule shared by dsa / adsa.

    Given the candidate-cost sweep ``local [..., n, d]``, the current
    ``values`` and the tie-break uniforms ``tie`` (``local``'s shape),
    returns ``(candidate, eligible)``: the uniformly-random best value per
    variable and the variant rule's move-eligibility mask — A: strict
    improvement exists; B: improvement exists OR tied while in conflict
    (positive local cost); C: always.
    """
    current, best = current_best(local, values)
    delta = current - best  # >= 0
    inf = torch.tensor(float("inf"), dtype=tie.dtype, device=tie.device)
    candidate = torch.argmin(
        torch.where(local <= best[..., None] + EPS, tie, inf), dim=-1
    ).to(values.dtype)
    if variant == "A":
        eligible = delta > EPS
    elif variant == "B":
        eligible = (delta > EPS) | ((delta <= EPS) & (current > EPS))
    else:  # C
        eligible = torch.ones_like(delta, dtype=torch.bool)
    return candidate, eligible


def strict_winner(
    problem: CompiledProblem,
    gain: torch.Tensor,
    prio: torch.Tensor,
    extra_skip: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """bool[..., n_vars]: v wins iff its (gain, prio) pair
    lexicographically beats every real neighbor's — the MGM-family rule
    guaranteeing no two adjacent movers.  ``prio`` is ``[n_vars]`` or
    batched like ``gain``; ``extra_skip`` (bool[..., n_vars, max_deg])
    marks slots excluded from the comparison (e.g. a committed MGM-2
    partner).  Positive gain is NOT checked here."""
    nbr_gain = neighbor_gather(problem, gain, fill=-float("inf"), dim=-1)
    nbr_prio = neighbor_gather(problem, prio, fill=-float("inf"), dim=-1)
    beats = (gain[..., None] > nbr_gain + EPS) | (
        ((gain[..., None] - nbr_gain).abs() <= EPS)
        & (prio[..., None] > nbr_prio)
    )
    beats = beats | ~problem.neighbor_mask
    if extra_skip is not None:
        beats = beats | extra_skip
    return beats.all(dim=-1)


def lexic_prio(problem: CompiledProblem) -> torch.Tensor:
    """f32[n_vars] priorities under which the lower index wins ties."""
    return -torch.arange(
        problem.n_vars, dtype=torch.float32, device=problem.device
    )
