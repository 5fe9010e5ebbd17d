"""Max-Sum — belief propagation on the factor graph (synchronous).

Port of ``pydcop_tpu/algorithms/maxsum.py`` for the batched engine.  The
whole factor graph's messages live in two ``[d, n_edges]`` tensors over
the compiler's directed edges (one per (constraint, scope position)):
``q`` (variable→factor) and ``r`` (factor→variable).  Edges are laid out
position-major per arity bucket, so each bucket position's messages are
one contiguous column block.

One round (factor-first, so one belief serves the q update and value
selection):

1. factor → variable per arity bucket: ``S = table ⊕ Σ_p q_p``,
   ``r_p = min over the other axes − q_p``, min-normalized.  On the card,
   when every bucket is binary, there is one shard and ``d ≤ 64``, this
   runs as the CUDA kernels of ``ops/maxsum_kernels.py`` (the gate of the
   JAX package's Pallas kernels); otherwise through the generic
   ``ops/semiring.py:bp_factor_messages``.
2. belief ``b_v = unary + noise + Σ incoming r`` (the per-slot prefix
   gather sum, ``ops/costs.py``);
3. q update ``q = damp·q + (1−damp)·norm(belief_e − r)``, with the
   broadcast-back gather ``belief_e = belief[:, edge_var]`` (in the
   message dtype) read inside it: the CUDA kernel on the card and its
   plain version on the CPU, for every problem; in f32, except for a
   bf16 belief (bf16 tables) outside the factor-kernel gate, which the
   JAX package computes in XLA in bf16: there the kernel rounds every
   operation to bf16 (``per_op``);
4. value selection ``values = argmin_d belief``.

Messages are stored in ``msg_dtype`` (f32 or bf16); the belief
accumulates in the unary's dtype.  One round = 2·n_real_edges directed
messages.  Deterministic: the round's generator is not used.  The state
takes no restart axis yet (``RESTARTS = False``): the kernels take
``[d, m]`` column blocks, and a restart axis needs its own layout.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from pydcop_tpu_torch.algorithms import AlgoParameterDef
from pydcop_tpu_torch.ops import costs as _costs
from pydcop_tpu_torch.ops import maxsum_kernels
from pydcop_tpu_torch.ops import semiring as _semiring
from pydcop_tpu_torch.ops.compile import CompiledProblem
from pydcop_tpu_torch.ops.padding import as_table_dtype

GRAPH_TYPE = "factor_graph"

RESTARTS = False

algo_params = [
    AlgoParameterDef("damping", "float", None, 0.5),
    # per-(variable, value) perturbation added to the unary costs inside
    # the message math only — breaks ties; reported costs stay exact
    AlgoParameterDef("noise", "float", None, 0.001),
    AlgoParameterDef("initial", "str", ["declared", "random", "zero"], "zero"),
    # belief-aggregation lowering: 'blockdiag' is not ported yet
    AlgoParameterDef("belief", "str", ["auto", "blockdiag"], "auto"),
    # message storage dtype; arithmetic stays f32
    AlgoParameterDef("msg_dtype", "str", ["f32", "bf16"], "f32"),
    # branch-and-bound pruning of the generic factor path: messages are
    # bit-identical either way, so the port computes the unpruned form
    AlgoParameterDef("bnb", "str", ["auto", "on", "off"], "auto"),
    # host-runtime island scheduling (not used by the batched engine)
    AlgoParameterDef("island_rounds", "int", None, 4),
    AlgoParameterDef("island_start_rounds", "int", None, 64),
]


def _msg_dtype(problem: CompiledProblem, params: Dict[str, Any]):
    if as_table_dtype(params.get("msg_dtype"), allowed=("f32", "bf16")) == "bf16":
        return torch.bfloat16
    return problem.unary.dtype


def _check_params(params: Dict[str, Any]) -> None:
    if params.get("belief", "auto") == "blockdiag":
        raise NotImplementedError(
            "maxsum belief='blockdiag' is not ported yet — see "
            "ROADMAP.md, 'belief=blockdiag'"
        )


def init_state(
    problem: CompiledProblem,
    seed: int,
    params: Dict[str, Any],
    batch: Tuple[int, ...] = (),
) -> Dict[str, torch.Tensor]:
    """Zero messages, initial values, and the noise ``[d, n_vars]``.

    Random draws come from a CPU ``torch.Generator`` seeded with
    ``seed`` and are then moved to the problem's device, so a card run
    and a CPU run start from the same state.  (They are not the JAX
    package's draws: tests hand both packages the same numpy state.)
    ``batch`` must be ``()`` (``RESTARTS`` is False; the engine checks).
    """
    _check_params(params)
    dev = problem.device
    E, d, n = problem.n_edges, problem.d_max, problem.n_vars
    gen = torch.Generator().manual_seed(int(seed))
    noise = params.get("noise", 0.0) * torch.rand(
        (d, n), generator=gen, dtype=torch.float32
    )
    initial = params.get("initial", "zero")
    if initial == "random":
        sizes = problem.domain_sizes.cpu().to(torch.float64)
        u = torch.rand(n, generator=gen, dtype=torch.float64)
        values = torch.floor(u * sizes).to(torch.int32).to(dev)
    elif initial == "declared":
        values = problem.init_idx.clone()
    else:  # "zero"
        values = torch.zeros_like(problem.init_idx)
    mdt = _msg_dtype(problem, params)
    return {
        "q": torch.zeros((d, E), dtype=mdt, device=dev),
        "r": torch.zeros((d, E), dtype=mdt, device=dev),
        "values": values,
        "noise": noise.to(device=dev, dtype=problem.unary.dtype),
    }


def in_kernel_gate(problem: CompiledProblem) -> bool:
    """The JAX package's ``use_fused`` gate without its device condition:
    one shard, every bucket binary, and ``d ≤ MAX_D``."""
    return (
        problem.n_shards == 1
        and set(problem.buckets) == {2}
        and problem.d_max <= maxsum_kernels.MAX_D
    )


def use_kernels(problem: CompiledProblem) -> bool:
    """The factor kernels run: tensors on the card, inside the gate."""
    return problem.device.type == "cuda" and in_kernel_gate(problem)


def belief_from_r(
    problem: CompiledProblem,
    r: torch.Tensor,
    unary_t: torch.Tensor,
    mode: str = "auto",
) -> torch.Tensor:
    """[d, n_vars] belief: ``unary_t`` + Σ incoming r per variable,
    accumulated in ``unary_t``'s dtype (f32) whatever r's dtype.

    One lowering on every device: the per-slot prefix gather sum of
    ``ops/costs.py:gather_sum_slots`` (deterministic, so card and CPU
    runs agree bit for bit)."""
    _check_params({"belief": mode})
    return _costs.gather_sum_slots(problem, r, unary_t)


def step(
    problem: CompiledProblem,
    state: Dict[str, torch.Tensor],
    params: Dict[str, Any],
    gen: Optional[torch.Generator] = None,
) -> Dict[str, torch.Tensor]:
    q = state["q"]
    mdt = q.dtype
    damping = float(params["damping"])
    unary_t = problem.unary_t + state["noise"]  # [d, n]
    fused = use_kernels(problem)

    # -- 1. factor -> variable, per arity bucket ----------------------
    r_new = torch.empty_like(q)
    off = 0
    for k, bucket in sorted(problem.buckets.items()):
        m = bucket.n_cons
        tab = bucket.tables_t
        q_pos = [q[:, off + p * m : off + (p + 1) * m] for p in range(k)]
        r_pos = [r_new[:, off + p * m : off + (p + 1) * m] for p in range(k)]
        if fused:  # k == 2 by the gate; the kernels write into r_new
            if bucket.shared_table:
                maxsum_kernels.factor_round_binary_shared(
                    tab[..., 0], q_pos[0], q_pos[1], out=tuple(r_pos)
                )
            else:
                maxsum_kernels.factor_round_binary(
                    tab, q_pos[0], q_pos[1], out=tuple(r_pos)
                )
        else:
            outs = _semiring.bp_factor_messages(
                _semiring.MIN_SUM, tab, q_pos, mdt
            )
            for dst, src in zip(r_pos, outs):
                dst.copy_(src)
        off += m * k

    # -- 2. variable -> factor + value selection ----------------------
    belief = belief_from_r(problem, r_new, unary_t, params.get("belief", "auto"))
    # outside the gate the JAX package computes in the belief's dtype
    per_op = belief.dtype == torch.bfloat16 and not in_kernel_gate(problem)
    # the q update reads belief[:, edge_var] (in the message dtype) itself
    q_new = maxsum_kernels.q_update(
        belief, problem.edge_var, r_new, q, damping, per_op
    )
    values = torch.argmin(belief, dim=0).to(state["values"].dtype)
    return {**state, "q": q_new, "r": r_new, "values": values}


def messages_per_round(
    problem: CompiledProblem, params: Optional[Dict[str, Any]] = None
) -> int:
    """q and r per REAL directed edge per round."""
    return 2 * problem.n_real_edges
