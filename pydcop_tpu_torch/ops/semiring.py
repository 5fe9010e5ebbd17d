"""Factor→variable belief-propagation messages at min-sum.

Port of ``pydcop_tpu/ops/semiring.py:bp_factor_messages`` reduced to the
one semiring Max-Sum uses (``min_sum``), in plain PyTorch.  It is the
generic factor path of ``algorithms/maxsum.step`` — for buckets of arity
other than 2, for domains above the kernels' ``MAX_D``, and for every
bucket on the CPU — the counterpart of the XLA path the
JAX package takes outside its Pallas kernels.  The rest of the semiring
core (other semirings, the contraction sweeps) is a later port item.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

MIN_SUM = "min_sum"


def bp_factor_messages(
    sr: str,
    tab: torch.Tensor,
    q_pos: Sequence[torch.Tensor],
    mdt: torch.dtype,
    bnb: bool = False,
) -> List[torch.Tensor]:
    """The standard sum-then-subtract marginalization for one arity
    bucket: ``S = table + Σ_p q_p`` (broadcast over the bucket's axes,
    added in the order ``((tab + q0) + q1) + …``), ``M_p = min`` over all
    axes but ``p``, ``r_p = M_p − q_p``, then min-normalized per edge.

    ``tab`` is the bucket's ``[d, ..., d, m]`` table stack (or
    ``[d, ..., d, 1]`` for a shared table), ``q_pos`` the ``k``
    per-position ``[d, m]`` messages; returns the ``k`` outgoing
    ``[d, m]`` messages in ``mdt``.

    ``bnb`` is accepted for parameter parity.  The JAX package's
    branch-and-bound pruning returns messages bit-identical to the
    unpruned form (pruned configurations are strictly worse than every
    output's optimum), so this port computes the unpruned form for
    either value; the pruned kernel is a later port item.
    """
    if sr != MIN_SUM:
        raise NotImplementedError(
            f"semiring {sr!r}: only min_sum is ported (Max-Sum's factor "
            "phase); the semiring core is a later port item"
        )
    del bnb  # bit-identical messages either way (see docstring)
    k = len(q_pos)
    d, m = q_pos[0].shape
    s = tab
    for p in range(k):
        shape = (1,) * p + (d,) + (1,) * (k - 1 - p) + (m,)
        s = s + q_pos[p].to(tab.dtype).reshape(shape)
    outs = []
    for p in range(k):
        axes = tuple(a for a in range(k) if a != p)
        rp = s.amin(dim=axes) - q_pos[p].to(tab.dtype)
        rp = rp - rp.amin(dim=0, keepdim=True)
        outs.append(rp.to(mdt))
    return outs
