"""The semiring contraction core at min-sum (part of
``pydcop_tpu/ops/semiring.py``).

Two min-sum operations of the JAX module, in plain PyTorch:

- :func:`bp_factor_messages` — factor→variable belief-propagation
  messages, the generic factor path of ``algorithms/maxsum.step`` (for
  buckets of arity other than 2, for domains above the kernels'
  ``MAX_D``, and for every bucket on the CPU), the counterpart of the XLA
  path the JAX package takes outside its Pallas kernels;
- :func:`contraction_kernel` — DPOP's UTIL join + projection + argmin +
  decision margin for one level-pack bucket
  (``algorithms/dpop.py``), the counterpart of the jitted XLA
  contraction the JAX package dispatches per bucket.

Only ``min_sum`` is ported: the other semirings (``max_sum``,
``log_sum_exp``, ``marginals``, ``expectation``, ``kbest:<k>``) and the
``contract_sweep``/``infer`` machinery raise ``NotImplementedError``
(ROADMAP.md, item 10).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Semiring:
    """One ``(⊕, ⊗)`` pair in log-domain representation (``⊗ = +``),
    known by its name; the JAX package's algebra fields come with the
    semirings that read them."""

    name: str


#: exact optimization over costs — DPOP's UTIL join and Max-Sum's
#: factor phase
MIN_SUM = Semiring("min_sum")

#: the JAX package's other registered semirings (not ported)
_NOT_PORTED = ("max_sum", "log_sum_exp", "marginals", "expectation")


def get_semiring(name) -> Semiring:
    """``"min_sum"`` (or :data:`MIN_SUM`) → :data:`MIN_SUM`; the JAX
    package's other semirings raise ``NotImplementedError``."""
    if isinstance(name, Semiring):
        if name != MIN_SUM:
            raise NotImplementedError(_not_ported(name.name))
        return name
    if name == MIN_SUM.name:
        return MIN_SUM
    if name in _NOT_PORTED or (
        isinstance(name, str) and name.startswith("kbest:")
    ):
        raise NotImplementedError(_not_ported(name))
    raise ValueError(
        f"unknown semiring {name!r} (ported: ['min_sum'])"
    )


def _not_ported(name) -> str:
    return (
        f"semiring {name!r} is not ported yet: only min_sum runs in the "
        "port (see ROADMAP A10)"
    )


# -- branch-and-bound mode vocabulary ----------------------------------

BNB_MODES = ("auto", "on", "off")


def as_bnb(value, default: str = "auto") -> str:
    """Normalize a ``bnb`` knob value to ``'auto'|'on'|'off'``."""
    if value is None:
        return default
    if value is True:
        return "on"
    if value is False:
        return "off"
    v = str(value).lower()
    if v not in BNB_MODES:
        raise ValueError(
            f"bnb must be one of {BNB_MODES}, got {value!r}"
        )
    return v


def _finite_amax(a) -> float:
    """max |finite entries| of a numpy table (±inf entries are hard
    constraints and guards, structure rather than a rounding scale)."""
    a = np.asarray(a)
    if a.size == 0:
        return 0.0
    m = np.abs(a[np.isfinite(a)])
    return float(m.max()) if m.size else 0.0


# -- the min-sum contraction --------------------------------------------


def contraction_kernel(
    sr,
    shape: Tuple[int, ...],
    part_shapes: Tuple[Tuple[int, ...], ...],
    batched: bool = False,
) -> Callable[..., Tuple[torch.Tensor, torch.Tensor]]:
    """The contraction for one ``(joined shape, aligned part shapes)``
    bucket: a callable on f32 tensors, one per part, returning
    ``(amin, margins)``.

    - ``j = zeros(shape) + t0 + t1 + …`` in part order, each part
      broadcast over its size-1 (aligned) axes.  XLA folds the JAX
      source's ``zeros + t0`` into ``t0`` (a ``-0.0`` cell stays
      ``-0.0``), so the port starts from ``t0`` broadcast, which gives
      the same bits;
    - ``amin = argmin(j, -1)`` (int64; the first index wins ties, and a
      NaN cell wins as NumPy's argmin does), ``u = min(j, -1)``;
    - ``margins = min(where(one_hot(amin), +inf, j), -1) − u``, the gap
      to the second best; all ``+inf`` when the own axis has one value.

    The projected values ``u`` are not returned: DPOP re-evaluates them
    exactly on the host at the certified argmin.  ``batched=True`` takes
    a leading stack axis on every part (the JAX package's ``vmap``).
    The work runs on the device the parts are on, in eager PyTorch
    operations — the JAX package's is jitted XLA, with no Pallas kernel.
    """
    sr = get_semiring(sr)
    shape = tuple(shape)
    part_shapes = tuple(tuple(p) for p in part_shapes)
    if not part_shapes:
        raise ValueError("a contraction needs at least one part")
    d = shape[-1]

    def contract(*tabs: torch.Tensor):
        if len(tabs) != len(part_shapes):
            raise ValueError(
                f"expected {len(part_shapes)} parts, got {len(tabs)}"
            )
        lead = tuple(tabs[0].shape[:1]) if batched else ()
        for t, ps in zip(tabs, part_shapes):
            if tuple(t.shape) != lead + ps or t.dtype != torch.float32:
                raise ValueError(
                    f"part {tuple(t.shape)} {t.dtype}: expected "
                    f"{lead + ps} float32"
                )
        dev = tabs[0].device
        j = tabs[0].expand(lead + shape)
        for t in tabs[1:]:
            j = j + t  # aligned: broadcast over missing axes
        u = j.amin(dim=-1)
        amin = j.argmin(dim=-1)
        if d == 1:
            margins = torch.full(
                lead + shape[:-1], float("inf"), dtype=torch.float32,
                device=dev,
            )
        else:
            one_hot = (
                torch.arange(d, device=dev) == amin.unsqueeze(-1)
            )
            second = torch.where(one_hot, float("inf"), j).amin(dim=-1)
            margins = second - u
        return amin, margins

    return contract


# -- Max-Sum's factor phase ---------------------------------------------


def bp_factor_messages(
    sr,
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
    per-position ``[..., d, m]`` messages (leading batch axes, e.g.
    restarts and instances, with ``tab`` broadcastable over them);
    returns the ``k`` outgoing messages in ``mdt``.

    ``bnb`` is accepted for parameter parity.  The JAX package's
    branch-and-bound pruning returns messages bit-identical to the
    unpruned form (pruned configurations are strictly worse than every
    output's optimum), so this port computes the unpruned form for
    either value; the pruned kernel is a later port item.
    """
    get_semiring(sr)
    del bnb  # bit-identical messages either way (see docstring)
    k = len(q_pos)
    lead = tuple(q_pos[0].shape[:-2])
    d, m = q_pos[0].shape[-2:]
    s = tab
    for p in range(k):
        shape = lead + (1,) * p + (d,) + (1,) * (k - 1 - p) + (m,)
        s = s + q_pos[p].to(tab.dtype).reshape(shape)
    outs = []
    for p in range(k):  # position a's axis is a - k - 1
        axes = tuple(a - k - 1 for a in range(k) if a != p)
        rp = s.amin(dim=axes) - q_pos[p].to(tab.dtype)
        rp = rp - rp.amin(dim=-2, keepdim=True)
        outs.append(rp.to(mdt))
    return outs
