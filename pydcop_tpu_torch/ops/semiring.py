"""The semiring contraction core (port of ``pydcop_tpu/ops/semiring.py``).

DPOP's join+project+argmin, Max-Sum's factor marginalization and exact
probabilistic inference are instances of one aggregate query: a semiring
contraction over an elimination order.  This module holds, as the JAX
module does:

- the :class:`Semiring` registry in log-domain representation (``⊗`` is
  ``+``): ``min_sum`` (exact optimization, DPOP's UTIL join),
  ``max_sum`` (MAP), ``log_sum_exp`` (the partition function
  ``log Z``), ``marginals`` (normalized ``+/×``), ``expectation``
  (first-order expectation pairs ``(log w, E[cost])``) and the
  parametric top-K semirings ``kbest:<k>``, with their host-f64 algebra;
- :func:`contraction_kernel` — the device contraction for one ``(joined
  shape, aligned part shapes)`` bucket per semiring, in eager PyTorch
  operations on the device the parts are on (the JAX package's is jitted
  XLA, with no Pallas kernel);
- :func:`bp_factor_messages` — Max-Sum's factor phase as a contraction;
- the elimination-order planners :func:`min_fill_order` and
  :func:`build_plan` (``pseudo_tree`` and ``min_fill`` orders, the
  two-block order of ``marginal_map``, ``external_dists`` for
  ``expectation``);
- :func:`contract_sweep` and :func:`run_infer_many` — the merged
  multi-instance sweep behind ``api.infer``/``api.infer_many``: waves by
  node height, device contractions bucketed across instances by
  level-pack key (``ops/padding.py:util_level_key``) and run as one
  stacked dispatch per bucket, with one packed host-to-device copy.

Precision contract, per ``⊕``, as in the JAX package:

- **Idempotent ⊕ (min, max) and kbest** — the f32 exactness
  certificate: the device returns the arg-reduce and each cell's
  decision margin; a margin ≥ 2·(#parts+1)·eps32·Σmax|part| proves the
  f32 arg equals the true arg, near-ties are repaired on the host, and
  the projected values are re-evaluated on the host in exact f64 at the
  certified arg.
- **logsumexp ⊕** — error-bound accounting: each contraction carries an
  accumulated log-domain bound; a contraction whose bound would exceed
  ``tol`` runs on host f64 (``semiring.logsumexp_repairs``) and the
  result reports the final ``error_bound``.

Storage of the device parts (``table_dtype``, ``table_format``): bf16
and int8 packs with an f32 join and certificates widened to the storage
precision, and sparse COO tables joined over candidate lists
(``ops/sparse.py``); the memory-bounded sweep ``max_util_bytes`` lives
in ``ops/membound.py`` and runs :func:`contract_sweep` with
``on_oom="raise"``.

Branch-and-bound pruning (``bnb``): :class:`_BnbContext` (a greedy
incumbent and subtree rest bounds, host f64) gives each device row a
budget, and the two-pass form of :func:`contraction_kernel` masks the
rows that provably cannot matter, the results bit-identical for min,
max and kbest and the discarded mass accounted for the mass kinds.
"""

from __future__ import annotations

import dataclasses
import difflib
import time
from typing import (
    Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple,
)

import numpy as np
import torch

from pydcop_tpu_torch.engine.supervisor import DeviceOOMError, get_supervisor
from pydcop_tpu_torch.ops.costs import fixed_order_sum
from pydcop_tpu_torch.ops.padding import (
    INT8_NEG_INF,
    INT8_POS_INF,
    NO_PADDING,
    PadPolicy,
    as_pad_policy,
    as_table_dtype,
    bucket_util_shape,
    int8_quant_bound,
    pad_util_parts,
    quantize_table_int8,
    stack_bucket,
    table_dtype_bytes,
    table_dtype_eps,
    util_level_key,
)
from pydcop_tpu_torch.ops.sparse import (
    SparseTable,
    as_table_format,
    pack_table,
    sparse_contraction_kernel,
    sparse_node_prep,
    storage_dtype,
)

_EPS32 = float(np.finfo(np.float32).eps)
_EPS64 = float(np.finfo(np.float64).eps)


# -- the semiring registry ---------------------------------------------


def _np_logsumexp(a: np.ndarray, axis=None, keepdims: bool = False):
    """Stable host-f64 logsumexp: max-shifted, and an all-``-inf``
    slice reduces to ``-inf`` (no ``nan`` from ``-inf - -inf``)."""
    a = np.asarray(a, dtype=np.float64)
    m = np.max(a, axis=axis, keepdims=True)
    m = np.where(np.isfinite(m), m, 0.0)
    with np.errstate(divide="ignore"):  # log(0) = -inf is the reduce
        # of an all--inf slice
        out = np.log(
            np.sum(np.exp(a - m), axis=axis, keepdims=True)
        ) + m
    if not keepdims:
        out = np.squeeze(
            out, axis=tuple(range(a.ndim)) if axis is None else axis
        )
    return out


def _norm_cell_axes(axis, n_dims: int) -> Tuple[int, ...]:
    """Normalize a reduce ``axis`` spec against the DIM axes of a
    cell-carrying array (the trailing cell axis is never reduced;
    negative indices count from the last dim axis).  Out-of-range axes
    raise, as numpy does on a scalar-cell array."""
    if axis is None:
        return tuple(range(n_dims))
    if isinstance(axis, int):
        axis = (axis,)
    for a in axis:
        if not -n_dims <= a < n_dims:
            raise np.exceptions.AxisError(a, n_dims)
    return tuple(sorted(a % n_dims for a in axis))


def _kbest_sorted(a: np.ndarray, k: int) -> np.ndarray:
    """The k smallest of the candidate axis, sorted ascending (the
    top-K ⊕ primitive: stable, +inf-padded when candidates run out)."""
    out = np.sort(a, axis=-1, kind="stable")[..., :k]
    if out.shape[-1] < k:
        pad = np.full(
            out.shape[:-1] + (k - out.shape[-1],), np.inf
        )
        out = np.concatenate([out, pad], axis=-1)
    return out


def _exp_pair_reduce(a: np.ndarray, axes: Tuple[int, ...]):
    """⊕-reduce of expectation pairs ``(log w, r)`` over dim ``axes``:
    ``log w`` reduces by stable logsumexp, ``r`` by the matching
    softmax-weighted combine (the normalized ``(log W, Σwr/W)`` form)."""
    lw = np.asarray(a[..., 0], dtype=np.float64)
    r = np.asarray(a[..., 1], dtype=np.float64)
    m = np.max(lw, axis=axes, keepdims=True)
    safe_m = np.where(np.isfinite(m), m, 0.0)
    w = np.exp(lw - safe_m)
    s = np.sum(w, axis=axes, keepdims=True)
    with np.errstate(divide="ignore"):
        lw_out = np.where(np.isfinite(m), safe_m + np.log(s), m)
    # a zero-weight cell contributes nothing whatever its r plane holds:
    # hard-constraint pairs are (-inf, +inf), and 0·inf would be NaN
    with np.errstate(invalid="ignore"):
        wr = np.where(w > 0, w * r, 0.0)
    r_out = np.where(
        s > 0, np.sum(wr, axis=axes, keepdims=True)
        / np.where(s > 0, s, 1.0), 0.0,
    )
    lw_out = np.squeeze(lw_out, axis=axes)
    r_out = np.squeeze(r_out, axis=axes)
    return np.stack([lw_out, r_out], axis=-1)


@dataclasses.dataclass(frozen=True)
class Semiring:
    """One ``(⊕, ⊗)`` pair in LOG-DOMAIN representation (``⊗ = +``).

    ``idempotent`` ⊕ (min/max) supports an arg-reduce and the f32
    exactness certificate; non-idempotent ⊕ (logsumexp) uses error-bound
    accounting.  ``normalize`` marks the marginal-inference variant.
    ``kind``/``cell_width`` extend the algebra to STRUCTURED cells, a
    trailing static value axis of width ``cell_width`` on every cell:
    ``"scalar"`` (one float), ``"kbest"`` (the k best partial costs,
    ascending, +inf-padded; ⊕ merges, ⊗ cross-sums and truncates) and
    ``"expectation"`` (the pair ``(log w, r)`` with ``r = Σw·cost/w``).
    """

    name: str
    idempotent: bool
    maximize: bool = False  # direction of an idempotent ⊕
    normalize: bool = False
    doc: str = ""
    kind: str = "scalar"  # "scalar" | "kbest" | "expectation"
    cell_width: int = 1  # trailing static value axis per cell

    # -- algebra (log domain) ------------------------------------------

    @property
    def plus_identity(self) -> float:
        """Identity of ``⊕`` (the annihilator of ``⊗``); for structured
        cells the scalar every component of the identity cell holds
        (kbest: +inf) or that annihilates the weight plane
        (expectation: -inf) — what the ghost-guard mask adds."""
        if self.kind == "kbest":
            return float(np.inf)
        if self.idempotent and not self.maximize:
            return float(np.inf)
        return float(-np.inf)

    @property
    def times_identity(self) -> float:
        """Identity of ``⊗`` (log-domain ``+``)."""
        return 0.0

    @property
    def error_bounded(self) -> bool:
        """Whether this ⊕ runs under error-BOUND accounting (the ``tol``
        device gate) rather than an exactness certificate; kbest is
        certified per component."""
        return not self.idempotent and self.kind != "kbest"

    def identity_cell(self) -> np.ndarray:
        """The ⊕-identity as one cell (length ``cell_width``)."""
        if self.kind == "expectation":
            return np.array([-np.inf, 0.0])
        return np.full(self.cell_width, self.plus_identity)

    def times_identity_cell(self) -> np.ndarray:
        """The ⊗-identity as one cell (length ``cell_width``)."""
        cell = np.zeros(self.cell_width)
        if self.kind == "kbest" and self.cell_width > 1:
            cell[1:] = np.inf
        return cell

    def add(self, a, b):
        """Elementwise ``⊕`` (host f64).  Structured kinds take
        cell-carrying arrays (trailing axis ``cell_width``)."""
        if self.kind == "kbest":
            return _kbest_sorted(
                np.concatenate(
                    [
                        np.asarray(a, dtype=np.float64),
                        np.asarray(b, dtype=np.float64),
                    ],
                    axis=-1,
                ),
                self.cell_width,
            )
        if self.kind == "expectation":
            return _exp_pair_reduce(
                np.stack(
                    [
                        np.asarray(a, dtype=np.float64),
                        np.asarray(b, dtype=np.float64),
                    ]
                ),
                (0,),
            )
        if self.idempotent:
            return (np.maximum if self.maximize else np.minimum)(a, b)
        return _np_logsumexp(np.stack([a, b]), axis=0)

    def combine(self, a, b):
        """Elementwise ``⊗`` (host f64): ``+`` in the log domain;
        cross-sum-truncate for kbest cells, per-plane ``+`` for
        expectation pairs."""
        if self.kind == "kbest":
            a = np.asarray(a, dtype=np.float64)
            b = np.asarray(b, dtype=np.float64)
            sums = a[..., :, None] + b[..., None, :]
            return _kbest_sorted(
                sums.reshape(sums.shape[:-2] + (-1,)), self.cell_width
            )
        if self.kind == "expectation":
            a = np.asarray(a, dtype=np.float64)
            b = np.asarray(b, dtype=np.float64)
            return a + b  # both planes add: log w multiplies, r sums
        return np.asarray(a, dtype=np.float64) + np.asarray(
            b, dtype=np.float64
        )

    def reduce(self, a, axis=None, keepdims: bool = False):
        """``⊕``-projection over ``axis`` (host f64).  For structured
        kinds ``axis`` names DIM axes (the trailing cell axis is carried,
        never reduced); ``keepdims`` applies to the dim axes."""
        if self.kind == "kbest":
            a = np.asarray(a, dtype=np.float64)
            axes = _norm_cell_axes(axis, a.ndim - 1)
            if not axes:
                return a
            dst = tuple(range(a.ndim - 1 - len(axes), a.ndim - 1))
            moved = np.moveaxis(a, axes, dst)
            flat = moved.reshape(moved.shape[: dst[0]] + (-1,))
            out = _kbest_sorted(flat, self.cell_width)
            if keepdims:
                for ax in axes:
                    out = np.expand_dims(out, axis=ax)
            return out
        if self.kind == "expectation":
            a = np.asarray(a, dtype=np.float64)
            axes = _norm_cell_axes(axis, a.ndim - 1)
            if not axes:
                return a
            out = _exp_pair_reduce(a, axes)
            if keepdims:
                for ax in axes:
                    out = np.expand_dims(out, axis=ax)
            return out
        if self.idempotent:
            fn = np.max if self.maximize else np.min
            return fn(a, axis=axis, keepdims=keepdims)
        return _np_logsumexp(a, axis=axis, keepdims=keepdims)

    def arg_reduce(self, a, axis: int = -1):
        """Argmin/argmax over ``axis`` — idempotent ⊕ only."""
        if not self.idempotent:
            raise ValueError(
                f"semiring {self.name!r}: ⊕ is not idempotent — there "
                "is no arg to reduce to"
            )
        return (np.argmax if self.maximize else np.argmin)(a, axis=axis)

    def shift_of(self, a: np.ndarray) -> float:
        """Message-normalization offset: min for ``min/+``, max
        otherwise (also the logsumexp stability shift); structured cells
        shift on their leading component, ignoring non-finite entries."""
        if a.size == 0:
            return 0.0
        if self.kind in ("kbest", "expectation"):
            lead = np.asarray(a[..., 0], dtype=np.float64)
            lead = lead[np.isfinite(lead)]
            if lead.size == 0:
                return 0.0
            return float(
                lead.min() if self.kind == "kbest" else lead.max()
            )
        if self.idempotent and not self.maximize:
            return float(a.min())
        return float(a.max())

    def apply_shift(self, a: np.ndarray, shift: float) -> np.ndarray:
        """⊗-divide a message by the scalar ``shift``: scalar and kbest
        cells subtract it from every component, the expectation pair
        from its log-weight plane only."""
        if self.kind == "expectation":
            out = np.array(a, dtype=np.float64)
            out[..., 0] -= shift
            return out
        return a - shift

    def torch_reduce(self, a: torch.Tensor, axis, keepdims: bool = False):
        """``⊕``-projection of a scalar-cell tensor (the factor phase)."""
        if self.idempotent:
            fn = torch.amax if self.maximize else torch.amin
            return fn(a, dim=axis, keepdim=keepdims)
        m = torch.amax(a, dim=axis, keepdim=True)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        out = torch.log(torch.exp(a - m).sum(dim=axis, keepdim=True)) + m
        if keepdims:
            return out
        axes = (axis,) if isinstance(axis, int) else tuple(axis)
        return out.squeeze(axes)


SEMIRINGS: Dict[str, Semiring] = {}


def register_semiring(sr: Semiring) -> Semiring:
    """Add a semiring to the registry (``get_semiring`` name lookup)."""
    SEMIRINGS[sr.name] = sr
    return sr


def _did_you_mean(name: str, candidates: Sequence[str]) -> str:
    """One nearest-name hint for unknown-name errors."""
    close = difflib.get_close_matches(
        str(name), list(candidates), n=1, cutoff=0.55
    )
    return f" — did you mean {close[0]!r}?" if close else ""


def get_semiring(name) -> Semiring:
    """A registered semiring by name (or the :class:`Semiring` itself);
    ``"kbest:<k>"`` registers its width on first use."""
    if isinstance(name, Semiring):
        return name
    got = SEMIRINGS.get(name)
    if got is not None:
        return got
    if isinstance(name, str) and name.startswith("kbest:"):
        try:
            k = int(name.split(":", 1)[1])
        except ValueError:
            raise ValueError(
                f"malformed kbest semiring {name!r} — the width is "
                "an integer, e.g. 'kbest:5'"
            )
        return kbest_semiring(k)
    raise ValueError(
        f"unknown semiring {name!r} (registered: "
        f"{sorted(SEMIRINGS)}, plus parametric 'kbest:<k>')"
        + _did_you_mean(name, sorted(SEMIRINGS) + ["kbest:5"])
    )


MIN_SUM = register_semiring(
    Semiring(
        "min_sum", idempotent=True, maximize=False,
        doc="exact optimization over costs — DPOP's UTIL join",
    )
)
MAX_SUM = register_semiring(
    Semiring(
        "max_sum", idempotent=True, maximize=True,
        doc="MAP over log-weights (max/x in log space)",
    )
)
LOG_SUM_EXP = register_semiring(
    Semiring(
        "log_sum_exp", idempotent=False,
        doc="weighted counting: partition function log Z (+/x via "
        "stable logsumexp)",
    )
)
MARGINALS = register_semiring(
    Semiring(
        "marginals", idempotent=False, normalize=True,
        doc="+/x with message normalization — marginal inference",
    )
)
EXPECTATION = register_semiring(
    Semiring(
        "expectation", idempotent=False, kind="expectation",
        cell_width=2,
        doc="first-order expectation pairs (log w, E[cost]) — E[cost] "
        "under the Gibbs distribution and optional stochastic "
        "externals",
    )
)

#: widest registered top-K cell
KBEST_MAX = 64


def kbest_semiring(k: int) -> Semiring:
    """The top-K semiring for width ``k`` (registered on first use)."""
    k = int(k)
    if not 2 <= k <= KBEST_MAX:
        raise ValueError(
            f"kbest wants 2 <= k <= {KBEST_MAX}, got {k} (k=1 is "
            "query='map')"
        )
    name = f"kbest:{k}"
    got = SEMIRINGS.get(name)
    if got is None:
        got = register_semiring(
            Semiring(
                name, idempotent=False, kind="kbest", cell_width=k,
                doc="top-K cost tuples: ⊕ merge-sorts k-vectors, ⊗ "
                "cross-sums and truncates — the K best assignments",
            )
        )
    return got


# query name (api.infer) -> the semiring its sweep runs on
QUERY_SEMIRINGS = {
    "map": "max_sum",
    "log_z": "log_sum_exp",
    "marginals": "marginals",
    "expectation": "expectation",
}

#: every query ``api.infer`` understands (``kbest:<k>`` is parametric;
#: ``marginal_map`` rides max/+ with a two-block order)
KNOWN_QUERIES = (
    "map", "log_z", "marginals", "marginal_map", "expectation",
    "kbest:<k>",
)


def parse_query(query: str) -> Tuple[str, Semiring]:
    """Resolve an ``api.infer`` query string to ``(kind, semiring)``
    (``kind`` is ``"kbest"`` for any ``kbest:<k>``).  Unknown queries
    fail with the nearest known name suggested."""
    if query in QUERY_SEMIRINGS:
        return query, get_semiring(QUERY_SEMIRINGS[query])
    if query == "marginal_map":
        return "marginal_map", get_semiring("max_sum")
    if isinstance(query, str) and (
        query == "kbest" or query.startswith("kbest:")
    ):
        if query == "kbest":
            k = 5  # the documented default width
        else:
            try:
                k = int(query.split(":", 1)[1])
            except ValueError:
                raise ValueError(
                    f"malformed query {query!r} — the kbest width is "
                    "an integer, e.g. 'kbest:5'"
                )
        return "kbest", kbest_semiring(k)
    known = [q for q in KNOWN_QUERIES if "<" not in q] + ["kbest:5"]
    raise ValueError(
        f"unknown query {query!r} (expected one of "
        f"{sorted(KNOWN_QUERIES)})" + _did_you_mean(query, known)
    )


# -- branch-and-bound pruning (the two-pass ⊕-bounded kernels) ----------
#
# arXiv:1906.06863 accelerates BP-based DCOP algorithms generically by
# branch-and-bound INSIDE the marginalization: most rows of a
# high-arity join can be skipped because a cheap per-row ⊕-bound
# already proves they cannot matter.  Here that becomes a TWO-PASS
# kernel behind :func:`contraction_kernel` (``bnb=True``):
#
# - **pass 1** computes a per-row (= per kept-configuration) bound —
#   in-kernel it is the joined row's own ⊕-extremum (free: the
#   value-carrying kinds' outputs bound their rows, and the arg-only
#   idempotent kernels reduce the join to it anyway); the DPOP sweep's
#   host-side pass 1 uses per-part own-axis extrema instead (O(Σ part
#   sizes), no join materialized) — compared against a per-row
#   ``budget`` derived from the incumbent (a greedy full assignment
#   evaluated exactly on the host, :class:`_BnbContext`);
# - **pass 2** runs the dense join+project with the pruned rows
#   masked to the ⊕-identity (``torch.where``: the shapes do not
#   change, so the level-pack lattice and the stacked/membound-lane
#   machinery are untouched).
#
# Exactness, per ⊕ (the JAX package's docs/semirings.md,
# "Branch-and-bound pruning"):
# idempotent ⊕ (min/max) prunes a row only when its bound plus the
# rest-of-problem bound provably exceeds the incumbent — no optimal
# assignment passes through a pruned row, so results stay
# BIT-IDENTICAL to the unpruned kernel (f32 slack folded into the
# budget keeps the comparison conservative); kbest prunes against the
# k-th incumbent (k distinct greedy variants), so the whole k-list
# survives; logsumexp/marginals/expectation prune rows whose mass
# contribution is provably negligible and ACCOUNT the discarded mass
# (the kernel returns its logsumexp) into the existing ``error_bound``
# ledger under the same ``tol`` gate.

BNB_MODES = ("auto", "on", "off")

#: ``bnb='auto'`` threshold: a dispatch whose per-row joined table
#: (level-pack padded cells × cell width) is below this keeps the
#: single-pass kernel — for small factors the bound pass, the masked
#: ``where`` and the keep-mask transfer cost more than they prune;
#: only genuinely compute-bound dispatches (~0.5 MiB of f32 per row
#: and up) can repay the two-pass overhead
#: (``semiring.bnb_skipped_small`` counts the skips).
BNB_AUTO_MIN_CELLS = 1 << 17

#: pruned-row fraction at or above which pass 2 abandons the device
#: for a COMPACT host contraction of the survivors (exact f64, no
#: certificate needed): with most of the join dead, gathering the
#: surviving rows beats a dense f32 dispatch plus the dense host
#: re-evaluation glue.  Below it the masked device kernel runs and
#: the glue still compacts on the keep mask.
BNB_HOST_FRAC = 0.5


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


def greedy_assignment(
    order_rev: Sequence[str],
    domains: Mapping[str, Sequence],
    owned: Mapping[str, Sequence[Tuple[Sequence[str], np.ndarray]]],
    maximize: bool,
):
    """One cheap full assignment for the incumbent: walk ``order_rev``
    (reversed elimination order, or the pseudo-tree pre-order) and
    score each candidate value of ``v`` against EVERY part whose
    scope contains ``v`` — assigned variables fixed, unassigned ones
    ⊕-marginalized out (a one-step lookahead, so a hard-capped part
    owned further down the order steers the walk away from values
    that would doom it to ``+inf``); keep the ⊕-best (first index on
    ties — deterministic).  Returns ``(value-index assignment, exact
    f64 total over ALL parts)``.  Tables are in KERNEL domain."""
    by_var: Dict[str, list] = {}
    for parts in owned.values():
        for scope, table in parts:
            for u in scope:
                by_var.setdefault(u, []).append((scope, table))
    red = np.max if maximize else np.min
    worst = -np.inf if maximize else np.inf
    assigned: Dict[str, int] = {}
    for v in order_rev:
        d = len(domains[v])
        score = np.zeros(d, dtype=np.float64)
        for scope, table in by_var.get(v, ()):
            t = np.asarray(table, dtype=np.float64)
            idx = tuple(
                assigned[u] if u in assigned and u != v
                else slice(None)
                for u in scope
            )
            sub = t[idx]
            rem = [u for u in scope if u == v or u not in assigned]
            vax = rem.index(v)
            axes = tuple(a for a in range(sub.ndim) if a != vax)
            with np.errstate(invalid="ignore"):
                vec = red(sub, axis=axes) if axes else sub
            score = score + vec.reshape(d)
        # a NaN score (±inf parts cancelling) is "unknown" — rank it
        # worst so the walk prefers provably-finite values
        score = np.where(np.isnan(score), worst, score)
        assigned[v] = int(
            np.argmax(score) if maximize else np.argmin(score)
        )
    # coordinate-descent polish: re-pick each variable's ⊕-best value
    # with every other variable FIXED (exact part evaluations, no
    # marginalizing) — two sweeps close most of the greedy-vs-optimum
    # gap, and the incumbent's tightness is the pruning budget's
    # tightness
    for _ in range(2):
        changed = False
        for v in order_rev:
            d = len(domains[v])
            if d < 2:
                continue
            score = np.zeros(d, dtype=np.float64)
            for scope, table in by_var.get(v, ()):
                idx = tuple(
                    slice(None) if u == v else assigned[u]
                    for u in scope
                )
                score = score + np.asarray(
                    table, dtype=np.float64
                )[idx].reshape(d)
            score = np.where(np.isnan(score), worst, score)
            pick = int(
                np.argmax(score) if maximize else np.argmin(score)
            )
            if pick != assigned[v]:
                assigned[v] = pick
                changed = True
        if not changed:
            break
    return assigned, _eval_assignment(owned, assigned)


def _eval_assignment(owned, assigned) -> float:
    total = 0.0
    for parts in owned.values():
        for scope, table in parts:
            total += float(
                np.asarray(table, dtype=np.float64)[
                    tuple(assigned[u] for u in scope)
                ]
            )
    return total


class _BnbContext:
    """Per-instance branch-and-bound state for one sweep.

    Built from the instance's KERNEL-domain parts (energies for
    ``min_sum``/kbest, log-weights ``-β·E`` (+ log-prob parts)
    otherwise), keyed by owner node:

    - ``inc`` — the incumbent: exact f64 total of a greedy full
      assignment (an upper bound on the optimum for min, a lower
      bound for max / on ``log Z`` for the mass semirings);
      ``inc_k`` (kbest) is the k-th smallest total over k DISTINCT
      greedy variants — a valid upper bound on the k-th best cost —
      or None when the instance has fewer than k assignments;
    - ``rest[v]`` — Σ of per-part extrema over every part OUTSIDE
      ``v``'s subtree (total minus the subtree prefix sums);
    - ``rest_logdom[v]`` — Σ log|domain| over variables outside the
      subtree (the completion-count term of the mass bound);
    - ``cumshift[v]`` — shifts applied inside ``v``'s subtree so far
      (filled by the sweep as messages normalize), bridging stored
      (shifted) message values back to true subtree aggregates.

    ``budget(v, n_children_shift, n_parts, parts_max, d_own,
    n_rows)`` returns the f32-safe per-row threshold pass 1 compares
    against (conservative under f32 rounding: questionable rows are
    KEPT), or the no-prune sentinel when any input is non-finite."""

    __slots__ = (
        "sr", "tol_node", "inc", "inc_k", "rest", "rest_logdom",
        "cumshift", "table_dtype",
    )

    def __init__(
        self,
        sr: Semiring,
        order_rev: Sequence[str],
        domains: Mapping[str, Sequence],
        owned: Mapping[str, list],
        children: Mapping[str, Sequence[str]],
        tol: float = 1e-6,
        table_dtype: str = "f32",
    ):
        self.sr = sr
        # pass-1 row bounds are computed at the STORAGE dtype — the
        # budget slack widens to that dtype's roundoff (plus the int8
        # quantization term) so pruning stays conservative below f32
        self.table_dtype = as_table_dtype(table_dtype)
        self.cumshift: Dict[str, float] = {}
        n_nodes = max(len(order_rev), 1)
        self.tol_node = (
            tol / (2.0 * n_nodes) if sr.error_bounded or
            sr.kind == "expectation" else 0.0
        )
        maximize = sr.maximize or not sr.idempotent
        if sr.kind == "kbest":
            maximize = False
        assigned, inc = greedy_assignment(
            order_rev, domains, owned, maximize
        )
        self.inc = inc
        self.inc_k: Optional[float] = None
        if sr.kind == "kbest":
            self.inc_k = self._kth_incumbent(
                assigned, domains, owned, order_rev, sr.cell_width
            )
        # per-node extremum of the OWNED parts, then subtree prefix
        # sums bottom-up (order_rev reversed = children before
        # parents); rest = total - subtree
        ext: Dict[str, float] = {}
        logdom: Dict[str, float] = {}
        red = np.max if maximize else np.min
        for v in order_rev:
            e = 0.0
            for _, table in owned.get(v, ()):
                e += float(red(np.asarray(table, dtype=np.float64)))
            ext[v] = e
            logdom[v] = float(np.log(max(len(domains[v]), 1)))
        sub_ext: Dict[str, float] = {}
        sub_logdom: Dict[str, float] = {}
        for v in reversed(order_rev):  # children first
            sub_ext[v] = ext[v] + sum(
                sub_ext[c] for c in children.get(v, ())
            )
            sub_logdom[v] = logdom[v] + sum(
                sub_logdom[c] for c in children.get(v, ())
            )
        total_ext = sum(ext.values())
        total_logdom = sum(logdom.values())
        self.rest = {v: total_ext - sub_ext[v] for v in order_rev}
        self.rest_logdom = {
            v: total_logdom - sub_logdom[v] for v in order_rev
        }

    @staticmethod
    def _kth_incumbent(assigned, domains, owned, order_rev, k):
        """k DISTINCT assignments around the greedy one (vary the
        widest-domain variables combinatorially); the k-th smallest
        exact total upper-bounds the k-th best cost.  None when the
        assignment space itself has fewer than k points."""
        space = 1.0
        for v in order_rev:
            space *= max(len(domains[v]), 1)
            if space >= k:
                break
        if space < k:
            return None
        variants = [dict(assigned)]
        by_width = sorted(
            order_rev,
            key=lambda v: (-len(domains[v]), v),
        )
        for v in by_width:
            if len(variants) >= k:
                break
            d = len(domains[v])
            if d < 2:
                continue
            variants = [
                {**a, v: i} for a in variants for i in range(d)
            ]
        totals = sorted(
            _eval_assignment(owned, a) for a in variants[: 4 * k]
        )
        return totals[k - 1] if len(totals) >= k else None

    def seed_incumbent(self, owned, assigned) -> bool:
        """Adopt a caller-provided full assignment (``{var: value
        index}`` — e.g. the previous solution of a memoized serving
        session, re-evaluated under the CURRENT tables) as the
        incumbent when its exact total beats the greedy one.  Any
        full assignment's total is a valid bound, so this only ever
        tightens the budgets.  kbest keeps its own ``inc_k``
        (k-th-best bounds don't follow from one assignment)."""
        try:
            tot = _eval_assignment(owned, assigned)
        except (KeyError, IndexError):
            return False
        if not np.isfinite(tot):
            return False
        sr = self.sr
        maximize = sr.maximize or not sr.idempotent
        if sr.kind == "kbest":
            maximize = False
        if maximize:
            better = tot > self.inc
        else:
            better = tot < self.inc
        if better:
            self.inc = tot
        return better

    def no_prune(self) -> float:
        """Budget sentinel without a usable incumbent
        (:func:`_no_prune`)."""
        return _no_prune(self.sr)

    def shift_under(self, children: Sequence[str]) -> float:
        return sum(self.cumshift.get(c, 0.0) for c in children)

    def record_shift(
        self, name: str, shift: float, children: Sequence[str]
    ) -> None:
        self.cumshift[name] = shift + self.shift_under(children)

    def budget(
        self,
        name: str,
        shift_children: float,
        n_parts: int,
        parts_max: float,
        d_own: int,
        n_rows: int,
    ) -> float:
        """The per-row pass-1 threshold for node ``name`` (module
        comment above; f32 slack keeps pruning conservative)."""
        sr = self.sr
        inc = self.inc_k if sr.kind == "kbest" else self.inc
        if inc is None:
            return self.no_prune()
        rest = self.rest.get(name, 0.0)
        eps_dt = table_dtype_eps(self.table_dtype)
        slack = (
            2.0
            * (n_parts + 2)
            * eps_dt
            * (
                max(parts_max, 1.0)
                + abs(inc)
                + abs(rest)
                + abs(shift_children)
            )
        )
        if self.table_dtype == "int8":
            slack += 2.0 * int8_quant_bound(parts_max)
        if sr.idempotent or sr.kind == "kbest":
            if sr.maximize:
                b = inc - rest - shift_children - slack
            else:
                b = inc - rest - shift_children + slack
            return b if np.isfinite(b) else self.no_prune()
        # mass semirings: keep rows whose mass upper bound could
        # contribute more than tol_node relative to the incumbent's
        # exact mass (itself a lower bound on Z); log-domain terms —
        # the own-axis count, the completion count, and the row count
        # — make the per-dispatch worst case <= tol_node even before
        # the kernel measures the true discard
        b = (
            self.inc
            - shift_children
            - (rest + self.rest_logdom.get(name, 0.0))
            - float(np.log(max(d_own, 1)))
            - float(np.log(max(n_rows, 1)))
            + float(np.log(max(self.tol_node, 1e-300)))
            - slack
        )
        return b if np.isfinite(b) else self.no_prune()

    def account(
        self,
        name: str,
        disc: float,
        shift_children: float,
        d_own: int,
    ) -> float:
        """Error-ledger term for a mass dispatch's measured discard
        ``disc`` (kernel pass-1 logsumexp over pruned row bounds):
        relative discarded mass vs the incumbent's exact mass, with a
        2x inflation covering the f32 bound arithmetic."""
        if not np.isfinite(disc):  # nothing pruned
            return 0.0
        rest = self.rest.get(name, 0.0) + self.rest_logdom.get(
            name, 0.0
        )
        ln = (
            disc
            + float(np.log(max(d_own, 1)))
            + shift_children
            + rest
            - self.inc
        )
        return 2.0 * float(np.exp(min(ln, 50.0)))


def _no_prune(sr: Semiring) -> float:
    """The budget sentinel that keeps every FINITE row (±f32max/2): rows
    whose bound is already the ⊕-annihilator (``+inf`` joint
    infeasibility under min/kbest, ``-inf`` zero mass) still prune,
    exactly (their value IS the ⊕-identity; masking them only skips the
    dead work).  Pad rows of a stack carry it too."""
    big = float(np.finfo(np.float32).max) / 2
    if sr.kind == "kbest" or (sr.idempotent and not sr.maximize):
        return big
    return -big


def _note_bnb(met, tracer, sr, rows, pruned, table_cells, **extra) -> None:
    """Count one pruned dispatch's pruned cells and record its
    ``semiring-bnb`` trace event (``semiring.bnb_passes`` is counted with
    the dispatch)."""
    if pruned and met.enabled:
        met.inc("semiring.bnb_pruned_cells", pruned)
    if tracer is not None and tracer.enabled:
        tracer.event(
            "semiring-bnb", cat="supervisor", semiring=sr.name, rows=rows,
            pruned_cells=int(pruned), table_cells=int(table_cells), **extra,
        )


def _budgets(entries, stack_h, sr, dtype=np.float32) -> np.ndarray:
    """The ``[stack_h]`` budget vector of a stacked pruned dispatch: each
    entry's budget (item 8), the no-prune sentinel for entries without
    one and for pad rows."""
    out = np.full(stack_h, _no_prune(sr), dtype=dtype)
    for r, (item, _) in enumerate(entries):
        if item[8] is not None:
            out[r] = item[8]
    return out


def max_padded_join_cells(plan: "ContractionPlan", pad) -> int:
    """Dims-only upper bound on the plan's largest PADDED join (the
    quantity ``bnb='auto'`` gates on): the O(nodes·width) separator
    simulation `plan.width()` runs, sized on the pad lattice.  Lets
    callers skip the (greedy incumbent + per-part extrema) context
    build entirely on instances where no dispatch can ever clear
    ``BNB_AUTO_MIN_CELLS`` — small solves must not pay for pruning
    that cannot happen."""
    dsize = {
        v: bucket_util_shape((len(plan.domains[v]),), pad)[0]
        for v in plan.domains
    }
    seps: Dict[str, List[str]] = {}
    mx = 1
    for v in plan.order:
        seps[v] = plan.sep_of(v, seps)
        size = dsize[v]
        for d in seps[v]:
            size *= dsize[d]
        mx = max(mx, size)
    return mx


def plan_bnb_context(
    plan: "ContractionPlan", sr: Semiring, beta: float, tol: float,
    table_dtype: str = "f32",
) -> Optional[_BnbContext]:
    """Build the BnB context for one plan, or None when the sweep
    shape does not support pruning (mixed-⊕ marginal-MAP plans: a
    max node's subtree contains sums, so neither bound family
    applies cleanly)."""
    if plan.node_semiring is not None:
        return None
    sign_mass = not (
        sr.kind == "kbest" or (sr.idempotent and not sr.maximize)
    )
    owned: Dict[str, list] = {}
    for v in plan.order:
        parts = []
        for scope, table in plan.buckets[v]:
            t = np.asarray(table, dtype=np.float64)
            parts.append(
                (list(scope), (-beta) * t if sign_mass else t)
            )
        for scope, table in plan.wbuckets[v]:
            # log-prob parts are already kernel-domain log-weights
            parts.append((list(scope), np.asarray(table, np.float64)))
        if parts:
            owned[v] = parts
    return _BnbContext(
        sr, list(reversed(plan.order)), plan.domains, owned,
        plan.children, tol=tol, table_dtype=table_dtype,
    )


# -- device kernels -----------------------------------------------------


def contraction_kernel(
    sr,
    shape: Tuple[int, ...],
    part_shapes: Tuple[Tuple[int, ...], ...],
    batched: bool = False,
    bnb: bool = False,
    table_dtype: str = "f32",
) -> Callable[..., Tuple[torch.Tensor, ...]]:
    """The contraction for one ``(joined shape, aligned part shapes)``
    bucket: a callable on f32 tensors, one per part, that joins the
    aligned parts by broadcast-add (in part order, starting from the
    first part: XLA folds the JAX source's ``zeros + t0``, so a ``-0.0``
    cell keeps its sign) and projects the own (last) axis by ``⊕``.
    ``batched=True`` takes a leading stack axis on every part (the JAX
    package's ``vmap``).  The work runs on the device the parts are on.

    Returns, per semiring:

    - ``min_sum``/``max_sum``: ``(arg, margins)``, the certificate's
      inputs — the int64 arg-reduce (first index on ties; a NaN cell
      wins, as NumPy's does) and the gap to the second best (all
      ``+inf`` when the own axis has one value); the projected values
      are not returned, the caller re-evaluates them on the host;
    - ``log_sum_exp``/``marginals``: ``(values,)``, a max-shifted f32
      logsumexp (its sum in one fixed order); an all-``-inf`` row stays
      ``-inf``;
    - ``kbest:<k>``: parts of ``len(shape)`` axes are scalar, parts with
      one more (the trailing K axis) are child k-cells; returns
      ``(values [..., k], margins [..., k], own [..., k], *slots)``: the
      k best candidates, each one's margin to the next candidate, the
      selected own-value index and one selected child slot per vector
      part (stable argsorts, so ties break by candidate index as
      ``jnp.argsort`` does);
    - ``expectation``: ``(pairs [..., 2],)``, the reduced ``(log w,
      r)`` pairs.

    ``table_dtype`` is the STORAGE precision of the parts: bf16 parts
    are cast to f32 before the first add (the JAX kernel joins onto an
    f32 accumulator; an eager ``bf16 + bf16`` would round in bf16);
    int8 parts arrive as codes with per-part ``scales``/``offsets`` f32
    vectors PREPENDED to the arguments (``[B, P]`` when ``batched``) and
    dequantize as ``q.float() * scale + offset`` (a separate multiply
    and add, as XLA computes it, never a fused multiply-add), the
    reserved codes restoring ``±inf`` exactly.

    ``bnb=True`` builds the two-pass branch-and-bound form (the module
    comment above :data:`BNB_MODES`): the callable takes a per-row
    ``budget`` f32 FIRST (0-d, or ``[B]`` when ``batched``; before
    int8's dequant params), bounds each row by its own ⊕-extremum (the
    join's own-axis min/max for min/max, the best candidate for kbest,
    the row's exact log-mass for the mass kinds), keeps the rows that
    can matter (``~(bound > budget)`` for min and kbest, ``~(bound <
    budget)`` otherwise: negated, so a NaN bound is kept) and masks the
    others' outputs to the ⊕-identity (``+inf`` margins).  The keep mask
    is appended to the outputs; the mass kinds also append the
    logsumexp of the pruned rows' bounds (``-inf`` when none was
    pruned; one per stack row), summed in ``fixed_order_sum``'s order.
    """
    sr = get_semiring(sr)
    dt = as_table_dtype(table_dtype)
    store = storage_dtype(dt)
    shape = tuple(shape)
    part_shapes = tuple(tuple(p) for p in part_shapes)
    if not part_shapes:
        raise ValueError("a contraction needs at least one part")
    d = shape[-1]
    body = {
        "kbest": _kbest_body,
        "expectation": _expectation_body,
    }.get(sr.kind)
    if body is None:
        if sr.idempotent:
            body = _max_body if sr.maximize else _min_body
        else:
            body = _lse_body

    def contract(*args: torch.Tensor):
        if bnb:
            budget, *args = args
        if dt == "int8":
            scales, offsets, *tabs = args
        else:
            tabs = list(args)
        if len(tabs) != len(part_shapes):
            raise ValueError(
                f"expected {len(part_shapes)} parts, got {len(tabs)}"
            )
        lead = tuple(tabs[0].shape[:1]) if batched else ()
        for t, ps in zip(tabs, part_shapes):
            if tuple(t.shape) != lead + ps or t.dtype != store:
                raise ValueError(
                    f"part {tuple(t.shape)} {t.dtype}: expected "
                    f"{lead + ps} {store}"
                )
        if dt == "int8":
            tabs = [
                dequantize_int8(q, scales[..., i], offsets[..., i])
                for i, q in enumerate(tabs)
            ]
        elif dt == "bf16":
            tabs = [t.float() for t in tabs]
        outs = body(sr, tabs, lead + shape, d)
        if sr.idempotent and sr.kind == "scalar":
            arg, margins, u = outs
            outs = (arg, margins)
        if not bnb:
            return outs
        # the budget broadcasts over each stack row's separator cells
        budget = budget.reshape(budget.shape + (1,) * (len(shape) - 1))
        return _bnb_mask(sr, outs, u if sr.idempotent else None, budget,
                         batched)

    return contract


def _bnb_mask(sr, outs, u, budget, batched):
    """Pass 2's masking of :func:`contraction_kernel`'s outputs under a
    per-row ``budget`` (its ``bnb=True`` form): ``u`` is the idempotent
    kinds' row extremum.  The comparisons are negated so that a NaN
    bound (cancelling ``±inf`` parts) keeps its row."""
    inf = float("inf")
    if sr.kind == "kbest":
        vals, margins, own, *slots = outs
        keep = ~(vals[..., 0] > budget)  # the row's best candidate
        k3 = keep.unsqueeze(-1)
        return (
            torch.where(k3, vals, inf), torch.where(k3, margins, inf),
            own, *slots, keep,
        )
    if sr.idempotent:
        arg, margins = outs
        keep = ~(u > budget) if not sr.maximize else ~(u < budget)
        return arg, torch.where(keep, margins, inf), keep
    if sr.kind == "expectation":
        (pair,) = outs
        rowb = pair[..., 0]  # the row's exact log-mass
        keep = ~(rowb < budget)
        masked = torch.stack(
            [torch.where(keep, rowb, -inf),
             torch.where(keep, pair[..., 1], 0.0)], dim=-1,
        )
    else:
        (rowb,) = outs  # the row's exact logsumexp mass
        keep = ~(rowb < budget)
        masked = torch.where(keep, rowb, -inf)
    return masked, keep, _discard(rowb, keep, batched)


def _discard(rowb, keep, batched):
    """logsumexp of the pruned rows' mass bounds (``-inf`` when nothing
    was pruned), one per stack row: the measured discard the host
    accounts.  The sum runs in ``fixed_order_sum``'s order, so the card
    and the CPU give the same bits."""
    inf = float("inf")
    lead = 1 if batched else 0
    pr = torch.where(keep, -inf, rowb).reshape(rowb.shape[:lead] + (-1,))
    m = pr.amax(dim=-1)
    fin = torch.isfinite(m)
    safe = torch.where(fin, m, torch.zeros_like(m))
    e = torch.where(
        torch.isfinite(pr), torch.exp(pr - safe.unsqueeze(-1)),
        torch.zeros_like(pr),
    )
    s = fixed_order_sum(e)
    return torch.where((s > 0) & fin, safe + torch.log(s), -inf)


def dequantize_int8(
    q: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor
) -> torch.Tensor:
    """The device form of ``ops/padding.py:dequantize_table_int8``:
    ``q.float() * scale + offset`` in two separate operations (no fused
    multiply-add, so the bits equal the JAX kernel's), the reserved
    codes restoring ``±inf``.  ``scale``/``offset`` are 0-d, or ``[B]``
    for a part stacked ``[B, ...]`` (one pair per row)."""
    if scale.dim():
        view = (-1,) + (1,) * (q.dim() - 1)
        scale = scale.reshape(view)
        offset = offset.reshape(view)
    f = q.float() * scale
    f = f + offset
    f = torch.where(q == INT8_POS_INF, float("inf"), f)
    return torch.where(q == INT8_NEG_INF, float("-inf"), f)


def _join(tabs, full):
    j = tabs[0].expand(full)
    for t in tabs[1:]:
        j = j + t  # aligned: broadcast over missing axes
    return j


def _min_body(sr, tabs, full, d):
    j = _join(tabs, full)
    u = j.amin(dim=-1)
    amin = j.argmin(dim=-1)
    if d == 1:
        margins = torch.full(
            full[:-1], float("inf"), dtype=torch.float32, device=j.device
        )
    else:
        # second best via masking the arg cell (exact; no sort)
        one_hot = torch.arange(d, device=j.device) == amin.unsqueeze(-1)
        second = torch.where(one_hot, float("inf"), j).amin(dim=-1)
        margins = second - u
    return amin, margins, u


def _max_body(sr, tabs, full, d):
    j = _join(tabs, full)
    u = j.amax(dim=-1)
    arg = j.argmax(dim=-1)
    if d == 1:
        margins = torch.full(
            full[:-1], float("inf"), dtype=torch.float32, device=j.device
        )
    else:
        one_hot = torch.arange(d, device=j.device) == arg.unsqueeze(-1)
        second = torch.where(one_hot, float("-inf"), j).amax(dim=-1)
        margins = u - second
    return arg, margins, u


# The mass kernels sum the own axis with ``ops/costs.py:fixed_order_sum``
# (zero-pad to a power of two, halve), whose order depends only on the
# axis length: a row gives the same bits alone or inside a stack of any
# height, so an ``infer_many`` instance equals its own ``infer`` on the
# card as on the CPU (``torch.sum`` picks its order from the whole shape).


def _lse_body(sr, tabs, full, d):
    j = _join(tabs, full)
    m = j.amax(dim=-1)
    fin = torch.isfinite(m)
    safe = torch.where(fin, m, torch.zeros_like(m))
    s = fixed_order_sum(torch.exp(j - safe.unsqueeze(-1)))
    # an all--inf row (impossible configuration, or a padded ghost row)
    # stays -inf instead of going nan
    return (torch.where(fin, safe + torch.log(s), m),)


def _expectation_body(sr, tabs, full, d):
    nd = len(full)
    lw = torch.zeros(full, dtype=torch.float32, device=tabs[0].device)
    r = torch.zeros(full, dtype=torch.float32, device=tabs[0].device)
    for t in tabs:
        if t.dim() == nd + 1:
            lw = lw + t[..., 0]
            r = r + t[..., 1]
        else:
            lw = lw + t  # scalar parts weight only (the mask)
    m = lw.amax(dim=-1)
    fin = torch.isfinite(m)
    safe = torch.where(fin, m, torch.zeros_like(m))
    w = torch.exp(lw - safe.unsqueeze(-1))
    s = fixed_order_sum(w)
    lw_out = torch.where(fin, safe + torch.log(s), m)
    # zero-weight cells contribute nothing: mask before the product, or
    # a hard-constraint (-inf, +inf) pair's 0·inf poisons the row
    wr = torch.where(w > 0, w * r, torch.zeros_like(r))
    pos = s > 0
    r_out = torch.where(
        pos, fixed_order_sum(wr) / torch.where(pos, s, torch.ones_like(s)),
        torch.zeros_like(s),
    )
    return (torch.stack([lw_out, r_out], dim=-1),)


def _kbest_body(sr, tabs, full, d):
    kk = sr.cell_width
    nd = len(full)
    dev = tabs[0].device
    scal = [t for t in tabs if t.dim() == nd]
    vecs = [t for t in tabs if t.dim() == nd + 1]
    j = (
        _join(scal, full) if scal
        else torch.zeros(full, dtype=torch.float32, device=dev)
    )
    if vecs:
        cell = (
            j.unsqueeze(-1) + vecs[0] if scal
            else vecs[0].expand(full + (kk,))
        )
        provs = [
            torch.arange(kk, device=dev).expand(cell.shape)
        ]
        for t in vecs[1:]:
            # cross-sum-truncate: exact for top-K because sums are
            # monotone in each argument
            sums = cell.unsqueeze(-1) + t.unsqueeze(-2)
            flat = sums.reshape(sums.shape[:-2] + (kk * kk,))
            idx = torch.argsort(flat, dim=-1, stable=True)[..., :kk]
            cell = torch.gather(flat, -1, idx)
            a_i = idx // kk
            provs = [
                torch.gather(p.expand(cell.shape), -1, a_i)
                for p in provs
            ] + [idx % kk]
    else:
        lift = torch.full((kk,), float("inf"), device=dev)
        lift[0] = 0.0
        cell = j.unsqueeze(-1) + lift
        provs = []
    flat = cell.reshape(cell.shape[:-2] + (d * kk,))
    # one +inf pad column so the (K+1)-th candidate — the margin
    # reference — always exists, even at d*kk == kk
    flat = torch.cat(
        [flat, torch.full(flat.shape[:-1] + (1,), float("inf"),
                          device=dev)],
        dim=-1,
    )
    idx = torch.argsort(flat, dim=-1, stable=True)[..., : kk + 1]
    vals_all = torch.gather(flat, -1, idx)
    vals = vals_all[..., :kk]
    margins = torch.where(
        torch.isfinite(vals), vals_all[..., 1:] - vals,
        torch.full_like(vals, float("inf")),
    )
    sel = torch.clamp(idx[..., :kk], max=d * kk - 1)
    outs = [vals, margins, sel // kk]
    for p in provs:
        pf = p.expand(cell.shape).reshape(cell.shape[:-2] + (d * kk,))
        outs.append(torch.gather(pf, -1, sel))
    return tuple(outs)


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
    added in the order ``((tab + q0) + q1) + …``), ``M_p = ⊕`` over all
    axes but ``p``, ``r_p = M_p − q_p``, then shift-normalized per edge
    (by the min for ``min/+``, Max-Sum's normalization, by the max for
    the maximizing and summing semirings).

    ``tab`` is the bucket's ``[d, ..., d, m]`` table stack (or
    ``[d, ..., d, 1]`` for a shared table), ``q_pos`` the ``k``
    per-position ``[..., d, m]`` messages (leading batch axes, e.g.
    restarts and instances, with ``tab`` broadcastable over them);
    returns the ``k`` outgoing messages in ``mdt``.

    ``bnb=True`` (idempotent ⊕ only; ignored otherwise) runs the
    two-pass ⊕-bounded marginalization of arXiv:1906.06863 per output
    position, as the JAX package does: pass 1 bounds every configuration
    by the table plus the other positions' q extrema, and takes, per
    output cell, an incumbent (the table at the q-extrema configuration
    of the other axes: one exact candidate); pass 2 masks the
    configurations whose bound cannot beat the incumbent to the
    ⊕-identity before each reduce.  A slack of ``4·(k+2)·eps32·scale``
    keeps the test conservative, so pruned entries are strictly worse
    than each output's optimum and the messages are bit-identical to
    ``bnb=False``.
    """
    sr = get_semiring(sr)
    k = len(q_pos)
    lead = tuple(q_pos[0].shape[:-2])
    d, m = q_pos[0].shape[-2:]
    s = tab
    for p in range(k):
        shape = lead + (1,) * p + (d,) + (1,) * (k - 1 - p) + (m,)
        s = s + q_pos[p].to(tab.dtype).reshape(shape)
    low = sr.idempotent and not sr.maximize
    use_bnb = bool(bnb) and sr.idempotent
    if use_bnb:
        guard = float("inf") if low else float("-inf")
        qf = [q.to(tab.dtype) for q in q_pos]
        if low:
            qv = [q.amin(dim=-2) for q in qf]  # [*lead, m] per position
            qa = [q.argmin(dim=-2) for q in qf]
        else:
            qv = [q.amax(dim=-2) for q in qf]
            qa = [q.argmax(dim=-2) for q in qf]

        def fin_max(a):
            f = torch.where(torch.isfinite(a), a.abs(), 0.0)
            return f.amax() if f.numel() else f.new_zeros(())

        scale = fin_max(tab)
        for q in qf:
            scale = scale + fin_max(q)
        # covers three independently rounded f32 sums (the joint s, the
        # bound lb, the incumbent ub), each within (k+1)·eps32·scale of
        # its exact value
        slack = 4.0 * (k + 2) * _EPS32 * torch.clamp(scale, min=1.0)
        full = tuple(s.shape)
        tab_f = tab.expand(lead + full[len(lead):-1] + (tab.shape[-1],))

        def at(x):  # [*lead, m] -> broadcast over the bucket's axes
            return x.reshape(lead + (1,) * k + (m,))
    outs = []
    for p in range(k):  # position a's axis is a - k - 1
        axes = tuple(a - k - 1 for a in range(k) if a != p)
        sp = s
        if use_bnb:
            # incumbent per output cell (p, v): the table at the
            # q-extrema configuration of the other axes
            t = tab_f.expand(full)
            for a in range(k):
                if a == p:
                    continue
                idx_shape = list(t.shape)
                idx_shape[len(lead) + a] = 1
                idx = at(qa[a]).expand(idx_shape)
                t = torch.gather(t, len(lead) + a, idx)
            ub = t
            lb = tab
            for a in range(k):
                if a == p:
                    continue
                ub = ub + at(qv[a])
                lb = lb + at(qv[a])
            qp = qf[p].reshape(
                lead + (1,) * p + (d,) + (1,) * (k - 1 - p) + (m,)
            )
            lb = lb + qp
            ub = ub + qp  # the incumbent includes this output's own q
            # negated test: NaN bounds (cancelling ±inf) are kept
            worse = (lb < ub - slack) if sr.maximize else (lb > ub + slack)
            sp = torch.where(~worse, s, guard)
        mp = sp.amin(dim=axes) if low else sr.torch_reduce(sp, axes)
        rp = mp - q_pos[p].to(tab.dtype)
        if low:
            rp = rp - rp.amin(dim=-2, keepdim=True)
        else:
            rp = rp - rp.amax(dim=-2, keepdim=True)
        outs.append(rp.to(mdt))
    return outs


# -- elimination orders and contraction plans ---------------------------


ELIMINATION_ORDERS = ("pseudo_tree", "min_fill")


def min_fill_order(
    domains: Dict[str, Sequence],
    scopes: Sequence[Sequence[str]],
    deadline: Optional[float] = None,
    last_block: Optional[set] = None,
) -> List[str]:
    """Greedy min-fill elimination order over the primal graph: at each
    step eliminate the variable whose removal adds the fewest fill edges
    among its remaining neighbors (ties: smallest neighborhood, then
    name).  Fill counts are cached and invalidated incrementally (the
    eliminated variable's neighbors and the common neighbors of each
    added fill edge).  ``deadline`` (a ``perf_counter`` timestamp)
    raises ``TimeoutError`` between steps.  ``last_block`` makes a
    two-block order: its variables are eligible only once every other
    variable is eliminated (marginal MAP: sum first, max last)."""
    adj: Dict[str, set] = {v: set() for v in domains}
    for scope in scopes:
        sc = [v for v in scope if v in adj]
        for a in sc:
            for b in sc:
                if a != b:
                    adj[a].add(b)
    remaining = {v: set(ns) for v, ns in adj.items()}
    order: List[str] = []
    cache: Dict[str, int] = {}

    def fill_count(v: str) -> int:
        ns = list(remaining[v])
        cnt = 0
        for i in range(len(ns)):
            ri = remaining[ns[i]]
            for j in range(i + 1, len(ns)):
                if ns[j] not in ri:
                    cnt += 1
        return cnt

    while remaining:
        if deadline is not None and time.perf_counter() > deadline:
            raise TimeoutError(
                f"min_fill elimination order timed out with "
                f"{len(remaining)} of {len(adj)} variables left"
            )
        if last_block:
            pool = [x for x in remaining if x not in last_block]
            if not pool:  # only the last block is left
                pool = list(remaining)
        else:
            pool = remaining
        best_key = None
        best = None
        for x in pool:
            c = cache.get(x)
            if c is None:
                c = cache[x] = fill_count(x)
            key = (c, len(remaining[x]), x)
            if best_key is None or key < best_key:
                best_key, best = key, x
        v = best
        order.append(v)
        ns = list(remaining[v])
        dirty = set(ns)
        for i in range(len(ns)):
            for j in range(i + 1, len(ns)):
                a, b = ns[i], ns[j]
                if b not in remaining[a]:
                    remaining[a].add(b)
                    remaining[b].add(a)
                    dirty |= remaining[a] & remaining[b]
        for n in ns:
            remaining[n].discard(v)
        del remaining[v]
        cache.pop(v, None)
        for x in dirty:
            cache.pop(x, None)
    return order


class ContractionPlan:
    """One instance's bucket tree: the elimination order, per-variable
    buckets of owned ENERGY tables (f64, minimization convention; the
    semiring transforms apply at sweep time, so one plan serves every
    query), and the parent/children structure of a dims-only simulation
    of the elimination.  ``const_energy`` accumulates fully-external
    parts.  ``wbuckets`` holds LOG-WEIGHT parts (the stochastic
    externals of an expectation query); ``node_semiring`` (marginal MAP)
    sets the ⊕ per node."""

    __slots__ = (
        "domains", "order", "pos", "buckets", "parent", "children",
        "roots", "height", "const_energy", "order_name", "wbuckets",
        "node_semiring", "max_vars",
    )

    def __init__(
        self, domains, order, buckets, const_energy, order_name,
        wbuckets=None, node_semiring=None, max_vars=None,
    ):
        self.domains = domains
        self.order = order
        self.pos = {v: i for i, v in enumerate(order)}
        self.buckets = buckets
        self.wbuckets = (
            {v: [] for v in order} if wbuckets is None else wbuckets
        )
        self.node_semiring = node_semiring
        self.max_vars = max_vars
        self.const_energy = const_energy
        self.order_name = order_name
        # the message scope of v is the union of its bucket dims and its
        # children's message dims, minus v; its parent is the
        # earliest-ELIMINATED variable of that scope
        self.parent: Dict[str, Optional[str]] = {}
        self.children: Dict[str, List[str]] = {v: [] for v in order}
        self.roots: List[str] = []
        msg_dims: Dict[str, set] = {}
        for v in order:
            dims: set = set()
            for scope, _ in buckets[v]:
                dims.update(scope)
            for scope, _ in self.wbuckets[v]:
                dims.update(scope)
            for c in self.children[v]:
                dims.update(msg_dims[c])
            dims.discard(v)
            msg_dims[v] = dims
            if dims:
                p = min(dims, key=self.pos.__getitem__)
                self.parent[v] = p
                self.children[p].append(v)
            else:
                self.parent[v] = None
                self.roots.append(v)
        # wave index = node HEIGHT: every leaf lands in wave 0
        self.height: Dict[str, int] = {}
        for v in order:  # children precede parents in elim order
            self.height[v] = 1 + max(
                (self.height[c] for c in self.children[v]), default=-1
            )

    def sep_of(self, name: str, child_seps: Dict[str, List[str]]):
        """Separator of ``name``: dims of its own parts plus its
        children's separators, minus itself, sorted root-most first
        (descending elimination position)."""
        dims: set = set()
        for scope, _ in self.buckets[name]:
            dims.update(scope)
        for scope, _ in self.wbuckets[name]:
            dims.update(scope)
        for c in self.children[name]:
            dims.update(child_seps[c])
        dims.discard(name)
        return sorted(dims, key=lambda v: -self.pos[v])


def build_plan(
    dcop,
    order: str = "pseudo_tree",
    deadline: Optional[float] = None,
    max_vars: Optional[Sequence[str]] = None,
    external_dists: Optional[Mapping[str, Mapping[Any, float]]] = None,
    provenance: Optional[dict] = None,
) -> ContractionPlan:
    """Build the contraction plan for one DCOP under an elimination
    order heuristic.  Tables are extracted once as f64 energies
    (sign-folded for ``objective: max``, external variables sliced out,
    variable value-costs folded in as unary parts, as DPOP prepares
    them); each part is owned by its earliest-eliminated scope variable.
    ``deadline`` bounds the ``min_fill`` search (``TimeoutError``).
    ``max_vars`` (marginal MAP) constrains both heuristics to a two-block
    order and sets ``node_semiring``; ``external_dists`` (expectation)
    maps external names to ``{value: prob}``: those externals join the
    plan as summed variables with a log-probability part.

    ``provenance`` (optional out-param) records, per external-scoped
    constraint name, where its sliced table landed: ``(owner, index)``
    into ``plan.buckets[owner]``, or ``("const",)`` when the slice
    folded into ``const_energy`` — the hook
    :class:`~pydcop_tpu_torch.engine.memo.InferSession` re-tabulates
    a ``set_values`` delta through."""
    if order not in ELIMINATION_ORDERS:
        raise ValueError(
            f"unknown elimination order {order!r} (expected one of "
            f"{ELIMINATION_ORDERS})"
        )
    sign = -1.0 if dcop.objective == "max" else 1.0
    dists = dict(external_dists) if external_dists else {}
    unknown_ext = set(dists) - set(dcop.external_variables)
    if unknown_ext:
        raise ValueError(
            f"external_dists names {sorted(unknown_ext)} — not "
            "external variables of this dcop (externals: "
            f"{sorted(dcop.external_variables)})"
        )
    ext_values = {
        n: ev.value
        for n, ev in dcop.external_variables.items()
        if n not in dists
    }
    domains: Dict[str, list] = {
        v.name: list(v.domain.values) for v in dcop.variables.values()
    }
    wparts: List[Tuple[List[str], np.ndarray]] = []
    for n, dist in dists.items():
        ev = dcop.external_variables[n]
        dom = list(ev.domain.values)
        # a JSON-shipped dist (the CLI) carries string keys — match
        # domain values with a str() fallback
        dom_keys = set(dom) | {str(x) for x in dom}
        bad = sorted(str(x) for x in set(dist) - dom_keys)
        if bad:
            raise ValueError(
                f"external_dists[{n!r}] names values {bad} outside "
                f"the external's domain {dom}"
            )
        probs = np.array(
            [float(dist.get(x, dist.get(str(x), 0.0))) for x in dom],
            dtype=np.float64,
        )
        if (probs < 0).any() or probs.sum() <= 0:
            raise ValueError(
                f"external_dists[{n!r}] must be non-negative with "
                "positive total mass"
            )
        probs = probs / probs.sum()
        with np.errstate(divide="ignore"):  # p=0 -> log -inf: the
            # value carries zero weight
            wparts.append(([n], np.log(probs)))
        domains[n] = dom

    if max_vars is not None:
        mv = set(max_vars)
        unknown_mv = mv - set(domains)
        if unknown_mv:
            raise ValueError(
                f"map_vars names {sorted(unknown_mv)} — not "
                "variables of this dcop"
            )
        if not mv:
            raise ValueError(
                "map_vars is empty — with nothing maximized the "
                "query is 'log_z'"
            )
    else:
        mv = None

    # (scope, table, constraint name when external-scoped)
    parts: List[Tuple[List[str], np.ndarray, Optional[str]]] = []
    const_energy = 0.0
    for v in dcop.variables.values():
        if v.has_cost:
            costs = np.array(
                [sign * v.cost_for_val(x) for x in v.domain.values],
                dtype=np.float64,
            )
            parts.append(([v.name], costs, None))
    for c in dcop.constraints.values():
        cname = c.name
        scope_ext = [n for n in c.scope_names if n in ext_values]
        if scope_ext:
            c = c.slice({n: ext_values[n] for n in scope_ext})
        scope = list(c.scope_names)
        m = c.as_matrix()
        table = sign * np.asarray(m.matrix, dtype=np.float64)
        if not scope:
            const_energy += float(table)
            if provenance is not None and scope_ext:
                provenance[cname] = ("const",)
            continue
        parts.append((scope, table, cname if scope_ext else None))

    if order == "min_fill":
        elim = min_fill_order(
            domains,
            [s for s, _, _ in parts] + [s for s, _ in wparts],
            deadline=deadline,
            last_block=mv,
        )
    else:
        from pydcop_tpu_torch.graphs import pseudotree as _pt

        graph = _pt.build_computation_graph(dcop)
        names = [
            n for root in graph.roots for n in graph.depth_first_order(root)
        ]
        # reverse DFS pre-order: children strictly before parents (the
        # bucket tree IS the pseudo-tree); distribution-carrying
        # externals are summed leaves, eliminated first
        elim = sorted(dists) + list(reversed(names))
        if mv is not None:
            elim = [v for v in elim if v not in mv] + [
                v for v in elim if v in mv
            ]

    node_semiring = None
    if mv is not None:
        node_semiring = {
            v: ("max_sum" if v in mv else "log_sum_exp") for v in elim
        }

    pos = {v: i for i, v in enumerate(elim)}
    buckets: Dict[str, List[Tuple[List[str], np.ndarray]]] = {
        v: [] for v in elim
    }
    wbuckets: Dict[str, List[Tuple[List[str], np.ndarray]]] = {
        v: [] for v in elim
    }
    for scope, table, cname in parts:
        owner = min(scope, key=pos.__getitem__)
        if provenance is not None and cname is not None:
            provenance[cname] = (owner, len(buckets[owner]))
        buckets[owner].append((scope, table))
    for scope, table in wparts:
        wbuckets[min(scope, key=pos.__getitem__)].append((scope, table))
    return ContractionPlan(
        domains, elim, buckets, const_energy, order,
        wbuckets=wbuckets, node_semiring=node_semiring,
        max_vars=(sorted(mv) if mv is not None else None),
    )


# -- the merged contraction sweep ---------------------------------------


def _align(table, dims, target):
    """Transpose + reshape ``table`` (axes named ``dims``) so it
    broadcasts over ``target`` (a superset of ``dims``).  A part with
    one more axis than named ``dims`` is a STRUCTURED-cell part: the
    named axes align as usual and the trailing cell axis rides along."""
    table = np.asarray(table)
    order = [d for d in target if d in dims]
    cell = table.ndim == len(dims) + 1
    t = np.transpose(
        table,
        [list(dims).index(d) for d in order] + ([len(dims)] if cell else []),
    )
    shape = [t.shape[order.index(d)] if d in dims else 1 for d in target]
    return t.reshape(shape + ([table.shape[-1]] if cell else []))


def _finite_amax(a) -> float:
    """max |finite entries| of a table (±inf entries are hard
    constraints and guards, structure rather than a rounding scale); a
    packed table answers from its values (absent cells are the exact
    ⊕-identity)."""
    if isinstance(a, SparseTable):
        return a.finite_amax()
    a = np.asarray(a)
    if a.size == 0:
        return 0.0
    m = np.abs(a[np.isfinite(a)])
    return float(m.max()) if m.size else 0.0


def _upload(parts, device):
    """Send a dispatch's arguments to ``device`` in ONE host→device copy
    per storage type: numpy float parts are cast to f32 as they are
    written into one flat host buffer (the f32 pack), int8 codes and
    i32 indices keep their type, bf16 packs are torch CPU tensors
    (:func:`_pack_parts`).  Returns per-part views of the device
    buffers, in argument order."""
    groups: Dict[Any, List[int]] = {}
    for i, p in enumerate(parts):
        if isinstance(p, torch.Tensor):
            key = p.dtype
        else:
            dt = np.asarray(p).dtype
            key = np.dtype(np.float32) if dt.kind == "f" else dt
        groups.setdefault(key, []).append(i)
    out: List[Optional[torch.Tensor]] = [None] * len(parts)
    for key, idx in groups.items():
        sizes = [int(np.prod(np.shape(parts[i]))) for i in idx]
        if isinstance(key, torch.dtype):
            flat = torch.cat([parts[i].reshape(-1) for i in idx])
        else:
            host = np.empty(sum(sizes), dtype=key)
            off = 0
            for i, n in zip(idx, sizes):
                host[off:off + n].reshape(np.shape(parts[i]))[...] = parts[i]
                off += n
            flat = torch.from_numpy(host)
        buf = flat.to(device)
        for i, piece in zip(idx, torch.split(buf, sizes)):
            out[i] = piece.view(tuple(np.shape(parts[i])))
    return out


def _dispatch(fn, parts, device: torch.device):
    """Run one contraction on ``device``: the packed parts go over in
    one host→device copy per storage type (:func:`_upload`), and each
    output comes back to host numpy."""
    return tuple(o.cpu().numpy() for o in fn(*_upload(parts, device)))


def _pack_parts(parts, table_dtype, met=None):
    """One dispatch row's aligned+padded float parts at the storage
    dtype: f32 passes through; bf16 casts on the host (f64 → f32 →
    bf16, one rounding more, covered by the widened certificates) to
    torch bf16 tensors; int8 quantizes each part and PREPENDS the
    per-part scale/offset f32 vectors the kernel's dequant consumes
    (``semiring.int8_requant`` counts the part packs)."""
    if table_dtype == "f32":
        return list(parts)
    if table_dtype == "bf16":
        return [
            torch.from_numpy(np.asarray(p, dtype=np.float32)).to(
                torch.bfloat16
            )
            for p in parts
        ]
    scales = np.zeros(len(parts), dtype=np.float32)
    offsets = np.zeros(len(parts), dtype=np.float32)
    qs = []
    for i, p in enumerate(parts):
        q, s, o = quantize_table_int8(p)
        qs.append(q)
        scales[i] = s
        offsets[i] = o
    if met is not None and met.enabled:
        met.inc("semiring.int8_requant", len(parts))
    return [scales, offsets] + qs


def pack_rows(bufs, table_dtype, n_rows, met):
    """Stacked dispatch buffers ``[stack, ...]`` at the storage dtype, as
    ``(dequant, parts)``: int8 quantizes per (row, part)
    (:func:`_quantize_rows`) and ``dequant`` is its ``[scales, offsets]``
    pair; f32 and bf16 pack as :func:`_pack_parts` does, with no
    ``dequant``."""
    if table_dtype == "int8":
        packed = _quantize_rows(bufs, n_rows, met)
        return packed[:2], packed[2:]
    return [], _pack_parts(bufs, table_dtype)


def storage_error(table_dtype, n_parts, parts_max):
    """The rounding bound of one device join at a storage dtype: the
    dtype's unit roundoff times ``(n_parts + 1)`` times the parts' summed
    largest magnitude, plus int8's quantization bound.  An arg whose
    margin is at least twice this (plus the error already carried in) is
    certified."""
    quant = int8_quant_bound(parts_max) if table_dtype == "int8" else 0.0
    return table_dtype_eps(table_dtype) * (n_parts + 1) * parts_max + quant


def note_precision_repairs(met, table_dtype, n_bad):
    """Count ``semiring.precision_repairs`` once for a low-precision join
    whose certificate sent cells to the host (it would not have paid
    them at f32)."""
    if table_dtype != "f32" and n_bad and met.enabled:
        met.inc("semiring.precision_repairs")


class _Sweep:
    """Per-call state of one merged upward sweep (K instances)."""

    __slots__ = (
        "msgs", "args", "root_total", "total_shift", "cells",
        "device_nodes", "host_nodes", "dispatches", "err", "seps",
        "root_cells",
    )

    def __init__(self, K: int):
        # msgs[k][name] = (sep, message f64, max|message|)
        self.msgs: List[Dict[str, tuple]] = [{} for _ in range(K)]
        self.args: List[Dict[str, tuple]] = [{} for _ in range(K)]
        self.seps: List[Dict[str, List[str]]] = [{} for _ in range(K)]
        self.root_total = [0.0] * K
        # structured kinds keep per-root CELLS (kbest re-merges them
        # with provenance; expectation pairs ⊗-combine at assembly)
        self.root_cells: List[Dict[str, np.ndarray]] = [
            {} for _ in range(K)
        ]
        self.total_shift = [0.0] * K
        self.cells = [0] * K
        self.device_nodes = [0] * K
        self.host_nodes = [0] * K
        self.dispatches = [0] * K
        # name -> accumulated log-domain error bound
        self.err: List[Dict[str, float]] = [{} for _ in range(K)]


def contract_sweep(
    plans: Sequence[ContractionPlan],
    sr: Semiring,
    *,
    beta: float = 1.0,
    device_min_cells: Optional[int] = 1 << 14,
    pad: PadPolicy = NO_PADDING,
    level_sync: bool = True,
    tol: float = 1e-6,
    max_table_size: int = 1 << 26,
    want_args: bool = False,
    t0: Optional[float] = None,
    timeout: Optional[float] = None,
    on_oom: str = "host",
    bnb: str = "off",
    memos: Optional[Sequence[Any]] = None,
    table_dtype: str = "f32",
    table_format: str = "dense",
    torch_device: Optional[torch.device] = None,
) -> Optional[_Sweep]:
    """Merged bottom-up contraction sweep over K instances.

    Wave ``w`` holds every instance's height-``w`` nodes; device
    contractions (``device_min_cells`` cells or more; ``None`` keeps the
    whole sweep on the host in f64) bucket by level-pack key ACROSS
    instances and run as ONE stacked :func:`contraction_kernel` dispatch
    per bucket on ``torch_device`` (``level_sync=False``: one dispatch
    per node, the same joins).  Tables enter the sweep in KERNEL
    domain: energies for ``min_sum`` and kbest, log-weights ``-beta·E``
    otherwise.  Idempotent and kbest contractions are certified and
    host-repaired (exact; ``want_args`` keeps the arg tables for a value
    phase); logsumexp contractions carry accumulated error bounds and
    run on host f64 when a device pass would push the bound past ``tol``
    (``semiring.logsumexp_repairs``).  Returns the sweep state, or None
    on timeout.

    A stacked dispatch that runs out of device memory degrades to one
    dispatch per node (``engine.oom_splits``); ``on_oom`` picks the
    bottom rung: a node that still does not fit is redone on host f64
    (``"host"``, the default) or the supervisor's ``DeviceOOMError``
    propagates (``"raise"``: the budgeted sweeps of ``ops/membound.py``
    answer it by re-planning at a tighter ``max_util_bytes``).  Every
    device dispatch goes through the ambient supervisor
    (``engine/supervisor.py``; scopes ``semiring.level`` and
    ``semiring.node``), so transient failures retry and the device chaos
    kinds inject here as in the JAX package.

    ``table_dtype`` packs every device part at the requested storage
    precision with the join kept f32.  Correctness rides the same
    machinery re-scaled per precision: idempotent/kbest certificates
    widen to the storage roundoff (plus the int8 quantization bound)
    and repair exactly as at f32, so results stay bit-identical to the
    f32 sweep; mass ⊕ nodes whose widened bound would blow ``tol``
    DEMOTE to an f32 dispatch first (``semiring.precision_repairs``)
    and only then fall back to host f64.  The dtype joins the bucket
    key, and ``semiring.int8_requant`` counts int8 part packs.

    ``table_format="sparse"`` COO-packs qualifying tables
    (``ops/sparse.py``): scalar-⊕ own parts and outgoing messages whose
    non-identity fraction clears the density threshold pack as sorted
    feasible-tuple indices + values (``semiring.sparse_packs``), and a
    node holding packed parts contracts through the gather/segment
    kernel over its candidate list (``semiring.sparse_nodes``; an
    intersection too dense to pay falls back to the dense kernels,
    ``semiring.sparse_fallbacks``).  The format joins the bucket key.
    Exactness is unchanged: absent tuples are the ⊕-identity, so
    idempotent results stay bit-identical, and mass queries fold any
    truncated-mass term into the error ledger.

    ``bnb`` enables the two-pass branch-and-bound pruned kernels (the
    module comment above :data:`BNB_MODES`): ``"on"`` prunes every
    device dispatch, ``"auto"`` only those whose per-row padded table
    clears :data:`BNB_AUTO_MIN_CELLS` (``semiring.bnb_skipped_small``
    counts the instances and dispatches that stay unpruned), ``"off"``
    never.  Each pruning instance gets its own :class:`_BnbContext`;
    pad rows carry the no-prune sentinel; a mass dispatch's measured
    discard goes into the error ledger.  ``semiring.bnb_passes`` and
    ``semiring.bnb_pruned_cells`` count the pruned dispatches and cells,
    and each pruned dispatch records a ``semiring-bnb`` trace event.

    ``memos`` (one ``engine.memo.SweepMemoView`` or None per instance)
    enables subtree-fingerprint message reuse: a node whose fingerprint
    is unchanged reinstalls its stored message (separator, shifted
    values, magnitude, shift, cumulative error bound, args) and is
    skipped; re-contracted nodes re-store.  An instance that builds a
    pruning context runs unmemoized (a budget-pruned message depends on
    the global incumbent, not just the subtree).

    Counters: ``semiring.contractions`` per node,
    ``semiring.kbest_merges`` per kbest node, ``semiring.dispatches``
    per device dispatch, ``semiring.cert_fallbacks`` per node redone on
    the host, ``semiring.mixed_blocks``; the sweep records a
    ``semiring.contract`` span.
    """
    from pydcop_tpu_torch.telemetry import get_metrics, get_tracer

    met = get_metrics()
    tracer = get_tracer()
    t0 = time.perf_counter() if t0 is None else t0
    K = len(plans)
    sw = _Sweep(K)
    _key_memo: Dict[tuple, tuple] = {}
    if device_min_cells is not None and torch_device is None:
        raise ValueError("a device sweep needs torch_device")
    if on_oom not in ("host", "raise"):
        raise ValueError(f"on_oom must be 'host' or 'raise', got {on_oom!r}")
    call_dt = as_table_dtype(table_dtype)
    # packing pays only where the device kernels run: an all-host sweep
    # joins in exact f64 and would just densify the packs back
    fmt_sparse = (
        as_table_format(table_format) == "sparse"
        and device_min_cells is not None
    )
    bnb = as_bnb(bnb, "off")
    ctxs: List[Optional[_BnbContext]] = [None] * K
    if bnb != "off" and device_min_cells is not None:
        for k, p in enumerate(plans):
            if (
                bnb == "auto"
                and max_padded_join_cells(p, pad) * sr.cell_width
                < BNB_AUTO_MIN_CELLS
            ):
                # no dispatch of this instance can clear the auto
                # threshold: skip the context build, counted once
                if met.enabled:
                    met.inc("semiring.bnb_skipped_small")
                continue
            ctxs[k] = plan_bnb_context(p, sr, beta, tol, table_dtype=call_dt)
    bnb_call = any(c is not None for c in ctxs)
    if memos is not None:
        # pruning and memoization are exclusive per instance: a pruned
        # message is not a pure function of its subtree
        memos = [
            None if ctxs[k] is not None else m
            for k, m in enumerate(memos)
        ]

    def table_in(tbl: np.ndarray) -> np.ndarray:
        if sr.kind == "kbest" or (sr.idempotent and not sr.maximize):
            return tbl  # cost-ordered kinds: raw energies
        return (-beta) * tbl

    def finish(sr_n, k, name, plan, sep, u, arg):
        if met.enabled:
            met.inc("semiring.contractions")
            if sr_n.kind == "kbest":
                met.inc("semiring.kbest_merges")
        if want_args and arg is not None:
            sw.args[k][name] = (sep, arg)
        rootval = None
        if plan.parent[name] is None:
            if sr_n.cell_width > 1:
                cell = np.asarray(u, dtype=np.float64)
                sw.root_cells[k][name] = cell
                rootval = ("cell", cell)
            else:
                # root: the reduce is a scalar — fold it into the
                # instance aggregate
                rootval = ("total", float(u))
                sw.root_total[k] += float(u)
            if ctxs[k] is not None:
                ctxs[k].record_shift(name, 0.0, plan.children[name])
        else:
            shift = sr_n.shift_of(u)
            if not np.isfinite(shift):
                shift = 0.0  # an all--inf message normalizes to itself
            u = sr_n.apply_shift(u, shift)
            sw.total_shift[k] += shift
            if ctxs[k] is not None:
                ctxs[k].record_shift(name, shift, plan.children[name])
            # finite-masked: pruned rows carry the ⊕-identity and hard
            # constraints ±inf, exact values rather than rounding scales
            mag = _finite_amax(u)
            if (
                fmt_sparse
                and sr_n.cell_width == 1
                and isinstance(u, np.ndarray)
            ):
                # a mostly-identity message re-packs before it feeds the
                # parent (``.size`` keeps the dense cell count)
                ps = pack_table(u, sr_n.plus_identity)
                if ps is not None:
                    u = ps
                    if met.enabled:
                        met.inc("semiring.sparse_packs")
            sw.msgs[k][name] = (sep, u, mag)
            sw.cells[k] += u.size
        memo = memos[k] if memos is not None else None
        if memo is not None:
            # every non-idempotent path sets sw.err[name] BEFORE finish,
            # so the stored error is the node's CUMULATIVE subtree bound:
            # a hit re-accounts what the cold solve accounted, and only
            # dirty-path nodes add new error on a warm delta
            if rootval is not None:
                memo.store(
                    name,
                    (
                        sep, None, 0.0, 0.0, sw.args[k].get(name),
                        sw.err[k].get(name, 0.0), True, rootval,
                    ),
                )
            else:
                mu = (
                    u.copy()
                    if isinstance(u, np.ndarray) and u.base is not None
                    else u  # owned arrays and immutable packs as-is
                )
                memo.store(
                    name,
                    (
                        sep, mu, mag, shift, sw.args[k].get(name),
                        sw.err[k].get(name, 0.0), False, None,
                    ),
                )

    def host_contract(sr_n, k, name, plan, sep, target, shape, parts,
                      err_in):
        if sr_n.kind == "kbest":
            u, own, provs = _kbest_host(
                parts, target, shape, sr_n.cell_width
            )
            sw.host_nodes[k] += 1
            arg = (own, dict(zip(plan.children[name], provs)))
            finish(sr_n, k, name, plan, sep, u, arg)
            return
        if sr_n.kind == "expectation":
            u = _expect_host(parts, target, shape)
            sw.host_nodes[k] += 1
            scale = max(sum(_finite_amax(t) for _, t in parts), 1.0)
            sw.err[k][name] = err_in + _EPS64 * (
                (len(parts) + 1) * scale + shape[-1] + 2
            )
            finish(sr_n, k, name, plan, sep, u, None)
            return
        j = np.zeros(shape, dtype=np.float64)
        for dims, table in parts:
            j = j + _align(table, dims, target)
        arg = (
            sr_n.arg_reduce(j, axis=-1)
            if want_args and sr_n.idempotent
            else None
        )
        u = sr_n.reduce(j, axis=-1)
        sw.host_nodes[k] += 1
        if not sr_n.idempotent:
            # f64 rounding of the same computation: negligible, but
            # accounted so the reported bound is never an understatement
            scale = max(
                sum(
                    float(np.max(np.abs(t), initial=0.0))
                    for _, t in parts
                ),
                1.0,
            )
            sw.err[k][name] = err_in + _EPS64 * (
                (len(parts) + 1) * scale + shape[-1] + 2
            )
        elif err_in:
            # a mixed sweep's max node: the sum block's bounds flow
            # through to the root unchanged
            sw.err[k][name] = err_in
        finish(sr_n, k, name, plan, sep, u, arg)

    waves: List[List[Tuple[int, str]]] = []
    for k, plan in enumerate(plans):
        for n in plan.order:
            w = plan.height[n]
            while len(waves) <= w:
                waves.append([])
            waves[w].append((k, n))

    mixed = any(p.node_semiring for p in plans)
    t_sweep = time.perf_counter()
    for wave in waves:
        buckets: Dict[tuple, list] = {}
        order: List[tuple] = []
        wave_srs: set = set()
        for k, name in wave:
            if timeout is not None and time.perf_counter() - t0 > timeout:
                return None
            plan = plans[k]
            domains = plan.domains
            sr_n = (
                get_semiring(plan.node_semiring[name])
                if plan.node_semiring is not None
                else sr
            )
            if mixed:
                wave_srs.add(sr_n.name)
            cw = sr_n.cell_width
            memo = memos[k] if memos is not None else None
            if memo is not None:
                payload = memo.lookup(name)
                if payload is not None:
                    (msep, mu, mmag, mshift, margp, merr, mroot,
                     mrootval) = payload
                    # an arg-consuming query cannot hit an entry stored
                    # without args (an earlier solve of another query)
                    if not (want_args and margp is None):
                        sw.seps[k][name] = msep
                        if margp is not None and want_args:
                            sw.args[k][name] = margp
                        if merr:
                            sw.err[k][name] = merr
                        if mroot:
                            if mrootval[0] == "cell":
                                sw.root_cells[k][name] = mrootval[1]
                            else:
                                sw.root_total[k] += mrootval[1]
                        else:
                            sw.msgs[k][name] = (msep, mu, mmag)
                            sw.total_shift[k] += mshift
                        memo.mark_hit()
                        continue
            sep = plan.sep_of(name, sw.seps[k])
            sw.seps[k][name] = sep
            target = sep + [name]
            shape = [len(domains[d]) for d in target]
            size = 1
            for s in shape:
                size *= s
            if size * cw > max_table_size:
                raise ValueError(
                    f"contraction table for {name!r} needs "
                    f"{size * cw} cells (separator {sep}, cell width "
                    f"{cw}); exceeds max_table_size={max_table_size}.  "
                    f"The induced width under order={plan.order_name!r} "
                    "is too large — try order='min_fill', or an "
                    "approximate (message-passing) algorithm."
                )
            # own parts PRE-SUMMED into one exact f64 part (the DPOP
            # trick), then the children's messages
            own_parts = plan.buckets[name]
            own_w = plan.wbuckets[name]
            parts: List[Tuple[List[str], np.ndarray]] = []
            parts_max = 0.0
            err_in = 0.0
            if own_w and sr_n.kind != "expectation":
                raise ValueError(
                    "external distributions weight assignments — "
                    f"the {sr_n.name!r} ⊕ cannot carry them (use "
                    "query='expectation')"
                )
            if sr_n.kind == "expectation":
                if own_parts or own_w:
                    odims: List[str] = []
                    for dims, _ in own_parts:
                        odims.extend(d for d in dims if d not in odims)
                    for dims, _ in own_w:
                        odims.extend(d for d in dims if d not in odims)
                    e = np.zeros(
                        [len(domains[d]) for d in odims], dtype=np.float64
                    )
                    for dims, table in own_parts:
                        e = e + _align(table, dims, odims)
                    lw = (-beta) * e
                    for dims, table in own_w:
                        lw = lw + _align(table, dims, odims)
                    o = np.stack([lw, e], axis=-1)
                    parts.append((odims, o))
                    parts_max += _finite_amax(o)
            elif own_parts:
                odims = []
                for dims, _ in own_parts:
                    odims.extend(d for d in dims if d not in odims)
                if len(own_parts) > 1:
                    o = np.zeros(
                        [len(domains[d]) for d in odims], dtype=np.float64
                    )
                    for dims, table in own_parts:
                        o = o + _align(table_in(table), dims, odims)
                else:
                    o = np.asarray(
                        table_in(own_parts[0][1]), dtype=np.float64
                    )
                    odims = list(own_parts[0][0])
                if (
                    fmt_sparse
                    and sr_n.cell_width == 1
                    and size * cw >= device_min_cells
                ):
                    # COO-pack a qualifying own part: the node can then
                    # contract over the candidate list
                    ps = pack_table(o, sr_n.plus_identity)
                    if ps is not None:
                        o = ps
                        if met.enabled:
                            met.inc("semiring.sparse_packs")
                parts.append((odims, o))
                # finite-masked: ±inf hard-constraint entries are EXACT
                # in f32 and must not void the certificate
                parts_max += _finite_amax(o)
            for c in plan.children[name]:
                cdims, ctable, cmax = sw.msgs[k][c]
                parts.append((cdims, ctable))
                parts_max += cmax
                err_in += sw.err[k].get(c, 0.0)
            if not parts:
                # an isolated, cost-free variable: the reduce of a
                # ⊗-identity table over its own domain
                if sr_n.kind == "expectation":
                    parts.append(([name], np.zeros((shape[-1], 2))))
                else:
                    parts.append(([name], np.zeros(shape[-1])))

            dmc = device_min_cells
            use_device = dmc is not None and size * cw >= dmc
            node_dt = call_dt
            local = 0.0
            if use_device and sr_n.error_bounded:
                # error-budget gate: a device pass whose accumulated
                # bound would exceed tol first DEMOTES to f32 storage,
                # then runs on host f64
                scale = max(parts_max, 1.0)

                def _local_err(dt):
                    q = int8_quant_bound(parts_max) if dt == "int8" else 0.0
                    return table_dtype_eps(dt) * (
                        (len(parts) + 1) * scale + shape[-1] + 2
                    ) + q

                local = _local_err(node_dt)
                if err_in + local > tol and node_dt != "f32":
                    node_dt = "f32"
                    local = _local_err(node_dt)
                    if met.enabled:
                        met.inc("semiring.precision_repairs")
                if err_in + local > tol:
                    use_device = False
                    if met.enabled:
                        met.inc("semiring.logsumexp_repairs")
            if not use_device:
                host_contract(
                    sr_n, k, name, plan, sep, target, shape, parts,
                    err_in,
                )
                continue
            # the per-row pruning budget (host f64, f32 slack folded in);
            # a mass node whose worst-case pruned mass (tol_node) would
            # push the ledger past tol dispatches unpruned
            ctx = ctxs[k]
            shiftc = 0.0
            budget = None
            if ctx is not None:
                shiftc = ctx.shift_under(plan.children[name])
                if not sr_n.error_bounded or (
                    err_in + local + ctx.tol_node <= tol
                ):
                    budget = ctx.budget(
                        name, shiftc, len(parts), parts_max, shape[-1],
                        size // max(shape[-1], 1),
                    )
            if fmt_sparse and sr_n.kind == "scalar":
                sprep = sparse_node_prep(
                    parts, target, shape, sr_n.plus_identity
                )
                if sprep is not None:
                    # candidate-list join: bucket by the pow-2 candidate
                    # geometry, never mixed with the dense buckets
                    if met.enabled:
                        met.inc("semiring.sparse_nodes")
                    sp_bnb = (
                        bnb_call
                        and budget is not None
                        and (bnb == "on" or size * cw >= BNB_AUTO_MIN_CELLS)
                    )
                    key = ("sparse", sr_n.name, node_dt, sprep.key, sp_bnb)
                    if key not in buckets:
                        buckets[key] = []
                        order.append(key)
                    buckets[key].append(
                        ((k, name, sep, target, shape, parts, parts_max,
                          err_in + sprep.trunc, budget, shiftc, node_dt),
                         sprep)
                    )
                    continue
                if met.enabled and any(
                    isinstance(t, SparseTable) for _, t in parts
                ):
                    # packed parts present but the intersection would
                    # not pay: the dense path densifies them back
                    met.inc("semiring.sparse_fallbacks")
            aligned = [_align(t, dims, target) for dims, t in parts]
            raw = (
                sr_n.name, node_dt, tuple(shape),
                tuple(a.shape for a in aligned),
            )
            key = _key_memo.get(raw)
            if key is None:
                # the level-pack key is shape-only; the ⊕ and the
                # storage dtype join the BUCKET key so a wave never
                # mixes kernels (a tol-demoted node lands in f32)
                key = _key_memo[raw] = (
                    sr_n.name, node_dt,
                    util_level_key(raw[2], raw[3], pad),
                )
            if key not in buckets:
                buckets[key] = []
                order.append(key)
            buckets[key].append(
                ((k, name, sep, target, shape, parts, parts_max, err_in,
                  budget, shiftc, node_dt), aligned)
            )

        if mixed and len(wave_srs) > 1 and met.enabled:
            met.inc("semiring.mixed_blocks")

        for key in order:
            entries = buckets[key]
            if timeout is not None and time.perf_counter() - t0 > timeout:
                return None
            if key[0] == "sparse":
                sr_b = get_semiring(key[1])
                if not _dispatch_sparse(
                    sw, sr_b, entries, pad, want_args, finish, met,
                    plans, torch_device, key[2], on_oom, key[4], ctxs,
                    tracer,
                ):
                    # device OOM on the candidate dispatch: redo the
                    # bucket's nodes on host f64 (``_align`` densifies
                    # the packs back)
                    if met.enabled:
                        met.inc("engine.oom_splits")
                    for item, _sp in entries:
                        host_contract(
                            sr_b, item[0], item[1], plans[item[0]],
                            item[2], item[3], item[4], item[5], item[7],
                        )
                continue
            sr_b = get_semiring(key[0])
            # ghost guard over padded own-axis cells is the ⊕-identity
            guard = sr_b.plus_identity
            bucket_dt = key[1]
            pshape, part_shapes = key[2]
            n_rows = len(entries)
            shape0 = entries[0][0][4]
            uniform = all(it[4] == shape0 for it, _ in entries)
            # "on" prunes every device bucket, "auto" the buckets whose
            # per-row padded table clears the threshold (a function of
            # the bucket key, so every entry agrees)
            use_bnb = False
            if bnb_call and any(it[8] is not None for it, _ in entries):
                per_row = int(np.prod(pshape)) * sr_b.cell_width
                use_bnb = bnb == "on" or per_row >= BNB_AUTO_MIN_CELLS
                if not use_bnb and met.enabled:
                    met.inc("semiring.bnb_skipped_small")
            if level_sync and uniform and n_rows > 1:
                if _dispatch_stacked(
                    sw, sr_b, entries, pshape, part_shapes, shape0, pad,
                    guard, want_args, finish, met, plans, torch_device,
                    bucket_dt, use_bnb, ctxs, tracer,
                ):
                    continue
                # OOM on the stacked dispatch: degrade to the per-node
                # path below
                if met.enabled:
                    met.inc("engine.oom_splits")
            fn = contraction_kernel(
                sr_b, pshape, part_shapes, bnb=use_bnb,
                table_dtype=bucket_dt,
            )
            for item, aligned in entries:
                (k, name, sep, target, shape, parts, _pm, err_in,
                 budget) = item[:9]
                if timeout is not None and time.perf_counter() - t0 > timeout:
                    return None
                padded = pad_util_parts(
                    aligned, shape, pshape, guard=guard,
                    with_mask=pad.enabled,
                )
                packed = _pack_parts(padded, bucket_dt, met)
                if use_bnb:
                    packed = [np.float32(
                        _no_prune(sr_b) if budget is None else budget
                    )] + list(packed)
                try:
                    outs = get_supervisor().dispatch(
                        lambda p=packed: _dispatch(fn, p, torch_device),
                        scope="semiring.node", width=1,
                        table_bytes=table_dtype_bytes(bucket_dt)
                        * int(np.prod(pshape)) * sr_b.cell_width,
                    )
                except DeviceOOMError:
                    if on_oom == "raise":
                        raise
                    host_contract(
                        sr_b, k, name, plans[k], sep, target, shape,
                        parts, err_in,
                    )
                    continue
                if met.enabled:
                    met.inc("semiring.dispatches")
                    if use_bnb:
                        met.inc("semiring.bnb_passes")
                sw.dispatches[k] += 1
                region = tuple(slice(0, s) for s in shape[:-1])
                pruned = _finish_device_row(
                    sw, sr_b, plans[k], item, outs, region, want_args,
                    finish, met, use_bnb, ctxs[k],
                )
                if use_bnb:
                    _note_bnb(met, tracer, sr_b, 1, pruned,
                              int(np.prod(shape)) * sr_b.cell_width)
    if tracer.enabled:
        tracer.add_span(
            "semiring.contract", "phase", t_sweep,
            time.perf_counter() - t_sweep, semiring=sr.name,
            instances=K, cells=sum(sw.cells),
        )
    return sw


def _dispatch_stacked(
    sw, sr, entries, pshape, part_shapes, shape0, pad, guard, want_args,
    finish, met, plans, torch_device, table_dtype, use_bnb=False,
    ctxs=(), tracer=None,
) -> bool:
    """One stacked dispatch for a uniform level-pack bucket: f64 stack
    buffers (ghost rows all zero, the mask row at the guard), packed at
    the bucket's storage dtype — int8 quantizes per (row, part), so
    every row carries its own scale/offset pair — in one host-to-device
    copy per storage type.  ``use_bnb`` prepends the per-row budget
    vector (pad rows at the no-prune sentinel, so ghost rows never reach
    the counters or the discard).  Returns False on device OOM (the
    caller degrades to per-node dispatches)."""
    n_rows = len(entries)
    stack_h = stack_bucket(n_rows) if pad.enabled else n_rows
    n_parts = len(part_shapes)
    has_mask = n_parts == len(entries[0][1]) + 1
    bufs = [
        np.zeros((stack_h,) + tuple(ps), dtype=np.float64)
        for ps in part_shapes
    ]
    for r, (item, aligned) in enumerate(entries):
        for i, a in enumerate(aligned):
            bufs[i][r][tuple(slice(0, s) for s in a.shape)] = a
        if has_mask:
            bufs[-1][r][..., shape0[-1]:] = guard
    fn = contraction_kernel(
        sr, pshape, part_shapes, batched=True, bnb=use_bnb,
        table_dtype=table_dtype,
    )
    dequant, packed = pack_rows(bufs, table_dtype, n_rows, met)
    budgets = [_budgets(entries, stack_h, sr)] if use_bnb else []
    try:
        outs = get_supervisor().dispatch(
            lambda: _dispatch(fn, budgets + dequant + packed, torch_device),
            scope="semiring.level", width=stack_h,
            table_bytes=table_dtype_bytes(table_dtype)
            * int(np.prod(pshape)) * sr.cell_width,
        )
    except DeviceOOMError:
        return False
    if met.enabled:
        met.inc("semiring.dispatches")
        if use_bnb:
            met.inc("semiring.bnb_passes")
    for k in sorted({item[0] for item, _ in entries}):
        sw.dispatches[k] += 1
    region_rows = tuple(slice(0, s) for s in shape0[:-1])
    pruned = 0
    for r, (item, _) in enumerate(entries):
        pruned += _finish_device_row(
            sw, sr, plans[item[0]], item, tuple(o[r] for o in outs),
            region_rows, want_args, finish, met, use_bnb,
            ctxs[item[0]] if use_bnb else None,
        )
    if use_bnb:
        _note_bnb(met, tracer, sr, n_rows, pruned,
                  int(np.prod(shape0)) * sr.cell_width * n_rows)
    return True


def _quantize_rows(bufs, n_rows, met):
    """int8 packs of stacked buffers, per (row, part): ``[scales,
    offsets] + codes`` with ``[stack, P]`` scale/offset arrays; ghost
    rows stay all-zero codes under the identity (scale 1, offset 0)
    dequant.  Counts ``semiring.int8_requant``."""
    stack_h = bufs[0].shape[0] if bufs else 0
    scales = np.ones((stack_h, len(bufs)), dtype=np.float32)
    offsets = np.zeros((stack_h, len(bufs)), dtype=np.float32)
    qbufs = [np.zeros(b.shape, dtype=np.int8) for b in bufs]
    for r in range(n_rows):
        for i, b in enumerate(bufs):
            q, s, o = quantize_table_int8(b[r])
            qbufs[i][r] = q
            scales[r, i] = s
            offsets[r, i] = o
    if met.enabled:
        met.inc("semiring.int8_requant", n_rows * len(bufs))
    return [scales, offsets] + qbufs


def _dispatch_sparse(
    sw, sr, entries, pad, want_args, finish, met, plans, torch_device,
    table_dtype, on_oom, use_bnb=False, ctxs=(), tracer=None,
) -> bool:
    """One stacked candidate-list dispatch for a sparse bucket
    (``ops/sparse.py``): every entry shares the pow-2 candidate
    geometry, so the rows stack under one
    :func:`~pydcop_tpu_torch.ops.sparse.sparse_contraction_kernel` as
    the dense level packs do.  Ghost candidates land in the ghost
    segment, and pad rows carry the no-prune sentinel under
    ``use_bnb``.  The i32 index buffers go over in one copy, the packed
    values in one more (int8: its scales/offsets too).  Returns False
    on device OOM (the caller redoes the bucket on host f64) unless
    ``on_oom="raise"``."""
    sp0 = entries[0][1]
    n_cand_b, n_seg_b, part_lens_b = sp0.key
    n_rows = len(entries)
    stack_h = stack_bucket(n_rows) if pad.enabled else n_rows
    P = len(part_lens_b)
    sep_b = np.full((stack_h, n_cand_b), n_seg_b, dtype=np.int32)
    own_b = np.zeros((stack_h, n_cand_b), dtype=np.int32)
    val_bufs = [np.zeros((stack_h, L), dtype=np.float64) for L in part_lens_b]
    gid_bufs = [
        np.zeros((stack_h, n_cand_b), dtype=np.int32) for _ in part_lens_b
    ]
    for r, (_item, sp) in enumerate(entries):
        nc = sp.n_cand
        sep_b[r, :nc] = sp.sep_ids
        own_b[r, :nc] = sp.own_ids
        for i in range(P):
            val_bufs[i][r, : sp.part_flats[i].size] = sp.part_flats[i]
            gid_bufs[i][r, :nc] = sp.gidx[i]
    fn = sparse_contraction_kernel(
        sr, n_cand_b, n_seg_b, part_lens_b, bnb=use_bnb,
        table_dtype=table_dtype,
    )
    dequant, packed = pack_rows(val_bufs, table_dtype, n_rows, met)
    args = dequant + [sep_b, own_b] + packed + gid_bufs
    if use_bnb:
        args = [_budgets(entries, stack_h, sr)] + args
    try:
        outs = get_supervisor().dispatch(
            lambda: _dispatch(fn, args, torch_device),
            scope="semiring.level", width=stack_h,
            # the real packed bytes: candidate index buffers plus the
            # value packs at the storage dtype, not the dense box
            table_bytes=n_cand_b * (8 + 4 * P)
            + table_dtype_bytes(table_dtype) * sum(part_lens_b),
        )
    except DeviceOOMError:
        if on_oom == "raise":
            raise
        return False
    if met.enabled:
        met.inc("semiring.dispatches")
        if use_bnb:
            met.inc("semiring.bnb_passes")
    for k in sorted({item[0] for item, _ in entries}):
        sw.dispatches[k] += 1
    pruned = 0
    dense_cells = 0
    for r, (item, _sp) in enumerate(entries):
        shape = item[4]
        sshape = tuple(shape[:-1])
        n_seg = 1
        for s in sshape:
            n_seg *= s
        dense_cells += n_seg * shape[-1]
        row_outs = tuple(
            o[r] if o.ndim == 1 else o[r][:n_seg].reshape(sshape)
            for o in outs  # the mass discard is one scalar a row
        )
        region = tuple(slice(0, s) for s in sshape)
        pruned += _finish_device_row(
            sw, sr, plans[item[0]], item, row_outs, region, want_args,
            finish, met, use_bnb, ctxs[item[0]] if use_bnb else None,
        )
    if use_bnb:
        _note_bnb(met, tracer, sr, n_rows, pruned, dense_cells)
    return True


def _finish_device_row(
    sw, sr, plan, item, outs, region, want_args, finish, met, bnb=False,
    ctx=None,
) -> int:
    """Certify / account one device contraction and finish the node.

    The certificates and ledgers re-scale to the STORAGE dtype the
    dispatch ran at: its unit roundoff replaces eps32, and int8 adds
    the quantization bound.  Idempotent ⊕: certify the arg against the
    decision-margin bound, repair near-ties on the host, and re-evaluate
    the projected values in exact f64 at the certified arg (tie-heavy
    tables, more than 10% of cells uncertifiable, are redone wholesale
    on the host).  kbest: the per-component certificate, then host-f64
    values at the certified backpointers (or the whole node on the
    host).  logsumexp ⊕ and expectation: accept the f32 values and
    extend the accumulated error bound (the ``tol`` gate already ran
    before dispatch).  A low-precision node whose certificate sent
    cells to the host counts ``semiring.precision_repairs``.

    ``bnb``: the trailing outputs are the keep mask (and, for the mass
    kinds, the measured discard, accounted into the ledger through
    ``ctx``).  Pruned rows hold the ⊕-identity and ``+inf`` margins, so
    they skip certification and repair; when at least a quarter of the
    cells are pruned the exact f64 re-evaluation gathers the survivors
    only.  Returns the pruned join-cell count (0 without pruning)."""
    (k, name, sep, target, shape, parts, parts_max, err_in,
     _budget, shiftc, node_dt) = item
    eps_dt = table_dtype_eps(node_dt)
    quant = int8_quant_bound(parts_max) if node_dt == "int8" else 0.0
    keep_r = None
    disc = None
    pruned_cells = 0
    if bnb:
        if sr.idempotent or sr.kind == "kbest":
            *outs, keep = outs
        else:
            *outs, keep, disc = outs
        keep_r = np.asarray(keep[region], dtype=bool)
        pruned_cells = int(keep_r.size - keep_r.sum()) * shape[
            -1
        ] * sr.cell_width
    if sr.kind == "kbest":
        vals, margins, own_idx, *slots = outs
        margins = np.asarray(margins[region], dtype=np.float64)
        local_err = storage_error(node_dt, len(parts), parts_max)
        # per-COMPONENT certificate: every selected slot must beat the
        # next candidate by the rounding bound, or the whole node is
        # redone on host f64 (still exact)
        if np.any(margins < 2.0 * (local_err + err_in)):
            if met.enabled:
                met.inc("semiring.cert_fallbacks")
                if node_dt != "f32":
                    met.inc("semiring.precision_repairs")
            u, own, provs = _kbest_host(parts, target, shape, sr.cell_width)
            sw.host_nodes[k] += 1
            finish(
                sr, k, name, plan, sep, u,
                (own, dict(zip(plan.children[name], provs))),
            )
            return pruned_cells
        own = np.asarray(own_idx[region], dtype=np.intp)
        slot_arrs = [np.asarray(s[region], dtype=np.intp) for s in slots]
        u = _kbest_reeval(parts, target, shape, own, slot_arrs)
        # slots past the candidate count are +inf in the kernel's
        # values; their backpointers are clamped padding (a pruned
        # row's slots are all +inf, so it stays the ⊕-identity too)
        u = np.where(np.isfinite(np.asarray(vals[region])), u, np.inf)
        sw.device_nodes[k] += 1
        finish(
            sr, k, name, plan, sep, u,
            (own, dict(zip(plan.children[name], slot_arrs))),
        )
    elif sr.idempotent:
        arg, margins = outs
        arg = np.array(arg[region])  # writable (repair)
        margins = np.asarray(margins[region], dtype=np.float64)
        local_err = storage_error(node_dt, len(parts), parts_max)
        bad = np.argwhere(margins < 2.0 * (local_err + err_in))
        note_precision_repairs(met, node_dt, len(bad))
        if len(bad) * 10 > margins.size:
            # tie-heavy: redo the whole contraction on host f64
            if met.enabled:
                met.inc("semiring.cert_fallbacks")
            j = np.zeros(shape, dtype=np.float64)
            for dims, table in parts:
                j = j + _align(table, dims, target)
            u = sr.reduce(j, axis=-1)
            arg = sr.arg_reduce(j, axis=-1) if want_args else None
            sw.host_nodes[k] += 1
            if err_in:
                sw.err[k][name] = err_in
            finish(sr, k, name, plan, sep, u, arg)
            return pruned_cells
        for cell in map(tuple, bad):
            row = np.zeros(shape[-1], dtype=np.float64)
            for dims, table in parts:
                row += _cell_row(table, dims, target, cell)
            arg[cell] = int(sr.arg_reduce(row, axis=-1))
        # exact f64 values AT the certified arg: children contribute
        # zero error to their parents, whatever the tree depth
        own = target[-1]
        if (
            keep_r is not None
            and len(shape) > 1
            and 4 * int(keep_r.sum()) < 3 * keep_r.size
        ):
            # a quarter or more pruned: gather the survivors only
            coords = np.nonzero(keep_r)
            a_sel = arg[coords]
            u = np.full(tuple(shape[:-1]), sr.plus_identity)
            acc = np.zeros(len(coords[0]), dtype=np.float64)
            for dims, table in parts:
                idx = [
                    a_sel if d == own else coords[target.index(d)]
                    for d in dims
                ]
                acc += _part_gather(table, tuple(idx))
            u[coords] = acc
        else:
            grids = (
                np.indices(tuple(shape[:-1]), dtype=np.intp)
                if len(shape) > 1
                else None
            )
            u = np.zeros(tuple(shape[:-1]), dtype=np.float64)
            for dims, table in parts:
                idx = [
                    arg if d == own else grids[target.index(d)]
                    for d in dims
                ]
                u += _part_gather(table, tuple(idx))
            if keep_r is not None:
                u = np.where(keep_r, u, sr.plus_identity)
        sw.device_nodes[k] += 1
        if err_in:
            sw.err[k][name] = err_in
        finish(sr, k, name, plan, sep, u, arg)
    else:  # logsumexp and expectation: the values are the answer
        (vals,) = outs
        u = np.asarray(vals[region], dtype=np.float64)
        extra = (
            ctx.account(name, float(disc), shiftc, shape[-1])
            if ctx is not None and disc is not None
            else 0.0
        )
        sw.err[k][name] = err_in + eps_dt * (
            (len(parts) + 1) * max(parts_max, 1.0) + shape[-1] + 2
        ) + quant + extra
        sw.device_nodes[k] += 1
        finish(sr, k, name, plan, sep, u, None)
    return pruned_cells


def _part_gather(table, idx):
    """Exact f64 advanced-indexing gather of one part; a packed part
    looks its values up by flat index (misses return the fill)."""
    if isinstance(table, SparseTable):
        return table.gather(idx)
    return np.asarray(table, dtype=np.float64)[idx]


def _cell_row(table, dims, target, cell):
    """Exact f64 row of one part at a fixed separator cell (broadcast
    over the own axis when the part does not carry it)."""
    own = target[-1]
    if isinstance(table, SparseTable):
        if own not in dims:
            fix = tuple(cell[target.index(d)] for d in dims)
            return np.full(1, float(table.gather(fix)))
        ax = list(dims).index(own)
        return table.gather(
            tuple(
                np.arange(table.shape[ax])
                if d == own
                else cell[target.index(d)]
                for d in dims
            )
        )
    idx = [
        slice(None) if d == own else cell[target.index(d)] for d in dims
    ]
    row = np.asarray(table, dtype=np.float64)[tuple(idx)]
    if own not in dims:
        return np.full(1, float(row))
    return row


# -- structured-cell host contractions ----------------------------------


def _kbest_host(parts, target, shape, kk):
    """Exact host-f64 top-K contraction of one node with provenance:
    scalar parts broadcast-add into the base ``j``, child k-cells
    cross-sum-truncate one at a time, then the own-axis projection
    merge-sorts the ``d·k`` candidates.  Returns ``(values [sep..,k],
    own-value index [sep..,k], per-child slot arrays)``; ties select by
    candidate index (stable argsort), as the device kernel does."""
    j = np.zeros(shape, dtype=np.float64)
    vecs = []
    for dims, t in parts:
        t = np.asarray(t, dtype=np.float64)
        if t.ndim == len(dims) + 1:
            vecs.append(_align(t, dims, target))
        else:
            j = j + _align(t, dims, target)
    if vecs:
        with np.errstate(invalid="ignore"):
            cell = j[..., None] + np.broadcast_to(vecs[0], shape + [kk])
        provs = [
            np.broadcast_to(np.arange(kk, dtype=np.intp), cell.shape)
        ]
        for t in vecs[1:]:
            with np.errstate(invalid="ignore"):
                sums = cell[..., :, None] + np.broadcast_to(
                    t, shape + [kk]
                )[..., None, :]
            flat = sums.reshape(sums.shape[:-2] + (kk * kk,))
            idx = np.argsort(flat, axis=-1, kind="stable")[..., :kk]
            cell = np.take_along_axis(flat, idx, axis=-1)
            provs = [
                np.take_along_axis(p, idx // kk, axis=-1) for p in provs
            ]
            provs.append(idx % kk)
    else:
        lift = np.full(kk, np.inf)
        lift[0] = 0.0
        cell = j[..., None] + lift
        provs = []
    d = shape[-1]
    flat = cell.reshape(cell.shape[:-2] + (d * kk,))
    idx = np.argsort(flat, axis=-1, kind="stable")[..., :kk]
    vals = np.take_along_axis(flat, idx, axis=-1)
    own = idx // kk
    provs = [
        np.take_along_axis(
            np.ascontiguousarray(p).reshape(p.shape[:-2] + (d * kk,)),
            idx,
            axis=-1,
        )
        for p in provs
    ]
    if vals.shape[-1] < kk:
        pad = kk - vals.shape[-1]
        vals = np.concatenate(
            [vals, np.full(vals.shape[:-1] + (pad,), np.inf)], -1
        )
        own = np.concatenate(
            [own, np.zeros(own.shape[:-1] + (pad,), np.intp)], -1
        )
        provs = [
            np.concatenate(
                [p, np.zeros(p.shape[:-1] + (pad,), np.intp)], -1
            )
            for p in provs
        ]
    return vals, own, provs


def _kbest_reeval(parts, target, shape, own, slot_arrs):
    """Exact f64 top-K values AT certified device backpointers: the
    same part-order accumulation as :func:`_kbest_host`, gathered at the
    selected (own value, child slot) per separator cell and slot."""
    kk = own.shape[-1]
    grids = np.indices(tuple(shape[:-1]) + (kk,), dtype=np.intp)
    u = np.zeros(tuple(shape[:-1]) + (kk,), dtype=np.float64)
    sep_idx = [grids[target.index(d)] for d in target[:-1]]
    vec_i = 0
    for dims, t in parts:
        t64 = np.asarray(t, dtype=np.float64)
        if t64.ndim == len(dims) + 1:
            a = np.broadcast_to(
                _align(t64, dims, target), tuple(shape) + (kk,)
            )
            u = u + a[tuple(sep_idx) + (own, slot_arrs[vec_i])]
            vec_i += 1
        else:
            a = np.broadcast_to(_align(t64, dims, target), tuple(shape))
            u = u + a[tuple(sep_idx) + (own,)]
    return u


def _expect_host(parts, target, shape):
    """Host-f64 expectation contraction of one node: pair parts add per
    plane (scalar parts weight only), then the own-axis ⊕."""
    lw = np.zeros(shape, dtype=np.float64)
    r = np.zeros(shape, dtype=np.float64)
    for dims, t in parts:
        t = np.asarray(t, dtype=np.float64)
        if t.ndim == len(dims) + 1:
            a = _align(t, dims, target)
            lw = lw + a[..., 0]
            r = r + a[..., 1]
        else:
            lw = lw + _align(t, dims, target)
    return _exp_pair_reduce(np.stack([lw, r], axis=-1), (len(shape) - 1,))


# -- queries ------------------------------------------------------------


def _value_phase(
    plan: ContractionPlan, args, only: Optional[set] = None
) -> Dict[str, Any]:
    """Top-down MAP value wave: condition each node's retained arg
    table on the accumulated ancestor assignment.  ``only`` restricts
    the walk to the maximized block of a marginal-MAP plan."""
    assignment: Dict[str, Any] = {}
    idx: Dict[str, int] = {}
    for name in reversed(plan.order):
        if only is not None and name not in only:
            continue
        sep, arg = args[name]
        best = int(arg[tuple(idx[d] for d in sep)])
        idx[name] = best
        assignment[name] = plan.domains[name][best]
    return assignment


def _kbest_solutions(plan: ContractionPlan, root_cells, args, kk):
    """The K best full assignments of one instance, in cost order:
    cross-sum the per-root K-best cells (roots are independent), then
    walk each slot's backpointers top-down.  Returns ``[(energy value —
    shifts excluded, {var: value-index})]``."""
    combos: List[Tuple[float, tuple]] = [(0.0, ())]
    for rt in plan.roots:
        cell = root_cells[rt]
        nxt = []
        for base, slots in combos:
            for s in range(cell.shape[-1]):
                v = float(cell[s])
                if np.isfinite(v):
                    nxt.append((base + v, slots + (s,)))
        nxt.sort(key=lambda t: (t[0], t[1]))
        combos = nxt[:kk]
    out = []
    for val, slots in combos:
        idx: Dict[str, int] = {}
        stack = list(zip(plan.roots, slots))
        while stack:
            v, s = stack.pop()
            sep, (own, cslots) = args[v]
            cell_i = tuple(idx[d] for d in sep)
            idx[v] = int(own[cell_i + (s,)])
            for c in plan.children[v]:
                stack.append((c, int(cslots[c][cell_i + (s,)])))
        out.append((val, idx))
    return out


def _downward_marginals(
    plan: ContractionPlan,
    sw: _Sweep,
    k: int,
    sr: Semiring,
    beta: float,
    t0: float,
    timeout: Optional[float],
) -> Optional[Dict[str, np.ndarray]]:
    """Host-f64 downward pass: outside-messages root→leaves, then each
    variable's normalized marginal.  Prefix/suffix child combines (no
    log-domain subtraction, so ``-inf`` entries stay well-defined)."""
    down: Dict[str, Tuple[List[str], np.ndarray]] = {}
    marginals: Dict[str, np.ndarray] = {}

    for name in reversed(plan.order):  # parents before children
        if timeout is not None and time.perf_counter() - t0 > timeout:
            return None
        sep = sw.seps[k][name]
        target = sep + [name]
        shape = [len(plan.domains[d]) for d in target]
        base = np.zeros(shape, dtype=np.float64)
        for dims, table in plan.buckets[name]:
            base = base + _align((-beta) * table, dims, target)
        if name in down:
            ddims, dtable = down[name]
            base = base + _align(dtable, ddims, target)
        cs = plan.children[name]
        aligned_c = [
            _align(sw.msgs[k][c][1], sw.msgs[k][c][0], target) for c in cs
        ]
        prefix = [np.zeros(shape, dtype=np.float64)]
        for a in aligned_c:
            prefix.append(prefix[-1] + a)
        suffix = [np.zeros(shape, dtype=np.float64)]
        for a in reversed(aligned_c):
            suffix.append(suffix[-1] + a)
        suffix.reverse()
        joint = base + prefix[-1]
        b = sr.reduce(joint, axis=tuple(range(len(sep)))) if sep else joint
        m = float(np.max(b)) if np.isfinite(np.max(b)) else 0.0
        p = np.exp(b - m)
        total = float(p.sum())
        marginals[name] = (
            p / total if total > 0 else np.full_like(p, 1.0 / p.size)
        )
        for i, c in enumerate(cs):
            excl = base + prefix[i] + suffix[i + 1]
            sep_c = sw.msgs[k][c][0]
            keep = set(sep_c)
            axes = tuple(
                ax for ax, d in enumerate(target) if d not in keep
            )
            d_c = sr.reduce(excl, axis=axes) if axes else excl
            shift = float(np.max(d_c))
            if np.isfinite(shift):
                d_c = d_c - shift
            down[c] = ([d for d in target if d in keep], d_c)
    return marginals


def run_infer_many(
    dcops: Sequence[Any],
    query: str,
    *,
    order: str = "pseudo_tree",
    beta: float = 1.0,
    tol: float = 1e-6,
    device: str = "auto",
    device_min_cells: int = 1 << 14,
    pad_policy: Any = None,
    max_table_size: int = 1 << 26,
    timeout: Optional[float] = None,
    max_util_bytes: Optional[int] = None,
    map_vars: Optional[Sequence[str]] = None,
    external_dists: Optional[Mapping[str, Mapping[Any, float]]] = None,
    bnb: str = "auto",
    table_dtype: str = "f32",
    table_format: str = "dense",
    torch_device: Optional[torch.device] = None,
    _plans: Optional[Sequence["ContractionPlan"]] = None,
    _memos: Optional[Sequence[Any]] = None,
) -> List[Dict[str, Any]]:
    """Run one inference query over K instances with their contraction
    sweeps MERGED (same-bucket contractions from different instances
    share one stacked dispatch; per-instance results equal sequential
    calls) — the engine behind ``api.infer``/``api.infer_many``, whose
    callers own the telemetry session.

    Queries: ``"map"`` (max/+, certified exact), ``"log_z"`` (``log
    Σ_x exp(-beta·E(x))``), ``"marginals"`` (per-variable distributions
    plus ``log_z``), ``"kbest:<k>"`` (the k best assignments, exact),
    ``"marginal_map"`` (``map_vars`` maximized over the logsumexp of the
    rest) and ``"expectation"`` (``E[cost]``, with ``external_dists``
    for stochastic externals).

    ``device`` is the offload policy (``"auto"``: tables of at least
    ``device_min_cells`` cells; ``"never"``: pure host f64;
    ``"always"``); the device contractions run on ``torch_device``.
    ``table_dtype`` (``f32``/``bf16``/``int8``) and ``table_format``
    (``dense``/``sparse``) pick the storage of the device parts
    (:func:`contract_sweep`).  ``max_util_bytes`` runs the sweep
    MEMORY-BOUNDED (``ops/membound.py``): domains are
    consistency-pruned, every contraction table is kept under the
    budget by conditioning a cut set of variables whose assignments ride
    the level-pack stack as extra lanes, and the result carries a
    ``membound`` block; an unplannable budget raises
    :class:`~pydcop_tpu_torch.ops.membound.MemboundError`.
    ``bnb`` (``"auto"``, ``"on"``, ``"off"``) prunes the device
    contractions by branch and bound (:func:`contract_sweep`): map and
    kbest stay exact; the mass queries account the pruned mass into
    ``error_bound``.

    ``_plans`` / ``_memos`` are the private session hooks
    (``engine/memo.py:InferSession``): pre-built plans skip
    :func:`build_plan` (the session re-tabulates them in place on
    deltas) and per-instance memo views flow into
    :func:`contract_sweep`.
    """
    t0 = time.perf_counter()
    qkind, sr = parse_query(query)
    bnb = as_bnb(bnb, "auto")
    table_dtype = as_table_dtype(table_dtype)
    table_format = as_table_format(table_format)
    if device not in ("auto", "never", "always"):
        raise ValueError(
            f"device must be 'auto'|'never'|'always', got {device!r}"
        )
    if beta <= 0:
        raise ValueError(f"beta must be > 0, got {beta}")
    if qkind == "marginal_map":
        if not map_vars:
            raise ValueError(
                "marginal_map needs map_vars=[...] — the variables "
                "maximized over (every other variable is summed out; "
                "with none maximized the query is 'log_z')"
            )
    elif map_vars:
        raise ValueError(
            f"map_vars applies to query='marginal_map' only, not "
            f"{query!r}"
        )
    if external_dists and qkind != "expectation":
        raise ValueError(
            "external_dists weight assignments by external-variable "
            f"probabilities — query {query!r} has no expectation to "
            "weight (use query='expectation')"
        )
    pad = as_pad_policy(pad_policy)
    dmc: Optional[int]
    if device == "never":
        dmc = None
    elif device == "always":
        dmc = 0
    else:
        dmc = int(device_min_cells)

    from pydcop_tpu_torch.telemetry import get_tracer

    tracer = get_tracer()
    K = len(dcops)
    deadline = None if timeout is None else t0 + timeout
    if _plans is not None:
        plans = list(_plans)
    else:
        try:
            plans = [
                build_plan(
                    d, order=order, deadline=deadline,
                    max_vars=(
                        map_vars if qkind == "marginal_map" else None
                    ),
                    external_dists=(
                        external_dists if qkind == "expectation" else None
                    ),
                )
                for d in dcops
            ]
        except TimeoutError:
            # plan construction (the min_fill search) ate the budget
            return [_timeout_result(query, t0) for _ in range(K)]
    want_args = qkind in ("map", "marginal_map", "kbest")

    if max_util_bytes is not None:
        if qkind == "marginal_map":
            raise ValueError(
                "marginal_map cannot run memory-bounded: "
                "conditioning a summed variable would hoist the max "
                "outside its sum (lanes ⊕-combine per lane, and "
                "max_{M} Σ_{S} ≠ Σ_{S cut} max_{M}) — raise the "
                "budget or narrow the order instead"
            )
        return _run_bounded_infer(
            dcops, plans, qkind, sr,
            max_util_bytes=int(max_util_bytes), beta=beta, dmc=dmc,
            pad=pad, tol=tol, max_table_size=max_table_size,
            want_args=want_args, t0=t0, timeout=timeout, K=K,
            query=query, bnb=bnb, table_dtype=table_dtype,
            table_format=table_format, torch_device=torch_device,
        )

    sw = contract_sweep(
        plans, sr, beta=beta, device_min_cells=dmc, pad=pad, tol=tol,
        max_table_size=max_table_size, want_args=want_args, t0=t0,
        timeout=timeout, bnb=bnb, memos=_memos, table_dtype=table_dtype,
        table_format=table_format, torch_device=torch_device,
    )
    if sw is None:
        return [_timeout_result(query, t0) for _ in range(K)]

    results: List[Dict[str, Any]] = []
    for k, (dcop, plan) in enumerate(zip(dcops, plans)):
        agg = sw.root_total[k] + sw.total_shift[k] - beta * plan.const_energy
        # the instance bound is the sum over ROOT accumulations only:
        # each node's entry already chains its whole subtree
        err = sum(sw.err[k].get(r, 0.0) for r in plan.roots)
        out: Dict[str, Any] = {
            "query": query,
            "semiring": sr.name,
            "order": plan.order_name,
            "status": "finished",
            "cells": sw.cells[k],
            "dispatches": sw.dispatches[k],
            "device_nodes": sw.device_nodes[k],
            "host_nodes": sw.host_nodes[k],
            "width": max((len(s) for s in sw.seps[k].values()), default=0),
            "error_bound": err,
            "instances_batched": K,
        }
        if qkind == "map":
            assignment = _value_phase(plan, sw.args[k])
            out["assignment"] = assignment
            out["cost"] = dcop.solution_cost(assignment)
            out["log_weight"] = agg
        elif qkind == "marginal_map":
            out["assignment"] = _value_phase(
                plan, sw.args[k], only=set(plan.max_vars)
            )
            out["map_vars"] = list(plan.max_vars)
            out["value"] = agg  # max_{x_M} log Σ_{x_S} e^{-βE}
        elif qkind == "kbest":
            out.update(_kbest_result(plan, sw, k, sr.cell_width, dcop))
        elif qkind == "expectation":
            cells = [sw.root_cells[k][rt] for rt in plan.roots]
            lw = sum(float(c[0]) for c in cells)
            rr = sum(float(c[1]) for c in cells)
            out["log_z"] = lw + sw.total_shift[k] - beta * plan.const_energy
            out["e_cost"] = rr + plan.const_energy
        elif qkind == "log_z":
            out["log_z"] = agg
        else:  # marginals
            t_down = time.perf_counter()
            margs = _downward_marginals(plan, sw, k, sr, beta, t0, timeout)
            if margs is None:
                results.append(_timeout_result(query, t0))
                continue
            if tracer.enabled:
                tracer.add_span(
                    "semiring.downward", "phase", t_down,
                    time.perf_counter() - t_down, semiring=sr.name,
                )
            out["marginals"] = {
                v: [float(x) for x in p] for v, p in margs.items()
            }
            out["log_z"] = agg
        out["time"] = (time.perf_counter() - t0) / K
        results.append(out)
    return results


def _kbest_result(plan, sw, k, kk, dcop) -> Dict[str, Any]:
    """The kbest result block for one instance: walk the backpointers,
    fold the shifts back into the energy values, and report each
    solution with its dcop-convention cost — K distinct assignments,
    best first."""
    solutions = []
    for val, idx in _kbest_solutions(plan, sw.root_cells[k], sw.args[k], kk):
        assignment = {v: plan.domains[v][i] for v, i in idx.items()}
        solutions.append(
            {
                "assignment": assignment,
                "cost": dcop.solution_cost(assignment),
                "energy": val + sw.total_shift[k] + plan.const_energy,
            }
        )
    out: Dict[str, Any] = {
        "k": kk,
        "solutions": solutions,
        "costs": [s["cost"] for s in solutions],
    }
    if solutions:
        out["assignment"] = solutions[0]["assignment"]
        out["cost"] = solutions[0]["cost"]
    return out


def _timeout_result(query: str, t0: float) -> Dict[str, Any]:
    return {
        "query": query,
        "status": "timeout",
        "time": time.perf_counter() - t0,
    }


def _run_bounded_infer(
    dcops, plans, qkind, sr, *, max_util_bytes, beta, dmc, pad,
    tol, max_table_size, want_args, t0, timeout, K,
    query: Optional[str] = None, bnb: str = "off",
    table_dtype: str = "f32", table_format: str = "dense",
    torch_device: Optional[torch.device] = None,
) -> List[Dict[str, Any]]:
    """Memory-bounded assembly behind :func:`run_infer_many`
    (``max_util_bytes`` set): the budgeted lane sweep
    (``ops/membound.py``) plus the per-⊕ cross-lane combines —
    idempotent ⊕ picks the best lane (exact), logsumexp ⊕-combines
    the lane values under the worst-lane error bound, marginals mix
    lane marginals by lane weight and scatter over the original
    (pre-pruning) domains, kbest merge-sorts the lanes' solution
    lists (lanes partition the assignment space, so the truncated
    merge is the exact instance list), and expectation ⊕-combines
    the lanes' (log w, r) pairs."""
    from pydcop_tpu_torch.ops import membound as _mb
    from pydcop_tpu_torch.telemetry import get_tracer

    query = qkind if query is None else query
    tracer = get_tracer()
    bs = _mb.run_bounded(
        plans, sr, max_util_bytes=max_util_bytes, beta=beta,
        device_min_cells=dmc, pad=pad, tol=tol,
        max_table_size=max_table_size, want_args=want_args,
        t0=t0, timeout=timeout, bnb=bnb, table_dtype=table_dtype,
        table_format=table_format, torch_device=torch_device,
    )
    if bs is None:
        return [_timeout_result(query, t0) for _ in range(K)]
    results: List[Dict[str, Any]] = []
    for k, (dcop, plan) in enumerate(zip(dcops, bs.plans)):
        const = beta * plan.const_energy
        out: Dict[str, Any] = {
            "query": query,
            "semiring": sr.name,
            "order": plan.order_name,
            "status": "finished",
            **bs.stats(k),
            "width": bs.width(k),
            "instances_batched": K,
            "membound": bs.meta(k),
        }
        if qkind == "map":
            winner = bs.best_lane(k, maximize=True)
            assignment = _value_phase(
                bs.lanes[winner], bs.sw.args[winner]
            )
            out["assignment"] = assignment
            out["cost"] = dcop.solution_cost(assignment)
            out["log_weight"] = (
                bs.lane_values(k)[winner - bs.ranges[k][0]] - const
            )
            out["error_bound"] = 0.0  # certified per lane, exact
        elif qkind == "kbest":
            kk = sr.cell_width
            lo, hi = bs.ranges[k]
            all_sols: List[Tuple[float, Dict[str, Any]]] = []
            for l in range(lo, hi):
                lane = bs.lanes[l]
                for val, idx in _kbest_solutions(
                    lane, bs.sw.root_cells[l], bs.sw.args[l], kk
                ):
                    a = {
                        v: lane.domains[v][i]
                        for v, i in idx.items()
                    }
                    all_sols.append(
                        (
                            val + bs.sw.total_shift[l]
                            + plan.const_energy,
                            a,
                        )
                    )
            all_sols.sort(
                key=lambda t: (t[0], sorted(t[1].items()).__repr__())
            )
            solutions = [
                {
                    "assignment": a,
                    "cost": dcop.solution_cost(a),
                    "energy": val,
                }
                for val, a in all_sols[:kk]
            ]
            out["k"] = kk
            out["solutions"] = solutions
            out["costs"] = [s["cost"] for s in solutions]
            if solutions:
                out["assignment"] = solutions[0]["assignment"]
                out["cost"] = solutions[0]["cost"]
            out["error_bound"] = 0.0  # certified per lane, exact
        elif qkind == "expectation":
            lo, hi = bs.ranges[k]
            lws, rs = [], []
            for l in range(lo, hi):
                cells = [
                    bs.sw.root_cells[l][rt]
                    for rt in bs.lanes[l].roots
                ]
                lws.append(
                    sum(float(c[0]) for c in cells)
                    + bs.sw.total_shift[l]
                )
                rs.append(sum(float(c[1]) for c in cells))
            pair = _exp_pair_reduce(
                np.stack(
                    [np.asarray(lws), np.asarray(rs)], axis=-1
                ),
                (0,),
            )
            out["log_z"] = float(pair[0]) - const
            out["e_cost"] = float(pair[1]) + plan.const_energy
            errs = bs.lane_errs(k)
            out["error_bound"] = (
                max(errs, default=0.0)
                + _EPS64 * (len(errs) + 2)
            )
        elif qkind == "log_z":
            v, err = bs.logsumexp_lanes(k)
            out["log_z"] = v - const
            out["error_bound"] = err
        else:  # marginals
            t_down = time.perf_counter()
            margs = _mb.combine_marginals(
                bs, k, sr, beta, t0, timeout
            )
            if margs is None:
                results.append(_timeout_result(query, t0))
                continue
            if tracer.enabled:
                tracer.add_span(
                    "semiring.downward", "phase", t_down,
                    time.perf_counter() - t_down, semiring=sr.name,
                )
            out["marginals"] = {
                v: [float(x) for x in p] for v, p in margs.items()
            }
            z, err = bs.logsumexp_lanes(k)
            out["log_z"] = z - const
            out["error_bound"] = err
        out["time"] = (time.perf_counter() - t0) / K
        results.append(out)
    return results
