"""Sparse (COO) constraint tables — packed storage and the
gather/segment-reduce join of the contraction sweep (a port of
``pydcop_tpu/ops/sparse.py``).

A :class:`SparseTable` stores the FEASIBLE tuples of a table only: a
sorted COO pack (flat row-major indices + values) whose absent cells
default to the ⊕-identity (``+inf`` for min-domain energies, ``-inf``
for log-weights).  A node whose parts include sparse tables contracts
over a CANDIDATE LIST: the host intersects the parts' lifted supports
(a tuple can only be finite where EVERY hard part is feasible), ships
the candidates as ``(sep_id, own_id)`` pairs plus one flat gather index
per part, and the device kernel is gathers, an add and a per-separator
reduce — no dense box materializes on the device.  Candidate counts and
part pack lengths pad to pow-2 buckets (:func:`nnz_bucket`), so the
nodes of one bucket stack into one dispatch.

Exactness rides the sweep's certificate machinery unchanged:

- idempotent ⊕: absent tuples are the ⊕-identity, so the segment reduce
  over the candidates IS the dense reduce; the arg is the lowest own
  index among the minima, as the dense kernels break ties, and the host
  re-evaluates exact f64 values at the certified arg, so results are
  bit-identical to the dense sweep;
- mass ⊕ (logsumexp): absent tuples contribute ``exp(-inf) = 0``
  exactly; a lossy pack (``drop_tol > 0``) carries its truncated-mass
  bound in :attr:`SparseTable.trunc`, which the sweep folds into the
  error-bound ledger.

The per-segment reduces are deterministic and stay on the candidate
list: candidates are sorted by separator id, so each segment is one
run, and :func:`_segment_fold` folds every run into its first candidate
pairwise — the order ``ops/costs.py:fixed_order_sum`` gives a row
padded with the reduce's identity to ``L``, the pow-2 longest segment.
``minimum``/``maximum`` fold the idempotent ⊕ (NaN propagates wherever
it sits in the run), ``+`` the logsumexp sum (an atomic ``index_add_``
would sum in an order that changes from run to run).  Memory is
O(candidates) plus the ``[B, segments]`` outputs, which the dense
kernels return as well.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from pydcop_tpu_torch.ops.padding import as_table_dtype

#: canonical table format spellings — ``dense`` is the historical
#: stack, ``sparse`` the COO candidate-list path of this module
TABLE_FORMATS = ("dense", "sparse")

_TABLE_FORMAT_ALIASES = {
    "dense": "dense",
    "full": "dense",
    "sparse": "sparse",
    "coo": "sparse",
}


def as_table_format(
    spec: Union[str, None],
    default: str = "dense",
    allowed: Sequence[str] = TABLE_FORMATS,
) -> str:
    """Normalize a ``table_format`` argument to its canonical
    spelling — the sibling of ``ops/padding.py:as_table_dtype``, so
    cache keys and wire partition keys compare strings directly.
    Unknown names raise with a nearest-name suggestion."""
    if spec is None:
        return default
    if not isinstance(spec, str):
        raise ValueError(
            f"table format must be a string, got {spec!r}"
        )
    s = spec.strip().lower()
    if not s:
        return default
    canon = _TABLE_FORMAT_ALIASES.get(s)
    if canon is None or canon not in allowed:
        import difflib

        hint = difflib.get_close_matches(
            s, sorted(set(_TABLE_FORMAT_ALIASES)), n=1
        )
        suggest = (
            f"; did you mean {hint[0]!r}?"
            if hint and _TABLE_FORMAT_ALIASES[hint[0]] in allowed
            else ""
        )
        raise ValueError(
            f"unknown table format {spec!r} (expected one of "
            f"{tuple(allowed)}{suggest})"
        )
    return canon


#: a table qualifies for packing when its non-identity fraction is at
#: most this — below it the index overhead beats the dense cells
SPARSE_MAX_DENSITY = 0.5

#: tables smaller than this never pack: the candidate machinery's
#: fixed cost dwarfs any saving on a few hundred cells
SPARSE_MIN_CELLS = 256

#: per-candidate index overhead the byte budgets charge: sep_id +
#: own_id i32 pairs plus one i32 gather index (``ops/membound.py``
#: adds the per-part value bytes via ``table_dtype_bytes``)
SPARSE_INDEX_BYTES = 12

#: a node falls back to the dense kernels when its candidate list
#: would exceed this fraction of the dense box — past it the gather
#: indices outweigh the cells they skip
SPARSE_MAX_CAND_FRAC = 0.5

#: absolute candidate-list cap per node (i32 buffers; the membound
#: budget governs the real sizing — this is a host-RAM backstop)
SPARSE_MAX_CAND = 1 << 24


def nnz_bucket(n: int) -> int:
    """Pow-2 lattice (floor 8) for candidate counts and pack lengths
    — the static-shape discipline that keeps one compiled executable
    per bucket instead of one per distinct nnz."""
    b = 8
    n = max(int(n), 1)
    while b < n:
        b <<= 1
    return b


class SparseTable:
    """A COO-packed table: sorted flat row-major indices of the
    non-``fill`` cells plus their values; every absent cell IS
    ``fill`` (the consuming ⊕'s identity — ``+inf`` for min-domain
    energies, ``-inf`` for log-weights).

    Quacks like the array the sweeps already pass around —
    ``shape``/``ndim``/``size`` are the DENSE geometry (so cell
    accounting and level keys stay comparable across formats) and
    ``np.asarray`` densifies transparently, so every host fallback
    path stays correct without a special case.  ``nbytes`` is the
    PACKED payload — what the byte budgets charge."""

    __slots__ = ("shape", "flat", "vals", "fill", "trunc")

    def __init__(
        self,
        shape: Tuple[int, ...],
        flat: np.ndarray,
        vals: np.ndarray,
        fill: float,
        trunc: float = 0.0,
    ):
        self.shape = tuple(int(s) for s in shape)
        self.flat = np.ascontiguousarray(flat, dtype=np.int64)
        self.vals = np.ascontiguousarray(vals, dtype=np.float64)
        self.flat.setflags(write=False)
        self.vals.setflags(write=False)
        self.fill = float(fill)
        #: truncated-mass bound (nats) of a lossy pack — 0.0 for an
        #: exact pack; the mass-⊕ ledger folds it in per use
        self.trunc = float(trunc)

    # -- array-protocol geometry -----------------------------------------

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def nnz(self) -> int:
        return int(self.flat.size)

    @property
    def density(self) -> float:
        return self.nnz / max(self.size, 1)

    @property
    def nbytes(self) -> int:
        """PACKED bytes (indices + values) — the budget unit."""
        return int(self.flat.nbytes + self.vals.nbytes)

    def __array__(self, dtype=None, copy=None):
        d = self.todense()
        return d if dtype is None else d.astype(dtype)

    def todense(self) -> np.ndarray:
        out = np.full(self.size, self.fill, dtype=np.float64)
        out[self.flat] = self.vals
        return out.reshape(self.shape)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"SparseTable(shape={self.shape}, nnz={self.nnz}, "
            f"fill={self.fill}, trunc={self.trunc})"
        )

    # -- exact host gathers ----------------------------------------------

    def finite_amax(self) -> float:
        """Largest |finite| packed value (0.0 when none) — the
        sparse fast path of ``ops/semiring.py:_finite_amax`` (the
        fill is an exact identity, never a rounding scale)."""
        v = self.vals[np.isfinite(self.vals)]
        return float(np.max(np.abs(v))) if v.size else 0.0

    def lookup(self, flat_idx: np.ndarray) -> np.ndarray:
        """Exact f64 values at flat row-major indices (vectorized
        searchsorted; misses return ``fill``)."""
        fi = np.asarray(flat_idx, dtype=np.int64)
        pos = np.searchsorted(self.flat, fi)
        pos_c = np.minimum(pos, max(self.flat.size - 1, 0))
        hit = (
            (self.flat[pos_c] == fi)
            if self.flat.size
            else np.zeros(fi.shape, dtype=bool)
        )
        out = np.full(fi.shape, self.fill, dtype=np.float64)
        if self.flat.size:
            out[hit] = self.vals[pos_c[hit]]
        return out

    def gather(self, idx: Tuple[Any, ...]) -> np.ndarray:
        """Fancy-index gather (arrays/ints, broadcasting like numpy
        advanced indexing) — what the exact-f64 host glue calls in
        place of ``np.asarray(table)[idx]``."""
        arrs = np.broadcast_arrays(
            *[np.asarray(i, dtype=np.int64) for i in idx]
        )
        flat = np.zeros(arrs[0].shape, dtype=np.int64)
        stride = 1
        for ax in range(self.ndim - 1, -1, -1):
            flat += arrs[ax] * stride
            stride *= self.shape[ax]
        return self.lookup(flat)

    def contains(self, flat_idx: np.ndarray) -> np.ndarray:
        fi = np.asarray(flat_idx, dtype=np.int64)
        if not self.flat.size:
            return np.zeros(fi.shape, dtype=bool)
        pos = np.minimum(
            np.searchsorted(self.flat, fi), self.flat.size - 1
        )
        return self.flat[pos] == fi

    def positions(self, flat_idx: np.ndarray) -> np.ndarray:
        """Pack positions of flat indices KNOWN to be present — the
        per-part gather indices the device kernel consumes."""
        return np.searchsorted(self.flat, flat_idx).astype(np.int64)


def pack_table(
    table: np.ndarray,
    fill: float,
    *,
    max_density: float = SPARSE_MAX_DENSITY,
    min_cells: int = SPARSE_MIN_CELLS,
    drop_tol: float = 0.0,
) -> Optional[SparseTable]:
    """COO-pack a dense table whose cells default to ``fill``, or
    None when packing would not pay (too small, or too dense).

    ``drop_tol`` (mass ⊕ only, ``fill = -inf``): additionally drop
    near-identity log-weight cells whose TOTAL mass is at most
    ``drop_tol`` of the table's peak-mass bound; the dropped mass is
    bounded in :attr:`SparseTable.trunc` (nats) and the sweeps fold
    it into the error-bound ledger — the value answer stays within
    the reported bound, never silently truncated."""
    a = np.asarray(table, dtype=np.float64)
    if a.size < min_cells:
        return None
    flat = a.reshape(-1)
    if np.isnan(fill):  # pragma: no cover - identities are ±inf/0
        keep = ~np.isnan(flat)
    else:
        keep = flat != fill
    trunc = 0.0
    if drop_tol > 0.0 and np.isneginf(fill):
        finite = np.isfinite(flat)
        if finite.any():
            vmax = float(np.max(flat[finite]))
            # cells below this threshold sum to <= drop_tol·e^vmax
            # <= drop_tol × the table's own mass: a relative mass
            # truncation of at most drop_tol, i.e. a log-value error
            # bounded by -log(1 - drop_tol)
            thr = vmax + np.log(drop_tol / max(a.size, 1))
            dropped = keep & (flat <= thr)
            if dropped.any():
                keep = keep & ~dropped
                trunc = -np.log1p(-min(drop_tol, 0.5))
    nnz = int(keep.sum())
    if nnz > max_density * a.size:
        return None
    idx = np.flatnonzero(keep).astype(np.int64)
    return SparseTable(a.shape, idx, flat[idx], fill, trunc)


# -- candidate-list node prep -------------------------------------------


class SparsePrep:
    """Host-side candidate-list join of one contraction node: the
    kernel ABI buffers plus the static bucket geometry."""

    __slots__ = (
        "sep_ids", "own_ids", "gidx", "part_flats", "n_cand",
        "n_seg", "d_own", "n_cand_b", "n_seg_b", "part_lens_b",
        "trunc",
    )

    def __init__(
        self, sep_ids, own_ids, gidx, part_flats, n_seg, d_own,
        trunc,
    ):
        self.sep_ids = sep_ids
        self.own_ids = own_ids
        self.gidx = gidx  # one i64[n_cand] per part
        self.part_flats = part_flats  # one f64[len_p] per part
        self.n_cand = int(sep_ids.size)
        self.n_seg = int(n_seg)
        self.d_own = int(d_own)
        self.n_cand_b = nnz_bucket(self.n_cand)
        self.n_seg_b = nnz_bucket(self.n_seg)
        self.part_lens_b = tuple(
            nnz_bucket(f.size) for f in part_flats
        )
        self.trunc = float(trunc)

    @property
    def key(self) -> tuple:
        """The static geometry that joins the level-pack bucket key:
        two nodes with equal keys ride one stacked dispatch."""
        return (self.n_cand_b, self.n_seg_b, self.part_lens_b)

    @property
    def table_bytes(self) -> int:
        """Real per-row device allocation: candidate index buffers
        plus the packed part values (the number ``max_util_bytes``
        sizes against)."""
        return self.n_cand_b * (
            8 + 4 * len(self.part_flats)
        ) + 8 * sum(self.part_lens_b)


def sparse_node_prep(
    parts: Sequence[Tuple[List[str], Any]],
    target: Sequence[str],
    shape: Sequence[int],
    identity: float,
) -> Optional[SparsePrep]:
    """Build the candidate-list join for one node, or None when no
    part is sparse or the intersection would not pay (the caller
    falls back to the dense kernels — ``semiring.sparse_fallbacks``).

    Candidates are the intersection of the sparse parts' supports
    lifted to the target grid: a joined tuple can be non-identity
    only where EVERY sparse part is feasible, so the list covers
    exactly the potentially-finite cells and absent cells are the
    ⊕-identity — the exactness argument of the module docstring.
    Each candidate carries ``(sep_id, own_id)`` plus one gather
    index per part (dense parts index their own flat box; sparse
    parts index their packed values), computed here in vectorized
    numpy so the kernel is pure gather + segment-reduce."""
    shape = tuple(int(s) for s in shape)
    target = list(target)
    nd = len(target)
    size = 1
    for s in shape:
        size *= s
    sparse_parts = [
        (i, dims, t)
        for i, (dims, t) in enumerate(parts)
        if isinstance(t, SparseTable)
    ]
    if not sparse_parts:
        return None

    # seed: the sparse part whose lifted support is smallest — its
    # nnz times the free extent of the target dims it does not cover
    def lifted(entry):
        _, dims, t = entry
        free = 1
        for d, s in zip(target, shape):
            if d not in dims:
                free *= s
        return t.nnz * free

    seed_i, seed_dims, seed_t = min(sparse_parts, key=lifted)
    est = lifted((seed_i, seed_dims, seed_t))
    if est > SPARSE_MAX_CAND_FRAC * size or est > SPARSE_MAX_CAND:
        return None

    # per-target-dim candidate coordinates, built from the seed's
    # unraveled support crossed with the uncovered dims
    coords: Dict[str, np.ndarray] = {}
    seed_coords = np.unravel_index(
        seed_t.flat, seed_t.shape
    )
    for d, c in zip(seed_dims, seed_coords):
        coords[d] = c.astype(np.int64)
    n = seed_t.nnz
    for d, s in zip(target, shape):
        if d in coords:
            continue
        for k in coords:
            coords[k] = np.repeat(coords[k], s)
        coords[d] = np.tile(np.arange(s, dtype=np.int64), n)
        n *= s

    # filter through every other sparse part's support
    for i, dims, t in sparse_parts:
        if i == seed_i:
            continue
        pflat = np.zeros(n, dtype=np.int64)
        stride = 1
        for ax in range(len(dims) - 1, -1, -1):
            pflat += coords[dims[ax]] * stride
            stride *= t.shape[ax]
        hit = t.contains(pflat)
        if not hit.all():
            for k in coords:
                coords[k] = coords[k][hit]
            n = int(hit.sum())
    if n == 0:
        # a fully-infeasible node: one sentinel candidate at the
        # identity keeps the kernel ABI non-degenerate; the segment
        # reduce still reports every cell at the ⊕-identity
        for k in coords:
            coords[k] = np.zeros(1, dtype=np.int64)
        n = 1

    # sort by target flat id so per-segment candidate runs are
    # contiguous (indices_are_sorted on device, binary-search host
    # repair) — flat ids are unique by construction
    tflat = np.zeros(n, dtype=np.int64)
    stride = 1
    for ax in range(nd - 1, -1, -1):
        tflat += coords[target[ax]] * stride
        stride *= shape[ax]
    order = np.argsort(tflat, kind="stable")
    for k in coords:
        coords[k] = coords[k][order]

    d_own = shape[-1]
    own_ids = coords[target[-1]].astype(np.int64)
    sep_ids = (tflat[order] // d_own).astype(np.int64)
    n_seg = size // max(d_own, 1)

    gidx: List[np.ndarray] = []
    part_flats: List[np.ndarray] = []
    trunc = 0.0
    for i, (dims, t) in enumerate(parts):
        pflat = np.zeros(n, dtype=np.int64)
        stride = 1
        pshape = (
            t.shape
            if isinstance(t, SparseTable)
            else np.asarray(t).shape
        )
        for ax in range(len(dims) - 1, -1, -1):
            pflat += coords[dims[ax]] * stride
            stride *= pshape[ax]
        if isinstance(t, SparseTable):
            # every candidate hits by construction (the intersection
            # above filtered through this part's support) — except a
            # degenerate all-infeasible node's sentinel, which the
            # clamp below maps to SOME packed value; its join value
            # is irrelevant (every output cell is the identity)
            pos = np.minimum(
                t.positions(pflat), max(t.nnz - 1, 0)
            )
            gidx.append(pos)
            part_flats.append(t.vals)
            trunc += t.trunc
        else:
            gidx.append(pflat)
            part_flats.append(
                np.asarray(t, dtype=np.float64).reshape(-1)
            )
    return SparsePrep(
        sep_ids, own_ids, tuple(gidx), tuple(part_flats),
        n_seg, d_own, trunc,
    )


# -- the gather/segment-reduce kernels ----------------------------------


def storage_dtype(table_dtype: str) -> torch.dtype:
    """The torch STORAGE dtype of packed part values at a canonical
    table dtype (the port of ``np_table_format_dtype``: numpy has no
    bf16, so the port packs and ships bf16 through torch)."""
    return {
        "f32": torch.float32,
        "bf16": torch.bfloat16,
        "int8": torch.int8,
    }[as_table_dtype(table_dtype)]


#: the arg-reduce's empty-segment sentinel (any own id is below it)
_SENT = 1 << 30


def _fold_pairs(rank, L):
    """The pairs :func:`_segment_fold` joins at each half-width ``h = L/2,
    L/4, ..., 1``: ``(h, mask)``, ``mask[:, p]`` true where the candidate
    at ``p`` has rank below ``h`` and the one at ``p + h`` lies in its
    segment (ranks climb by one along a segment, so ``rank[p + h] ==
    rank[p] + h`` holds only there)."""
    pairs = []
    h = L // 2
    while h >= 1:
        if h < rank.shape[-1]:
            lo, hi = rank[:, :-h], rank[:, h:]
            pairs.append((h, (lo < h) & (hi == lo + h)))
        h //= 2
    return pairs


def _fold_heads(sep, S1):
    """Where :func:`_segment_fold` writes each candidate: the first
    candidate of a segment to its segment's column, every other one to
    the spare column ``S1`` (sliced off)."""
    first = torch.cat(
        [torch.ones_like(sep[:, :1], dtype=torch.bool),
         sep[:, 1:] != sep[:, :-1]], dim=1,
    )
    return torch.where(first, sep, S1)


def _segment_fold(vals, pairs, op, heads, S1, fill):
    """``[B, S1]``: each segment's candidates of ``vals [B, n]`` folded by
    ``op`` into one value, ``fill`` for a segment with no candidate.  The
    fold is pairwise in place along the sorted candidates (``pairs`` from
    :func:`_fold_pairs`): the first candidate of each segment ends up
    holding ``op`` over the run in ``fixed_order_sum``'s order, as if the
    run were padded with ``fill`` (the identity of ``op``) to ``L``.  No
    atomics, so every device gives the same bits.  ``heads`` is
    :func:`_fold_heads` of the separator ids."""
    x = vals.clone()
    for h, m in pairs:
        x[:, :-h] = torch.where(m, op(x[:, :-h], x[:, h:]), x[:, :-h])
    out = x.new_full((x.shape[0], S1 + 1), fill)
    out.scatter_(1, heads, x)
    return out[:, :S1]


def sparse_contraction_kernel(
    sr,
    n_cand_b: int,
    n_seg_b: int,
    part_lens_b: Tuple[int, ...],
    bnb: bool = False,
    table_dtype: str = "f32",
):
    """The sparse contraction for one candidate bucket: per-part value
    gathers summed into an f32 accumulator (in part order, starting
    from the first part), then a segment-⊕ over the sorted separator
    ids — always batched over a leading stack axis, as the level packs
    are.  The work runs on the device the arguments are on.

    Arguments per row, after int8's ``scales``/``offsets`` f32 ``[B,
    P]`` dequant params: ``sep_ids i32[B, n_cand_b]`` (ghost candidates
    carry ``n_seg_b``, an extra segment the caller slices off),
    ``own_ids i32[B, n_cand_b]``, then the ``P`` packed value vectors
    ``[B, len_p]`` at the storage dtype and the ``P`` gather indices
    ``i32[B, n_cand_b]``.

    Outputs match :func:`~pydcop_tpu_torch.ops.semiring.
    contraction_kernel`: idempotent ⊕ returns ``(arg, margins)`` over
    ``[B, n_seg_b + 1]`` segments (the arg is the lowest own index among
    the minima; a segment with no candidate reports the ⊕-identity with
    ``arg = 0`` and a NaN margin, as an all-identity dense row does),
    mass ⊕ returns ``(values,)``.  Structured cells (kbest,
    expectation) raise ``ValueError``.

    ``bnb=True`` takes a ``[B]`` f32 budget FIRST (before int8's
    dequant params) and prunes as the dense two-pass kernel does: the
    segment reduce is the row's pass-1 bound, min keeps ``~(u >
    budget)`` and max and the mass kinds ``~(u < budget)`` (negated, so
    NaN is kept); the pruned rows' outputs are masked to the
    ⊕-identity (``+inf`` margins) and the keep mask is appended, plus,
    for the mass kinds, the logsumexp of the pruned rows' values with
    the ghost segment sliced off.
    """
    from pydcop_tpu_torch.ops.semiring import (
        _discard,
        dequantize_int8,
        get_semiring,
    )

    sr = get_semiring(sr)
    dt = as_table_dtype(table_dtype)
    if sr.kind in ("kbest", "expectation"):
        raise ValueError(
            f"sparse contraction supports scalar ⊕ only, not "
            f"{sr.name!r} (structured cells keep the dense kernels)"
        )
    P = len(part_lens_b)
    n_cand_b = int(n_cand_b)
    S1 = int(n_seg_b) + 1  # + the ghost segment of padded candidates
    lo = sr.idempotent and not sr.maximize
    ident = float(sr.plus_identity)
    store = storage_dtype(dt)

    def contract(*args: torch.Tensor):
        if bnb:
            budget, *args = args
            budget = budget.unsqueeze(-1)  # [B, 1] over the segments
        if dt == "int8":
            scales, offsets, sep, own, *tg = args
        else:
            sep, own, *tg = args
        tabs, gidxs = list(tg[:P]), tg[P:]
        if len(gidxs) != P:
            raise ValueError(f"expected {P} parts and {P} gather indices")
        n_rows = sep.shape[0]
        if tuple(sep.shape) != (n_rows, n_cand_b) or tuple(
            own.shape
        ) != (n_rows, n_cand_b):
            raise ValueError(
                f"candidate ids {tuple(sep.shape)}: expected "
                f"({n_rows}, {n_cand_b})"
            )
        for t, L_p in zip(tabs, part_lens_b):
            if tuple(t.shape) != (n_rows, L_p) or t.dtype != store:
                raise ValueError(
                    f"packed part {tuple(t.shape)} {t.dtype}: expected "
                    f"({n_rows}, {L_p}) {store}"
                )
        if dt == "int8":
            tabs = [
                dequantize_int8(q, scales[:, i], offsets[:, i])
                for i, q in enumerate(tabs)
            ]
        elif dt == "bf16":
            tabs = [t.float() for t in tabs]
        v = None
        for t, g in zip(tabs, gidxs):
            gi = g.long().clamp(0, t.shape[-1] - 1)  # jnp.take's clip
            x = torch.gather(t, 1, gi)
            v = x if v is None else v + x
        sep = sep.long()  # gather/scatter indices; own ids stay i32
        # rank of each candidate inside its (contiguous) segment; the
        # fold's width is the pow-2 longest REAL segment
        rank = torch.arange(n_cand_b, device=sep.device) - (
            torch.searchsorted(sep, sep)
        )
        longest = int(
            torch.where(sep < S1 - 1, rank, 0).max().item()
        ) + 1
        pairs = _fold_pairs(rank, 1 << (longest - 1).bit_length())
        heads = _fold_heads(sep, S1)

        def seg(vals, op, fill):
            return _segment_fold(vals, pairs, op, heads, S1, fill)

        if sr.idempotent:
            op = torch.maximum if sr.maximize else torch.minimum
            u = seg(v, op, ident)
            best = v == torch.gather(u, 1, sep)
            ownm = torch.where(best, own, _SENT)
            arg_s = seg(ownm, torch.minimum, _SENT)
            arg = torch.where(arg_s >= _SENT, 0, arg_s)
            # margins against the NEXT cell: mask the one candidate at
            # (sep, arg); absent cells are the identity
            excl = own == torch.gather(arg_s, 1, sep)
            v2 = torch.where(excl, ident, v)
            second = seg(v2, op, ident)
            margins = second - u if lo else u - second
            if not bnb:
                return arg, margins
            # the segment reduce IS the row's ⊕-extremum: pass 1 is free
            keep = ~(u > budget) if lo else ~(u < budget)
            return arg, torch.where(keep, margins, float("inf")), keep
        m = seg(v, torch.maximum, float("-inf"))
        safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        e = torch.where(
            torch.isfinite(v),
            torch.exp(v - torch.gather(safe, 1, sep)),
            torch.zeros_like(v),
        )
        # +inf log-weights (hard -inf energies) stay absorbing, as the
        # dense kernel's isfinite(m) guard keeps them
        e = torch.where(torch.isposinf(v), float("inf"), e)
        s = seg(e, torch.add, 0.0)
        u = torch.where(torch.isfinite(m), safe + torch.log(s), m)
        if not bnb:
            return (u,)
        keep = ~(u < budget)
        # the ghost segment (-inf, never above a budget) stays out of
        # the measured discard
        return (
            torch.where(keep, u, float("-inf")), keep,
            _discard(u[:, :-1], keep[:, :-1], True),
        )

    return contract
