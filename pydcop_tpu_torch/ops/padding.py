"""Pad policies, ghost padding, the table-dtype vocabulary and DPOP's
level-pack helpers (a copy of ``pydcop_tpu/ops/padding.py``).

A :class:`PadPolicy` quantizes every shape-bearing dimension of a
compiled problem (variable count, per-arity constraint count, adjacency
widths, flat-table length) up to powers of two above a floor, so that
similarly-sized problems compile to arrays of one shape and can be
stacked and solved together (``api.solve_many``).  Padding is invisible
in costs: ghost variables get a 1-value domain (``BIG`` unary cost on
every other value, built by :func:`ghost_unary`) and ghost constraints
carry all-zero tables scoped on ghost variables (:func:`ghost_scopes`).
The same policy buckets DPOP's UTIL level dispatches
(``bucket_util_shape``, ``util_level_key``, ``pad_util_parts``,
``stack_bucket``).

Spec strings: ``"none"``, ``"pow2"`` (floor 16) or ``"pow2:<floor>"``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Union

import numpy as np

# Cost assigned to padded (invalid) domain values; large enough to never
# be selected, small enough to leave f32 headroom when summed.
BIG = 1e9


@dataclasses.dataclass(frozen=True)
class PadPolicy:
    """Bucket quantization: ``kind`` ``"none"`` or ``"pow2"`` (powers
    of two clamped up to ``floor``).  ``deg_floor`` bounds the adjacency
    width buckets (``var_edges`` / ``neighbors`` columns) from below;
    ``flat_block`` is the cell multiple ``tables_flat`` is padded to."""

    kind: str = "none"  # "none" | "pow2"
    floor: int = 16
    deg_floor: int = 4
    flat_block: int = 1024

    @property
    def enabled(self) -> bool:
        return self.kind != "none"

    def bucket(self, n: int, floor: int | None = None) -> int:
        """Smallest power of two >= ``n``, clamped up to the floor."""
        if not self.enabled or n <= 0:
            return n
        b = 1
        while b < n:
            b <<= 1
        return max(b, floor if floor is not None else self.floor)

    def bucket_dim(self, n: int) -> int:
        """Bucket for adjacency widths (per-variable degree columns)."""
        return self.bucket(n, self.deg_floor)

    def bucket_cells(self, n: int) -> int:
        """Flat-table length rounded up to a ``flat_block`` multiple."""
        if not self.enabled or n <= 0:
            return n
        blk = self.flat_block
        return ((n + blk - 1) // blk) * blk


NO_PADDING = PadPolicy()


def ghost_unary(n_pad: int, d_max: int) -> np.ndarray:
    """f32[n_pad, d_max] unary rows of ghost variables: value 0 at zero
    cost, ``BIG`` on every other value."""
    rows = np.full((n_pad, d_max), BIG, dtype=np.float32)
    rows[:, 0] = 0.0
    return rows


def ghost_scopes(
    targets: Sequence[int], count: int, k: int, start: int = 0
) -> np.ndarray:
    """i32[count, k] ghost-constraint scopes: row q repeats
    ``targets[(start + q) % len(targets)]`` k times (self-scoped, so the
    neighbor pass's a != b test drops the pairs)."""
    tg = list(targets) or [0]
    return np.asarray(
        [[tg[(start + q) % len(tg)]] * k for q in range(count)],
        dtype=np.int32,
    ).reshape(count, k)


#: canonical table dtype spellings, cheapest storage last
TABLE_DTYPES = ("f32", "bf16", "int8")

_TABLE_DTYPE_ALIASES = {
    "f32": "f32",
    "fp32": "f32",
    "float32": "f32",
    "bf16": "bf16",
    "bfloat16": "bf16",
    "int8": "int8",
    "i8": "int8",
}

#: bytes per packed cell, per canonical dtype
_TABLE_DTYPE_BYTES = {"f32": 4, "bf16": 2, "int8": 1}

# unit roundoff of the STORAGE format: bf16 keeps 8 significand bits
# (eps = 2^-7); int8 codes are exact integers dequantized in f32, so
# its roundoff is f32's (its quantization error is a separate term).
_TABLE_DTYPE_EPS = {
    "f32": float(np.finfo(np.float32).eps),
    "bf16": 2.0 ** -7,
    "int8": float(np.finfo(np.float32).eps),
}


def as_table_dtype(
    spec: Union[str, None],
    default: str = "f32",
    allowed: Sequence[str] = TABLE_DTYPES,
) -> str:
    """Normalize a ``table_dtype`` / ``msg_dtype`` argument to its
    canonical spelling; unknown names raise with a nearest-name
    suggestion."""
    if spec is None:
        return default
    if not isinstance(spec, str):
        raise ValueError(
            f"table dtype must be a string, got {spec!r}"
        )
    s = spec.strip().lower()
    if not s:
        return default
    canon = _TABLE_DTYPE_ALIASES.get(s)
    if canon is None or canon not in allowed:
        import difflib

        hint = difflib.get_close_matches(
            s, sorted(set(_TABLE_DTYPE_ALIASES)), n=1
        )
        suggest = (
            f"; did you mean {hint[0]!r}?"
            if hint and _TABLE_DTYPE_ALIASES[hint[0]] in allowed
            else ""
        )
        raise ValueError(
            f"unknown table dtype {spec!r} (expected one of "
            f"{tuple(allowed)}{suggest})"
        )
    return canon


def table_dtype_eps(table_dtype: str) -> float:
    """Unit roundoff of a canonical table dtype's STORAGE format — what
    the f32 certificate swaps in for ``eps32`` when tables are packed
    below f32."""
    return _TABLE_DTYPE_EPS[as_table_dtype(table_dtype)]


def table_dtype_bytes(table_dtype: str) -> int:
    """Per-cell byte width of a canonical table dtype — the number
    the memory-bounded sweep's byte budget (``ops/membound.py``) sizes
    with."""
    return _TABLE_DTYPE_BYTES[as_table_dtype(table_dtype)]


# -- int8 table packs ---------------------------------------------------
#
# Affine 8-bit quantization with RESERVED infinity codes: hard-cap
# semantics (+/-inf guards, bnb noprune sentinels, pad-policy ghost
# masks) must survive packing EXACTLY, so the top/bottom codes encode
# the infinities and finite values clip to [-126, 126].  scale/offset
# ride alongside the codes (one pair per packed part) and the device
# kernel dequantizes into its f32 accumulator
# (``ops/semiring.py:contraction_kernel``).

INT8_POS_INF = 127  #: reserved code for +inf
INT8_NEG_INF = -128  #: reserved code for -inf
INT8_FINITE_MAX = 126  #: finite codes live in [-126, 126]
INT8_LEVELS = 2 * INT8_FINITE_MAX  #: finite quantization levels (252)


def quantize_table_int8(a: np.ndarray):
    """Pack a float table as ``(int8 codes, f32 scale, f32 offset)``.

    Finite values map affinely onto [-126, 126] —
    ``scale = (hi - lo) / 252`` (1.0 when the finite range is
    degenerate, where every finite cell dequantizes exactly to the
    offset) and ``offset = (hi + lo) / 2`` — and +/-inf take the
    reserved codes, so guards and hard caps round-trip bit-exactly.
    The quantization error of any finite cell is <= scale / 2
    <= max|finite| / 252 (:func:`int8_quant_bound`)."""
    a = np.asarray(a, dtype=np.float64)
    finite = np.isfinite(a)
    if finite.any():
        lo = float(a[finite].min())
        hi = float(a[finite].max())
    else:
        lo = hi = 0.0
    scale = (hi - lo) / INT8_LEVELS
    if not (scale > 0.0):
        scale = 1.0
    offset = (hi + lo) / 2.0
    with np.errstate(invalid="ignore"):
        q = np.clip(
            np.rint((a - offset) / scale),
            -INT8_FINITE_MAX,
            INT8_FINITE_MAX,
        )
    q = np.where(a == np.inf, INT8_POS_INF, q)
    q = np.where(a == -np.inf, INT8_NEG_INF, q)
    return (
        q.astype(np.int8),
        np.float32(scale),
        np.float32(offset),
    )


def dequantize_table_int8(
    q: np.ndarray, scale: float, offset: float
) -> np.ndarray:
    """Host-side (numpy) inverse of :func:`quantize_table_int8` — the
    reference the device kernel's in-trace dequant mirrors, shared by
    tests and host fallbacks."""
    q = np.asarray(q)
    f = q.astype(np.float32) * np.float32(scale) + np.float32(offset)
    f = np.where(q == INT8_POS_INF, np.float32(np.inf), f)
    f = np.where(q == INT8_NEG_INF, np.float32(-np.inf), f)
    return f.astype(np.float32)


def int8_quant_bound(parts_max: float) -> float:
    """Conservative per-joined-cell int8 quantization error bound.

    Each part's finite error is <= its ``scale/2 <= amax_p / 252``;
    a joined cell sums one value per part, and ``parts_max`` is the
    sweep's running sum of per-part finite amax values, so
    ``parts_max / 252`` bounds the total — pre-computable before any
    dispatch, which is what lets the tolerance gate and the bnb slack
    widen without touching device results."""
    return max(float(parts_max), 0.0) / INT8_LEVELS


# UTIL-table axes are DOMAIN-sized (a handful of values), not
# problem-sized: bucketing them against ``PadPolicy.floor`` (16) would
# inflate a d=5 axis 3x per dimension.  Level-pack keys therefore
# quantize axes against this much smaller floor — the bucket lattice
# for a d=5 domain is 5 -> 8, a ~1.6x per-axis pad that buys shape
# sharing across every level of the pseudo-tree instead of one bucket
# per exact shape.
UTIL_AXIS_FLOOR = 2


def bucket_util_shape(
    shape: Sequence[int], policy: PadPolicy
) -> tuple:
    """Quantize a UTIL joined-table shape axis-wise to the policy's
    pow-2 lattice (floor :data:`UTIL_AXIS_FLOOR`).  Identity under
    ``NO_PADDING``.  Size-1 axes STAY 1: they are conditioned or
    degenerate axes (singleton domains — ``memory_bound`` passes), and
    raising them to the floor would DOUBLE the table per conditioned
    axis for pure ghost compute."""
    if not policy.enabled:
        return tuple(shape)
    return tuple(
        s if s == 1 else policy.bucket(s, UTIL_AXIS_FLOOR)
        for s in shape
    )


def util_level_key(
    shape: Sequence[int],
    part_shapes: Sequence[Sequence[int]],
    policy: PadPolicy,
) -> tuple:
    """Level-pack bucket key for one contraction (a DPOP UTIL join or a
    semiring sweep node): the PADDED ``(joined shape, aligned part
    shapes)`` pair.

    Two nodes of one wave with equal keys execute as rows of ONE
    stacked contraction dispatch
    (``ops/semiring.py:contraction_kernel``).  Under ``NO_PADDING`` the
    key is the exact shapes; with a pow-2 policy, near-miss shapes land
    on the same lattice point so a wave needs far fewer dispatches.

    Part axes of size 1 are broadcast axes and stay 1; real axes pad
    to the joined shape's bucket.  When the policy is enabled the key
    appends the shape of the ghost-guard MASK part (a row over the own
    axis: 0 on real values, the semiring's ⊕-identity on padded ones)
    that :func:`pad_util_parts` adds so no arg-reduce can land in a
    ghost cell.

    A part with ONE MORE axis than the joined shape carries a
    structured-cell value axis (the kbest and expectation cells of
    ``ops/semiring.py``): its named axes bucket as usual and the
    trailing value axis is kept verbatim, never padded (the cell width
    belongs to the semiring, not to the problem size).
    """
    pshape = bucket_util_shape(shape, policy)
    nd = len(pshape)
    pparts = tuple(
        tuple(
            (
                s
                if (len(ps) == nd + 1 and i == len(ps) - 1)
                else (1 if s == 1 else pshape[i])
            )
            for i, s in enumerate(ps)
        )
        for ps in part_shapes
    )
    if policy.enabled:
        mask_shape = (1,) * (len(pshape) - 1) + (pshape[-1],)
        pparts = pparts + (mask_shape,)
    return (pshape, pparts)


def pad_util_parts(
    aligned: Sequence[np.ndarray],
    shape: Sequence[int],
    pshape: Sequence[int],
    guard: float = np.inf,
    with_mask: bool = True,
) -> list:
    """Zero-pad aligned f32 parts up to the level-pack bucket and
    append the own-axis ghost mask (0 on real values, ``guard`` on
    padded ones).

    Real cells compute BIT-IDENTICALLY to the unpadded join: zero pads
    only fill cells outside the real region (sliced away by the
    caller), and adding the mask's exact 0.0 to a finite f32 is exact,
    so the certificate's error bound is unchanged.  The guard defaults
    to ``+inf``, which keeps every min-argmin and second-best inside the
    real domain (DPOP); the semiring sweep passes ``-inf`` for max and
    logsumexp ⊕, where it is absorbing for ``max`` and contributes
    ``exp(-inf) = 0`` to a logsumexp.  ``with_mask=False`` skips the
    mask (a ``NO_PADDING`` bucket, whose key has no mask slot).  Parts
    carrying a trailing structured-cell value axis (one more axis than
    ``pshape``) pad their named axes only, as in
    :func:`util_level_key`."""
    out = []
    for a in aligned:
        if a.ndim == len(pshape) + 1:
            target = tuple(
                1 if s == 1 else pshape[i]
                for i, s in enumerate(a.shape[:-1])
            ) + (a.shape[-1],)
        else:
            target = tuple(
                1 if s == 1 else pshape[i] for i, s in enumerate(a.shape)
            )
        if target == a.shape:
            # f64 inputs cast here so every returned part is
            # kernel-ready f32 (callers pass exact f64 aligned parts)
            out.append(np.asarray(a, dtype=np.float32))
        else:  # zeros + slice-assign casts f64 -> f32 in the same pass
            b = np.zeros(target, dtype=np.float32)
            b[tuple(slice(0, s) for s in a.shape)] = a
            out.append(b)
    if with_mask:
        mask = np.zeros(
            (1,) * (len(pshape) - 1) + (pshape[-1],), dtype=np.float32
        )
        mask[..., shape[-1]:] = guard
        out.append(mask)
    return out


def stack_bucket(n: int) -> int:
    """Stack-height lattice for stacked level dispatches: pow-2 up to
    32, multiples of 32 above (the multiple-of-32 tail caps the ghost
    rows at one row block on large stacks)."""
    if n <= 32:
        b = 1
        while b < n:
            b <<= 1
        return b
    return -(-n // 32) * 32


def as_pad_policy(spec: Union[str, PadPolicy, None]) -> PadPolicy:
    """Normalize a ``pad_policy`` argument: a :class:`PadPolicy` passes
    through; ``None``/``"none"`` disable; ``"pow2"``/``"pow2:<floor>"``
    parse.  Raises ``ValueError`` on anything else."""
    if isinstance(spec, PadPolicy):
        return spec
    if spec is None:
        return NO_PADDING
    if not isinstance(spec, str):
        raise ValueError(
            f"pad_policy must be a string or PadPolicy, got {spec!r}"
        )
    s = spec.strip().lower()
    if s in ("", "none"):
        return NO_PADDING
    if s == "pow2":
        return PadPolicy(kind="pow2")
    if s.startswith("pow2:"):
        try:
            floor = int(s[len("pow2:"):])
        except ValueError:
            floor = -1
        if floor < 1:
            raise ValueError(
                f"pad_policy {spec!r}: floor must be a positive "
                "integer (e.g. 'pow2:64')"
            )
        return PadPolicy(kind="pow2", floor=floor)
    raise ValueError(
        f"unknown pad_policy {spec!r} (expected 'none', 'pow2' or "
        "'pow2:<floor>')"
    )
