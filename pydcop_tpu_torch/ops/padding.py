"""The padding constant and the table-dtype vocabulary of the compiler.

A reduced copy of ``pydcop_tpu/ops/padding.py``.  The port's compiler
supports ``pad_policy="none"`` only, so the shape-bucketing machinery
(``PadPolicy``, ghost variables and constraints) is not copied yet
(ROADMAP.md, 'pad_policy').
"""

from __future__ import annotations

from typing import Sequence, Union

# Cost assigned to padded (invalid) domain values; large enough to never
# be selected, small enough to leave f32 headroom when summed.
BIG = 1e9


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
