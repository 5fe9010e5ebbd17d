"""Misc small helpers (reference: ``pydcop/utils/various.py``); a copy of
``pydcop_tpu/utils/various.py``."""

from __future__ import annotations

import inspect
from typing import Callable, List


def func_args(f: Callable) -> List[str]:
    """Positional/keyword argument names of a callable (the reference
    uses this to discover a cost function's variables)."""
    return [
        p.name
        for p in inspect.signature(f).parameters.values()
        if p.kind
        in (
            inspect.Parameter.POSITIONAL_OR_KEYWORD,
            inspect.Parameter.KEYWORD_ONLY,
            inspect.Parameter.POSITIONAL_ONLY,
        )
    ]


def number_format(n, precision: int = 3) -> str:
    """Compact human formatting: ints stay ints, floats are rounded,
    large magnitudes get engineering suffixes (1.5k, 2.3M)."""
    if isinstance(n, bool) or n is None:
        return str(n)
    try:
        x = float(n)
    except (TypeError, ValueError):
        return str(n)
    if x != x:  # nan
        return "nan"
    for suffix, scale in (("G", 1e9), ("M", 1e6), ("k", 1e3)):
        if abs(x) >= scale:
            return f"{x / scale:.{precision}g}{suffix}"
    if x == int(x):
        return str(int(x))
    return f"{x:.{precision}g}"


def elapsed_str(seconds: float) -> str:
    """``1h 02m 03s`` style duration formatting for logs/metrics.

    Sub-second durations render as milliseconds (``123ms``) — the old
    seconds form printed telemetry-scale spans as ``0h 00m 00s``-style
    noise.  Negative durations raise: a caller holding one has a clock
    bug (mixed epochs, reversed subtraction) that silent clamping to
    ``0ms`` would bury.
    """
    seconds = float(seconds)
    if seconds < 0:
        raise ValueError(
            f"elapsed_str: negative duration {seconds!r} (mixed clock "
            "epochs or a reversed subtraction?)"
        )
    if seconds < 1.0:
        ms = round(seconds * 1000)
        if ms < 1000:  # 0.9996 rounds to 1000ms — report as seconds
            return f"{ms}ms"
    h, rem = divmod(int(seconds), 3600)
    m, s = divmod(rem, 60)
    if h:
        return f"{h}h {m:02d}m {s:02d}s"
    if m:
        return f"{m}m {s:02d}s"
    return f"{seconds:.3g}s"
