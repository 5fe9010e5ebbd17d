"""Deterministic keyed-jitter backoff (port of the part of
``pydcop_tpu/utils/backoff.py`` that the supervised device dispatch
uses).

The jitter of attempt ``k`` is a pure blake2b hash of ``(seed, key,
k)`` — the determinism contract of
:class:`~pydcop_tpu_torch.faults.plan.FaultPlan` decisions: no shared
random stream, so a chaos replay reproduces every retry's sleep bit for
bit whatever else runs beside it.
"""

from __future__ import annotations

import hashlib
from typing import Iterator, Optional


def _hashed_unit(seed: int, key: str, attempt: int) -> float:
    """Uniform [0, 1) from a keyed hash — same construction as
    ``faults.plan._u``: the value depends on nothing but its
    arguments, so schedules replay exactly and distinct keys are
    decorrelated."""
    h = hashlib.blake2b(
        f"{seed}|{key}|{attempt}|backoff".encode(), digest_size=8
    ).digest()
    return int.from_bytes(h, "big") / 2.0**64


def backoff_delays(
    key: str,
    base: float = 0.1,
    factor: float = 2.0,
    max_delay: float = 5.0,
    jitter: float = 0.25,
    seed: Optional[int] = None,
) -> Iterator[float]:
    """Yield an infinite stream of sleep delays: ``base`` growing by
    ``factor`` up to ``max_delay``, each stretched by a jitter factor
    in ``[1, 1 + jitter]`` (full-jitter would allow 0-sleeps, which
    turn a retry loop into a busy spin against a dead peer).

    Attempt ``k``'s jitter is the pure hash of ``(seed or 0, key, k)``
    (module docstring): stateless and per-caller reproducible."""
    delay = base
    s = 0 if seed is None else seed
    attempt = 0
    while True:
        attempt += 1
        yield delay * (1.0 + jitter * _hashed_unit(s, key, attempt))
        delay = min(delay * factor, max_delay)
