"""Deterministic keyed-jitter backoff (port of the keyed half of
``pydcop_tpu/utils/backoff.py``): the supervised device dispatch's retry
sleeps and the service client's reconnect loop
(:func:`call_with_backoff`).

The jitter of attempt ``k`` is a pure blake2b hash of ``(seed, key,
k)`` — the determinism contract of
:class:`~pydcop_tpu_torch.faults.plan.FaultPlan` decisions: no shared
random stream, so a chaos replay reproduces every retry's sleep bit for
bit whatever else runs beside it.
"""

from __future__ import annotations

import hashlib
import time
from typing import Callable, Iterator, Optional, TypeVar

T = TypeVar("T")


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


#: the service client's reconnect schedule: 50 ms doubling to 1 s,
#: each sleep stretched by up to 25%, retried on transport failures
#: (``OSError``) and torn or malformed frames (``ValueError``)
RETRY_BASE = 0.05
RETRY_FACTOR = 2.0
RETRY_MAX_DELAY = 1.0
RETRY_JITTER = 0.25
RETRY_EXCEPTIONS = (OSError, ValueError)


def call_with_backoff(
    fn: Callable[[], T],
    retry_for: float,
    *,
    key: str,
    seed: Optional[int] = None,
    giving_up: Optional[Callable[[], bool]] = None,
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
) -> T:
    """Call ``fn`` until it succeeds or ``retry_for`` seconds elapse,
    sleeping the keyed schedule of the ``RETRY_*`` constants between
    attempts.

    The LAST failure is re-raised once the deadline passes.
    ``giving_up`` is polled before each sleep: a closing transport
    aborts the loop early by returning True.  Sleeps never overshoot
    the deadline (the final attempt happens AT it).  ``on_retry(attempt,
    error)`` fires once per retry, before the sleep — the seam the
    service client counts ``service.client_retries`` through.
    """
    deadline = time.monotonic() + retry_for
    for attempt, delay in enumerate(
        backoff_delays(
            key, base=RETRY_BASE, factor=RETRY_FACTOR,
            max_delay=RETRY_MAX_DELAY, jitter=RETRY_JITTER, seed=seed,
        ),
        start=1,
    ):
        try:
            return fn()
        except RETRY_EXCEPTIONS as e:
            remaining = deadline - time.monotonic()
            if remaining <= 0 or (giving_up is not None and giving_up()):
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            time.sleep(min(delay, remaining))
    raise AssertionError("unreachable")  # pragma: no cover
