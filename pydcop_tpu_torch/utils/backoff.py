"""Shared retry/backoff helper (a copy of ``pydcop_tpu/utils/backoff.py``):
the host agent's control-plane connect, the TCP message-plane writer's
resend, the supervised device dispatch's retry sleeps and the service
client's reconnect loop all go through :func:`call_with_backoff` and
:func:`backoff_delays`.

Jitter is deterministic on demand, two ways:

- ``seed=`` alone draws the jitter stream from a private
  ``random.Random(seed)``: reproducible for a single caller, but two
  loops sharing one seed perturb each other's schedules the moment their
  draws interleave.
- ``key=`` (with an optional ``seed``) switches to the keyed hash: the
  jitter of attempt ``k`` is a pure blake2b hash of ``(seed, key, k)``,
  the determinism contract of
  :class:`~pydcop_tpu_torch.faults.plan.FaultPlan` decisions.  No shared
  stream: each loop passes its own key, so a chaos replay reproduces
  every loop's retry timing bit for bit whatever else runs beside it.
"""

from __future__ import annotations

import hashlib
import random
import time
from typing import Callable, Iterator, Optional, Tuple, Type, TypeVar

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
    base: float = 0.1,
    factor: float = 2.0,
    max_delay: float = 5.0,
    jitter: float = 0.25,
    seed: Optional[int] = None,
    key: Optional[str] = None,
) -> Iterator[float]:
    """Yield an infinite stream of sleep delays: ``base`` growing by
    ``factor`` up to ``max_delay``, each stretched by a jitter factor
    in ``[1, 1 + jitter]`` (full-jitter would allow 0-sleeps, which
    turn a retry loop into a busy spin against a dead peer).

    With ``key`` given, attempt ``k``'s jitter is the pure hash of
    ``(seed or 0, key, k)`` (module docstring); without it, jitter comes
    from a private ``random.Random(seed)`` stream."""
    delay = base
    if key is not None:
        s = 0 if seed is None else seed
        attempt = 0
        while True:
            attempt += 1
            yield delay * (1.0 + jitter * _hashed_unit(s, key, attempt))
            delay = min(delay * factor, max_delay)
    rnd = random.Random(seed)
    while True:
        yield delay * (1.0 + jitter * rnd.random())
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
    exceptions: Tuple[Type[BaseException], ...] = (OSError,),
    base: float = 0.1,
    factor: float = 2.0,
    max_delay: float = 5.0,
    jitter: float = 0.25,
    seed: Optional[int] = None,
    key: Optional[str] = None,
    clock: Callable[[], float] = time.monotonic,
    sleep: Callable[[float], None] = time.sleep,
    giving_up: Optional[Callable[[], bool]] = None,
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
) -> T:
    """Call ``fn`` until it succeeds or ``retry_for`` seconds elapse.

    The LAST failure is re-raised once the deadline passes.
    ``giving_up`` is polled before each sleep: a closing transport
    aborts the loop early by returning True.  Sleeps never overshoot
    the deadline (the final attempt happens AT it).  ``key`` selects
    the keyed deterministic jitter (module docstring).
    ``on_retry(attempt, error)`` fires once per retry, before the
    sleep — the seam the service client counts
    ``service.client_retries`` through.
    """
    deadline = clock() + retry_for
    for attempt, delay in enumerate(
        backoff_delays(
            base=base, factor=factor, max_delay=max_delay,
            jitter=jitter, seed=seed, key=key,
        ),
        start=1,
    ):
        try:
            return fn()
        except exceptions as e:
            remaining = deadline - clock()
            if remaining <= 0 or (giving_up is not None and giving_up()):
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            sleep(min(delay, remaining))
    raise AssertionError("unreachable")  # pragma: no cover
