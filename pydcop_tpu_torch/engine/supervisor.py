"""Supervised device dispatch (port of ``pydcop_tpu/engine/supervisor.py``):
the failure-classification and recovery seam every device dispatch of
the port goes through.

One :class:`Supervisor` wraps each dispatch of the batched engine's
chunks (``engine/batched.py:run_batched``, scope ``engine.chunk``), of a
``solve_many`` group (``run_many_batched``, ``engine.group``), of DPOP's
level stacks and nodes (``dpop.level``, ``dpop.node``) and of the
contraction sweeps (``semiring.level``, ``semiring.node``), and

- **classifies failures** (:func:`classify_failure`): a transient
  failure retries in place with the keyed deterministic backoff
  (``utils/backoff.py``) under a per-call ``retry_budget``; a device OOM
  (``torch.cuda.OutOfMemoryError``, or an XLA-style
  ``RESOURCE_EXHAUSTED`` text) surfaces as :class:`DeviceOOMError` so
  the caller degrades — ``run_batched`` halves its chunk down to
  ``chunk_floor``, ``run_many_batched`` splits the instance group, DPOP
  and the sweeps go from a level stack to one dispatch per node and from
  a node to the exact host f64 join, the memory-bounded planner re-plans
  at half its budget; everything else is fatal and re-raises unwrapped
  (the batched engine writes a final checkpoint first when one is
  configured).  The CUDA errors that leave the context unusable (an
  illegal memory access, an unspecified launch failure, a device-side
  assert, a misaligned address) are fatal and never retried: a retry on
  a poisoned context fails again and hides the first error;
- **hosts the injection seam** of the seeded device-layer fault kinds
  (``device_oom``, ``device_transient``, ``nan_inject`` —
  :class:`~pydcop_tpu_torch.faults.plan.DeviceFaults`): injected faults
  fire BEFORE the wrapped call, deterministically in ``(plan seed,
  scope, sequence number)``, so the recovery paths above can be driven
  on demand and count what the JAX package counts;
- **screens numeric faults**: the engines hand each chunk boundary's
  cost samples (already on the host) to a NaN screen, with
  :meth:`Supervisor.nan_lanes` the ``nan_inject`` seam.  A poisoned
  instance is quarantined (``on_numeric_fault='quarantine'``:
  ``status="degraded"`` with its last finite anytime best, the other
  instances of its group untouched) or fails the call (``'raise'``).
  Only NaN is poison: ``±inf`` is a legitimate hard-constraint cost.

CUDA reports a kernel's failure at the next synchronisation, so every
closure handed to :meth:`Supervisor.dispatch` ends with its own host
copy (the chunk's cost samples, a contraction's outputs): the failure is
classified inside the dispatch, not at some later line.

Telemetry: counters ``engine.retries``, ``engine.oom_splits``,
``engine.oom_chunk_halvings``, ``engine.quarantined_instances``,
``engine.numeric_faults`` and ``fault.device_oom`` /
``fault.device_transient`` / ``fault.nan_inject`` per injected fault;
``supervisor``-category events for every recovery action (``retry``,
``retry-exhausted``, ``fatal``, ``oom-halve``, ``oom-split``,
``group-restart``, ``quarantine``) and ``fault``-category events per
injection, all in ``result["telemetry"]``.

The active supervisor is ambient (:func:`get_supervisor` /
:func:`supervision`), like the telemetry session: ``api.solve``,
``solve_many``, ``infer`` and ``infer_many`` install one per call from
their ``retry_budget``, ``chunk_floor``, ``on_numeric_fault`` and
``chaos`` knobs.  With none installed, a process-default one (retries
on, no injection) supervises every dispatch.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch

from pydcop_tpu_torch.telemetry import get_metrics, get_tracer
from pydcop_tpu_torch.utils.backoff import backoff_delays


class DeviceOOMError(RuntimeError):
    """A device dispatch exhausted device memory (a real
    ``torch.cuda.OutOfMemoryError`` or an injected ``device_oom``).
    Engines catch this and degrade instead of failing the call.

    ``injected`` tells the chaos plan's capacity model (fired BEFORE the
    wrapped call) from a real allocation failure (raised inside it)."""

    def __init__(self, message: str, *, injected: bool = False):
        super().__init__(message)
        self.injected = injected


class DeviceTransientError(RuntimeError):
    """A transient device failure: injected (``device_transient``), or a
    real one handed back by a ``retryable=False`` dispatch."""


class UnrecoverableDeviceError(RuntimeError):
    """A supervised dispatch that could not be saved: the transient
    retry budget is exhausted, the OOM ladder bottomed out (chunk at the
    floor, a single-instance group still over capacity), or an instance
    went NaN under ``on_numeric_fault='raise'``.  ``kind`` is
    ``'transient'``, ``'oom'``, ``'numeric'`` or ``'fatal'``."""

    def __init__(
        self,
        message: str,
        *,
        scope: Optional[str] = None,
        kind: str = "fatal",
        attempts: int = 0,
    ):
        super().__init__(message)
        self.scope = scope
        self.kind = kind
        self.attempts = attempts


# Status-code / message markers, the JAX package's.  OOM is checked
# first: an allocation failure can carry INTERNAL-looking text too, and
# retrying an OOM verbatim is pointless.
_OOM_MARKERS = (
    "RESOURCE_EXHAUSTED",
    "RESOURCE EXHAUSTED",
    "Out of memory",
    "out of memory",
    "OOM",
    "Failed to allocate",
    "failed to allocate",
)
# CUDA errors after which the context is unusable: every later call on
# it fails too.  Checked before the transient markers, which (INTERNAL)
# can match text inside CUDA library errors.
_CUDA_FATAL_MARKERS = (
    "illegal memory access",
    "unspecified launch failure",
    "device-side assert",
    "misaligned address",
)
_TRANSIENT_MARKERS = (
    "UNAVAILABLE",
    "DEADLINE_EXCEEDED",
    "ABORTED",
    "CANCELLED",
    "DATA_LOSS",
    "INTERNAL",
    "Socket closed",
    "connection reset",
)


def classify_failure(exc: BaseException) -> str:
    """``'oom'`` | ``'transient'`` | ``'fatal'``.

    By exception type, then by markers in ``"TypeName: message"``.
    Python usage errors (``ValueError``, ``TypeError``) classify fatal:
    retrying a bug never fixes it."""
    if isinstance(exc, DeviceOOMError):
        return "oom"
    if isinstance(exc, DeviceTransientError):
        return "transient"
    if isinstance(exc, (MemoryError, torch.cuda.OutOfMemoryError)):
        return "oom"
    text = f"{type(exc).__name__}: {exc}"
    if any(m in text for m in _OOM_MARKERS):
        return "oom"
    if any(m in text for m in _CUDA_FATAL_MARKERS):
        return "fatal"
    if any(m in text for m in _TRANSIENT_MARKERS):
        return "transient"
    return "fatal"


@dataclass
class SupervisorConfig:
    """Knobs of one supervised call (``api.solve(retry_budget=...,
    chunk_floor=..., on_numeric_fault=...)`` and the CLI flags).

    ``retry_budget`` bounds transient retries PER DISPATCH (0 turns
    retry off).  ``chunk_floor`` is the smallest chunk the OOM ladder
    may halve down to.  ``on_numeric_fault`` picks quarantine or raise.
    ``backoff_*`` shape the retry sleeps: 20 ms doubling to a 250 ms
    cap, each stretched by up to 25% of keyed jitter by default.
    ``plan`` is a :class:`~pydcop_tpu_torch.faults.plan.FaultPlan` whose
    device-layer kinds inject at this seam; its seed also keys the retry
    backoff's jitter, so a chaos replay sleeps the same."""

    retry_budget: int = 2
    chunk_floor: int = 8
    on_numeric_fault: str = "quarantine"  # 'quarantine' | 'raise'
    backoff_base: float = 0.02
    backoff_factor: float = 2.0
    backoff_max: float = 0.25
    backoff_jitter: float = 0.25
    plan: Optional[Any] = None  # FaultPlan (device-layer kinds)
    sleep: Callable[[float], None] = field(default=time.sleep)

    def __post_init__(self) -> None:
        if self.retry_budget < 0:
            raise ValueError(
                f"retry_budget must be >= 0, got {self.retry_budget}"
            )
        if self.chunk_floor < 1:
            raise ValueError(
                f"chunk_floor must be >= 1, got {self.chunk_floor}"
            )
        if self.on_numeric_fault not in ("quarantine", "raise"):
            raise ValueError(
                "on_numeric_fault must be 'quarantine' or 'raise', "
                f"got {self.on_numeric_fault!r}"
            )

    def delays(self, key: str) -> Iterator[float]:
        """The keyed backoff stream of one retry loop."""
        return backoff_delays(
            base=self.backoff_base, factor=self.backoff_factor,
            max_delay=self.backoff_max, jitter=self.backoff_jitter,
            seed=self.plan.seed if self.plan is not None else 0,
            key=key,
        )


class Supervisor:
    """Supervised dispatch wrapper (module docstring).

    Sequence numbers are per scope and deterministic (every engine
    issues its dispatches in a fixed order), which makes the injected
    fault schedule replayable: decisions are pure in ``(plan seed,
    scope, seq)``."""

    #: engines run injection and the NaN screen (:data:`UNSUPERVISED`
    #: turns both off for the overhead baseline)
    active = True

    def __init__(self, config: Optional[SupervisorConfig] = None):
        self.config = config or SupervisorConfig()
        self._seq: Dict[str, int] = {}
        self._lock = threading.Lock()

    @property
    def plan(self):
        return self.config.plan

    @property
    def chunk_floor(self) -> int:
        return self.config.chunk_floor

    @property
    def on_numeric_fault(self) -> str:
        return self.config.on_numeric_fault

    def _next_seq(self, scope: str) -> int:
        with self._lock:
            s = self._seq[scope] = self._seq.get(scope, 0) + 1
        return s

    def _record_fault(self, kind: str, scope: str, seq: int) -> None:
        """``fault.<kind>`` counter and a ``fault``-category event with
        scope/seq/seed, as the JAX package records them."""
        met = get_metrics()
        if met.enabled:
            met.inc(f"fault.{kind}")
        tr = get_tracer()
        if tr.enabled:
            tr.event(
                kind, cat="fault", link=scope, seq=seq,
                seed=self.config.plan.seed if self.config.plan else None,
            )

    def _inject(self, scope, seq, width, rounds, table_bytes=None) -> None:
        plan = self.config.plan
        if plan is None or not plan.device_faults_configured:
            return
        if plan.oom_injected(width, rounds, table_bytes):
            self._record_fault("device_oom", scope, seq)
            raise DeviceOOMError(
                f"injected device OOM: dispatch {scope}#{seq} "
                f"(width={width}, rounds={rounds}, "
                f"table_bytes={table_bytes}) exceeds the chaos "
                "plan's capacity",
                injected=True,
            )
        if plan.decide_device_transient(scope, seq):
            self._record_fault("device_transient", scope, seq)
            raise DeviceTransientError(
                f"injected transient device failure: {scope}#{seq}"
            )

    def dispatch(
        self,
        fn: Callable[[], Any],
        *,
        scope: str = "engine.chunk",
        width: int = 1,
        rounds: Optional[int] = None,
        retryable: bool = True,
        table_bytes: Optional[int] = None,
    ):
        """Run one device dispatch under supervision and return its
        result.

        ``fn`` is a zero-argument closure that runs the device work AND
        copies what it returns to the host (the module docstring says
        why).  ``width`` is the dispatch's lane count (instances ×
        restarts, or a stack height), ``rounds`` its round count and
        ``table_bytes`` its per-lane joined-table bytes: what the
        injected capacity model caps.

        Transient failures retry in place (keyed backoff,
        ``engine.retries``) up to ``retry_budget`` times, then surface
        as :class:`UnrecoverableDeviceError`.  OOM always surfaces as
        :class:`DeviceOOMError` for the caller's degradation.  Fatal
        failures re-raise unwrapped after a ``fatal`` event.
        ``retryable=False``: ``fn`` is not called again after a REAL
        failure; a real transient surfaces as
        :class:`DeviceTransientError` for a caller-level restart.
        Injected faults fire before ``fn`` runs, so they retry in place
        either way."""
        cfg = self.config
        met = get_metrics()
        tr = get_tracer()
        attempts = 0
        delays: Optional[Iterator[float]] = None

        def _backoff(seq: int) -> None:
            nonlocal attempts, delays
            attempts += 1
            if met.enabled:
                met.inc("engine.retries")
            if tr.enabled:
                tr.event(
                    "retry", cat="supervisor", scope=scope,
                    seq=seq, attempt=attempts,
                )
            if delays is None:
                delays = cfg.delays(f"supervisor:{scope}")
            cfg.sleep(next(delays))

        def _exhausted(seq: int, e: BaseException) -> None:
            if tr.enabled:
                tr.event(
                    "retry-exhausted", cat="supervisor",
                    scope=scope, seq=seq, attempts=attempts,
                )
            raise UnrecoverableDeviceError(
                f"{scope}: transient device failure persisted "
                f"through the retry budget "
                f"({cfg.retry_budget}): {e}",
                scope=scope, kind="transient", attempts=attempts,
            ) from e

        while True:
            seq = self._next_seq(scope)
            try:
                self._inject(scope, seq, width, rounds, table_bytes)
            except DeviceTransientError as e:
                if attempts < cfg.retry_budget:
                    _backoff(seq)
                    continue
                _exhausted(seq, e)
            try:
                return fn()
            except Exception as e:  # noqa: BLE001 — classified below
                kind = classify_failure(e)
                if kind == "oom":
                    if isinstance(e, DeviceOOMError):
                        raise
                    raise DeviceOOMError(f"{scope}: {e}") from e
                if kind == "transient":
                    if retryable and attempts < cfg.retry_budget:
                        _backoff(seq)
                        continue
                    if not retryable:
                        if isinstance(e, DeviceTransientError):
                            raise
                        raise DeviceTransientError(f"{scope}: {e}") from e
                    _exhausted(seq, e)
                if tr.enabled:
                    tr.event(
                        "fatal", cat="supervisor", scope=scope,
                        seq=seq, error=str(e)[:200],
                    )
                raise

    def nan_lanes(self, n_lanes: int, scope: str = "engine.chunk") -> List[int]:
        """Lanes whose costs the chaos plan poisons at this chunk
        boundary (empty without a plan).  Boundary sequence numbers are
        per scope, so the schedule is replayable."""
        plan = self.config.plan
        if plan is None or not plan.device.nan:
            return []
        seq = self._next_seq(f"nan:{scope}")
        lanes = [
            i for i in range(n_lanes) if plan.decide_nan_inject(i, seq)
        ]
        for i in lanes:
            self._record_fault("nan_inject", f"{scope}[{i}]", seq)
        return lanes


class _Unsupervised:
    """Bare dispatch — no classification, retry, injection or NaN
    screen.  The baseline of the supervision-overhead measurement;
    never the default."""

    active = False
    plan = None
    chunk_floor = 1
    on_numeric_fault = "quarantine"

    def dispatch(self, fn, **_kw):
        return fn()

    def nan_lanes(self, n_lanes, scope="engine.chunk"):
        return []


UNSUPERVISED = _Unsupervised()

_ACTIVE: Optional[Supervisor] = None
_DEFAULT: Optional[Supervisor] = None
_DEFAULT_LOCK = threading.Lock()


def make_supervisor(
    retry_budget: Optional[int] = None,
    chunk_floor: Optional[int] = None,
    on_numeric_fault: Optional[str] = None,
    plan: Optional[Any] = None,
) -> Supervisor:
    """A per-call :class:`Supervisor` from optional knobs (``None``: the
    :class:`SupervisorConfig` default)."""
    knobs = {
        "retry_budget": retry_budget,
        "chunk_floor": chunk_floor,
        "on_numeric_fault": on_numeric_fault,
    }
    return Supervisor(
        SupervisorConfig(
            plan=plan,
            **{k: v for k, v in knobs.items() if v is not None},
        )
    )


def get_supervisor() -> Supervisor:
    """The ambient supervisor: the one :func:`supervision` installed,
    else a process default (retries on, no injection)."""
    sup = _ACTIVE
    if sup is not None:
        return sup
    global _DEFAULT
    if _DEFAULT is None:
        with _DEFAULT_LOCK:
            if _DEFAULT is None:
                _DEFAULT = Supervisor()
    return _DEFAULT


@contextlib.contextmanager
def supervision(sup) -> Iterator[Any]:
    """Install ``sup`` as the ambient supervisor for the block."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = sup
    try:
        yield sup
    finally:
        _ACTIVE = prev
