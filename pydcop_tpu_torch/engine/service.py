"""Continuous-batching solver service: the resident process that turns
one-shot solve calls into a serving loop (port of
``pydcop_tpu/engine/service.py``; the same frames, counters, spans,
result keys and checkpoint files).

``api.solve_many`` batches instances *within one call*; this module
batches *across concurrent callers*:

- an **admission queue** collects requests from any number of client
  threads / connections;
- a **tick policy** (:class:`TickPolicy`) bounds latency: a tick fires
  as soon as ``max_batch`` requests are pending OR the oldest request
  has waited ``max_wait`` seconds;
- each tick **coalesces** its requests into
  :func:`~pydcop_tpu_torch.ops.compile.problem_group_key` buckets (after
  the static-params partition ``api.solve_many`` uses) and dispatches
  every group as ONE ``run_many_batched`` run on the service's device —
  for Max-Sum one launch of the batched factor kernel and of the q
  update per round for the whole group;
- **occupancy bucketing** pads each group to a power-of-two instance
  count by repeating its last member (results discarded), as the JAX
  package does, so the group shapes a tick produces stay few;
- the compiled-problem cache (keyed on the request's dcop identity) and
  per-session :class:`~pydcop_tpu_torch.engine.incremental.
  IncrementalCompiler` pins persist across requests; the cache's entries
  hold device tensors;
- **session affinity**: a client that names a ``session`` gets its
  problem pinned to an IncrementalCompiler; streaming ``set_values``
  deltas re-tabulate only the touched constraints on the device
  (``compile.incremental``); exact (DPOP) sessions go through the
  memoized :class:`~pydcop_tpu_torch.engine.memo.ExactSession`;
- every dispatch runs under the service's
  :class:`~pydcop_tpu_torch.engine.supervisor.Supervisor`, so a
  poisoned or OOM-ing request quarantines / splits, and the
  device-layer chaos kinds exercise those paths against a live service.

What a client can rely on when its request is coalesced:

- Max-Sum, MGM, DBA, GDBA and DPOP draw nothing per round: a coalesced
  result equals the request's own ``api.solve`` with the service's
  ``pad_policy`` in every key but ``time``, and a request that shares a
  tick with a poisoned batchmate still returns the fault-free answer.
- The stochastic family (DSA, DSA-tuto, A-DSA, MGM-2, A-Max-Sum) draws a
  group's rounds from ONE device generator seeded from the group's first
  seed (``engine/batched.py:run_many_batched``).  A coalesced request
  therefore equals ``api.solve_many`` over its padded group — the
  members in admission order, the last repeated to the pow-2 count —
  not its solo solve; the JAX package keeps a key stream per instance
  and returns the solo result (ROADMAP C, 'Coalesced stochastic
  requests').  Under ``nan_inject`` the same holds with the same chaos.

Threads and the card: the tick worker dispatches on its own thread,
with the service's device made current there; every tensor lives on
that explicit device, results are host-side dicts before they reach a
:class:`PendingResult`, and the one host sync per chunk happens on the
dispatch thread.

Wire protocol (:class:`ServiceServer` / :class:`ServiceClient`):
newline-JSON frames over TCP, byte-compatible with the JAX package's,
so either package's client talks to either package's server.  The wire
carries the JAX package's hardening: a bounded admission queue and the
predicted-wait shed (``status="shed"``), a per-connection in-flight
cap, a graceful drain that writes the session checkpoint, the seeded
wire chaos kinds (``conn_drop``, ``slow_client``, ``frame_corrupt``) in
the reply path, keyed-backoff reconnects with idempotency keys and a
bounded reply cache, and structured errors for malformed frames.

Telemetry: counters ``service.requests``/``service.ticks``/
``service.dispatches``/``service.coalesced``/``service.pad_instances``/
``service.shed``/``service.frames_rejected``/
``service.sessions_restored``/``service.replayed_replies``/
``service.client_retries``, histograms ``service.queue_wait_s``/
``service.latency_s``/``service.batch_occupancy``/
``service.shed_latency_s``, per-request ``service.queue-wait`` +
``service.request`` spans, per-group ``service.dispatch`` spans and a
final ``service.drain`` span.  Every request carries a trace id
(``telemetry/context.py``) and every reply a phase breakdown
(``result["phases"]``: admission / queue / compile / device / decode /
reply_write); the flight-recorder ring is dumped on shed, quarantine,
dispatch-error and drain triggers (``flight_dump=``).

This module is import-light: torch and the engine load on the first
dispatch (the service's constructor resolves its device), so
``api.ServiceClient`` imports without torch.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import socket
import sys
import threading
import time
from collections import OrderedDict, deque
from typing import (
    Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union,
)

from pydcop_tpu_torch.telemetry import (
    get_flight_recorder,
    get_metrics,
    get_tracer,
)
from pydcop_tpu_torch.telemetry.context import (
    attempt_span_id,
    mint_trace_id,
    parse_wire_trace,
    trace_scope,
    wire_trace,
)
from pydcop_tpu_torch.telemetry.summary import _percentile

#: queue-wait / latency histogram buckets (seconds) — service
#: latencies live in the 1ms..10s band, below the metrics module's
#: generic defaults
_LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0,
)

#: bounded stats windows (per-service): enough for stable p99 at the
#: bench's request counts without growing forever in a resident process
_STATS_WINDOW = 8192

#: per-session delta-log bound: a resident session streaming
#: set_values forever must not grow its checkpoint (and the resume
#: replay it implies) with session AGE — past the bound the oldest
#: half folds into one cumulative delta (see _Session.record_delta)
_DELTA_LOG_MAX = 4096


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _pad_policy_doc(pad_policy: Any) -> Dict[str, Any]:
    """The canonical JSON form of a pad policy (string spec or
    PadPolicy object) — what session checkpoints store and compare."""
    from pydcop_tpu_torch.ops.padding import as_pad_policy

    return dataclasses.asdict(as_pad_policy(pad_policy))


def _exact_doc(sess: "_Session") -> Dict[str, Any]:
    """The checkpointable exact-session record: {algo: params} for
    every MEMOIZED exact session (engine/memo.py) the session holds —
    what the restore/replication replay re-warms.  Plain pinned
    clones (syncbb) carry no memo worth warming and are rebuilt
    lazily instead."""
    return {
        a: dict(p)
        for a, p in sess.exact_params.items()
        if getattr(sess.exact.get(a), "memo", None) is not None
    }


def _dcop_source(dcop: Any) -> Optional[Tuple[str, str]]:
    """The serializable identity of a request's dcop, for session
    checkpoints: yaml text ships verbatim, paths by realpath; DCOP
    objects have no wire identity (None — serialized at checkpoint
    time via ``dcop_yaml`` when possible)."""
    if isinstance(dcop, str) and "\n" in dcop:
        return ("yaml", dcop)
    if isinstance(dcop, str):
        return ("path", os.path.realpath(dcop))
    return None


@dataclasses.dataclass
class TickPolicy:
    """When a tick fires: as soon as ``max_batch`` requests are
    pending, or as soon as the OLDEST pending request has waited
    ``max_wait`` seconds — whichever comes first.  ``max_batch`` also
    caps how many requests one tick drains (a burst beyond it rolls
    into the immediately-following tick), so dispatch width — and with
    it HBM footprint and per-tick latency — stays bounded."""

    max_batch: int = 32
    max_wait: float = 0.01

    def __post_init__(self) -> None:
        if self.max_batch < 1:
            raise ValueError(
                f"max_batch must be >= 1, got {self.max_batch}"
            )
        if self.max_wait < 0:
            raise ValueError(
                f"max_wait must be >= 0, got {self.max_wait}"
            )


class PendingResult:
    """Handle for a submitted request: :meth:`result` blocks until the
    service tick that carried the request completes (or raises what
    the dispatch raised)."""

    def __init__(self) -> None:
        self._done = threading.Event()
        self._result: Optional[Dict[str, Any]] = None
        self._error: Optional[BaseException] = None
        self._lock = threading.Lock()
        self._callbacks: List[Any] = []

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        if not self._done.wait(timeout):
            raise TimeoutError(
                "service request still pending after "
                f"{timeout}s (is the service running?)"
            )
        if self._error is not None:
            raise self._error
        assert self._result is not None
        return self._result

    def add_done_callback(self, fn) -> None:
        """Run ``fn(self)`` once the request reaches its terminal
        state (immediately if it already has).  The wire server uses
        this to pipeline replies instead of parking one blocked thread
        per in-flight request."""
        with self._lock:
            if not self._done.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    # -- service side ----------------------------------------------------

    def _finish(self) -> None:
        with self._lock:
            self._done.set()
            cbs, self._callbacks = self._callbacks, []
        for fn in cbs:
            try:
                fn(self)
            except Exception:  # noqa: BLE001 — a broken callback must
                # not take down the tick worker delivering the result
                pass

    def _set_result(self, result: Dict[str, Any]) -> None:
        self._result = result
        self._finish()

    def _set_error(self, error: BaseException) -> None:
        self._error = error
        self._finish()


@dataclasses.dataclass
class _Request:
    """One admitted solve or infer request (internal)."""

    dcop: Any  # DCOP object (loaded at admission)
    dcop_key: Tuple  # compiled-problem cache key
    algo: str
    params: Dict[str, Any]  # prepared algo params
    rounds: int
    seed: int
    chunk_size: int
    convergence_chunks: int
    n_restarts: int
    timeout: Optional[float]
    session: Optional[str]
    set_values: Optional[Dict[str, Any]]
    pending: PendingResult
    # serializable dcop identity for session checkpoints:
    # ("yaml", text) / ("path", realpath) / None for in-process objects
    dcop_src: Optional[Tuple[str, str]] = None
    enqueue_t: float = 0.0
    queue_wait: float = 0.0
    # inference requests (submit_infer): the query string and its
    # knobs — the QUERY joins the dispatch partition key, so mixed
    # kbest/map/log_z traffic in one tick coalesces per query and
    # never mixes sweeps across queries
    query: Optional[str] = None
    infer_kw: Optional[Dict[str, Any]] = None
    # request trace context (telemetry/context.py): the wire client's
    # trace id + per-attempt span id, or a service-minted id for
    # in-process submits — what correlates this request's spans
    # across processes and client retries
    trace_id: Optional[str] = None
    trace_span: Optional[str] = None
    trace_attempt: int = 1
    # phase-breakdown timestamps (docs/observability.md, "Serving
    # observability"): contiguous segments from submit entry to
    # result delivery, attached to the reply as result["phases"]
    t_sub: float = 0.0  # submit() entry
    admit_s: float = 0.0  # submit entry -> enqueued
    dispatch_t: float = 0.0  # this request's group started processing
    compile_s: float = 0.0  # problem compile + stack/pad, pre-device
    device_s: float = 0.0  # the device (or host-solve) run
    decode_t0: float = 0.0  # run done; decode runs until _finish


class _Session:
    """One client's pinned incremental-compile state: the
    :class:`~pydcop_tpu_torch.engine.incremental.IncrementalCompiler`
    built on the session's FIRST request plus the accumulated external
    values its ``set_values`` deltas stream in.  Segment 2+ costs a
    device delta-update (``compile.incremental``) or nothing
    (``compile.reused``) — never a host rebuild."""

    def __init__(
        self,
        compiler,
        dcop,
        dcop_key: Tuple,
        source: Optional[Tuple[str, str]] = None,
    ) -> None:
        self.compiler = compiler
        self.dcop = dcop
        self.dcop_key = dcop_key  # admission identity of segment 1
        self.source = source  # checkpointable identity (yaml/path)
        self.ext_values: Dict[str, Any] = {}
        # the ordered applied set_values deltas — a restarted service
        # replays them through the IncrementalCompiler so a follow-up
        # lands on bit-identical device tables (docs/serving.md)
        self.deltas: List[Dict[str, Any]] = []
        self.segments = 0
        # exact-algorithm state: per-algo pinned exact sessions —
        # dpop gets the memoized contraction session (engine/memo.py,
        # the O(delta) re-solve path), other solve_host algos a plain
        # pinned clone — plus the JSON-safe params of each, so the
        # checkpoint/replication replay can re-warm the memo
        self.exact: Dict[str, Any] = {}
        self.exact_params: Dict[str, Dict[str, Any]] = {}

    def record_delta(self, delta: Dict[str, Any]) -> None:
        """Append one applied delta, keeping the log bounded: past
        ``_DELTA_LOG_MAX`` the oldest half folds into one cumulative
        delta.  Folding keeps the replay VALUE-equal (every touched
        constraint re-tabulates from the same final external state);
        only the f32 fold ORDER of unary-folded rows can drift by an
        ulp for sessions older than the bound — the price of a
        checkpoint and resume that are O(bound), not O(session age)."""
        self.deltas.append(dict(delta))
        if len(self.deltas) > _DELTA_LOG_MAX:
            half = len(self.deltas) // 2
            merged: Dict[str, Any] = {}
            for d in self.deltas[:half]:
                merged.update(d)
            self.deltas = [merged] + self.deltas[half:]


class ServiceError(RuntimeError):
    """A request the service could not solve (bad algo/params/dcop, or
    an unrecoverable dispatch failure); the message is the client-side
    report."""


class ServiceTransportError(ServiceError):
    """The request could not be exchanged with the service at all
    (connect/send/receive failed past the retry window) — as opposed
    to a structured server-side refusal.  Best-effort operations
    (:meth:`ServiceClient.shutdown`) tolerate this after the request
    was plausibly delivered."""


class SolverService:
    """The resident continuous-batching solver (module docstring).

    In-process use::

        with session() as tel, SolverService(pad_policy="pow2") as svc:
            pendings = [svc.submit(d, "dsa", {}) for d in dcops]
            results = [p.result() for p in pendings]

    ``submit`` is thread-safe: N client threads submitting
    concurrently coalesce into shared ticks.  :class:`ServiceServer`
    puts the same object behind a TCP socket for out-of-process
    clients (:class:`ServiceClient`).

    ``device`` is where every request runs: the CUDA device unless
    ``"cpu"`` is passed (without a card the constructor raises).

    The service does not open a telemetry session of its own —
    counters/spans land in whatever session is active (the ``serve``
    command opens one for the server's lifetime; in-process embedders
    wrap the service in ``telemetry.session()``), and the always-on
    :meth:`stats` aggregates stay available without one.
    """

    def __init__(
        self,
        pad_policy: str = "pow2",
        tick: Optional[TickPolicy] = None,
        *,
        max_batch: Optional[int] = None,
        max_wait: Optional[float] = None,
        instance_bucket: str = "pow2",
        chaos: Optional[str] = None,
        chaos_seed: int = 0,
        retry_budget: Optional[int] = None,
        chunk_floor: Optional[int] = None,
        on_numeric_fault: Optional[str] = None,
        compile_cache_max: int = 256,
        max_queue: int = 1024,
        session_memo_bytes: int = 64 << 20,
        session_checkpoint: Optional[str] = None,
        resume: bool = False,
        flight_dump: Optional[str] = None,
        standbys: Optional[Sequence[str]] = None,
        autostart: bool = True,
        device: Any = None,
    ):
        from pydcop_tpu_torch.device import resolve_device
        from pydcop_tpu_torch.ops.padding import as_pad_policy

        # every compile, stack, run and session of this service goes to
        # this one explicit device (the CUDA device unless "cpu" is
        # passed; without a card the service raises here)
        self.device = resolve_device(device)
        as_pad_policy(pad_policy)  # fail fast on a malformed spec
        self.pad_policy = pad_policy
        if tick is None:
            tick = TickPolicy()
        if max_batch is not None:
            tick = dataclasses.replace(tick, max_batch=max_batch)
        if max_wait is not None:
            tick = dataclasses.replace(tick, max_wait=max_wait)
        self.tick = tick
        if instance_bucket not in ("pow2", "none"):
            raise ValueError(
                "instance_bucket must be 'pow2' or 'none', got "
                f"{instance_bucket!r}"
            )
        self.instance_bucket = instance_bucket

        if max_queue < 1:
            raise ValueError(
                f"max_queue must be >= 1, got {max_queue}"
            )
        self.max_queue = max_queue
        # per-session byte bound of the subtree-fingerprint message
        # memo (engine/memo.py) behind exact-algorithm session
        # follow-ups; <= 0 disables memoization (every follow-up
        # re-contracts the full tree)
        self.session_memo_bytes = int(session_memo_bytes)
        self.session_checkpoint = session_checkpoint
        # flight-recorder dump target: on a shed / quarantine /
        # dispatch-error / drain trigger the session's always-on ring
        # (telemetry/flightrec.py) is dumped here atomically, the
        # triggering request's trace id front and center.  Dumps are
        # throttled (below) — a sustained overload shedding hundreds
        # of requests/sec must not amplify itself into hundreds of
        # full-ring serializations/sec of the same overwritten file
        self.flight_dump = flight_dump
        self._flight_last = 0.0
        # per-service request ordinal: mints DETERMINISTIC trace ids
        # (pure in admission order) for in-process submits that carry
        # no wire trace context
        self._trace_ordinal = 0

        plan = None
        if chaos:
            from pydcop_tpu_torch.faults import FaultPlan

            plan = FaultPlan.from_spec(chaos, chaos_seed)
            if plan.message_faults_configured or plan.crashes:
                raise ValueError(
                    "the solver service dispatches on the batched "
                    "engine, which has no message plane — chaos "
                    "accepts the DEVICE-layer kinds (device_oom, "
                    "device_transient, nan_inject) and the WIRE "
                    "kinds (conn_drop, slow_client, frame_corrupt) "
                    "only (docs/faults.md)"
                )
            if plan.fleet_faults_configured:
                raise ValueError(
                    "fleet-level chaos kinds (replica_kill) act on "
                    "a replicated serving fleet's processes — one "
                    "service cannot kill a replica of itself; use "
                    "`pydcop_tpu fleet --chaos` (docs/faults.md)"
                )
        self.chaos_plan = plan
        from pydcop_tpu_torch.engine.supervisor import make_supervisor

        self._sup = make_supervisor(
            retry_budget=retry_budget, chunk_floor=chunk_floor,
            on_numeric_fault=on_numeric_fault, plan=plan,
        )

        self._cond = threading.Condition()
        self._close_lock = threading.Lock()  # serializes close()
        self._queue: deque = deque()
        self._closing = False
        self._worker: Optional[threading.Thread] = None
        self._sessions: Dict[str, _Session] = {}
        # compiled-problem cache: dcop identity -> CompiledProblem
        # (LRU; the value also pins the DCOP object so an id-keyed
        # entry can never alias a new object at a recycled address)
        self._compiled: "OrderedDict[Tuple, Tuple[Any, Any]]" = (
            OrderedDict()
        )
        self._compile_cache_max = compile_cache_max

        # always-on aggregates (stats()); bounded windows
        self._stats_lock = threading.Lock()
        self._n_requests = 0
        self._n_ticks = 0
        self._n_dispatches = 0
        self._n_coalesced = 0  # requests that shared a group with >= 1 other
        self._n_pad_instances = 0
        self._n_errors = 0
        self._n_shed = 0
        self._n_frames_rejected = 0
        self._n_sessions_restored = 0
        self._n_replayed_replies = 0
        self._queue_waits: deque = deque(maxlen=_STATS_WINDOW)
        self._latencies: deque = deque(maxlen=_STATS_WINDOW)
        self._occupancies: deque = deque(maxlen=_STATS_WINDOW)
        self._shed_lats: deque = deque(maxlen=_STATS_WINDOW)
        # the deadline-aware shed's capacity estimate: the MEDIAN of
        # a recent-tick-duration window (robust — one compile-heavy
        # cold tick must not poison the predictor into shedding
        # easily-meetable deadlines for the next N ticks, which a
        # decay-based EWMA would); None until the first tick lands
        # (the service never sheds on a deadline it has no data to
        # judge)
        self._tick_durs: deque = deque(maxlen=32)
        self._tick_med: Optional[float] = None
        self._drained = False

        # fleet replication (docs/serving.md, "The fleet"): the
        # standby addresses this replica streams its session delta
        # logs to, the persistent clients it streams over, and the
        # REPLICATED copies of OTHER replicas' sessions it holds as a
        # standby (promoted into _sessions on the first failed-over
        # frame).  One lock serializes standby mutation AND the
        # per-entry sends, so a standby always applies a session's
        # entries in segment order.
        self._repl_lock = threading.Lock()
        self._standby_addrs: List[str] = []
        self._repl_clients: Dict[str, "ServiceClient"] = {}
        self._standby_sessions: Dict[str, _Session] = {}
        self._n_replica_updates = 0
        self._n_replicated_segments = 0
        self._n_replication_errors = 0
        self._n_sessions_promoted = 0

        if resume:
            if not session_checkpoint:
                raise ValueError(
                    "resume=True needs session_checkpoint=<path> — "
                    "there is nothing else to resume from"
                )
            # no existence pre-check: resuming from a checkpoint that
            # is missing, truncated, or schema-drifted must FAIL with
            # a structured error, not silently start empty — a fleet
            # health watcher treats the dead process as unhealthy and
            # routes around it, whereas a silently-empty replica
            # would claim its ring arc with every session lost
            self.restore_sessions(session_checkpoint)

        if standbys:
            self.set_standbys(standbys)

        if autostart:
            self.start()

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        """Start the tick worker (idempotent)."""
        with self._cond:
            if self._worker is not None and self._worker.is_alive():
                return
            self._closing = False
            self._drained = False
            self._worker = threading.Thread(
                target=self._run, name="solver-service-tick", daemon=True
            )
            self._worker.start()

    def close(self) -> None:
        """Graceful drain: stop admitting, finish every queued tick,
        join the worker, write the final session checkpoint (when
        ``session_checkpoint`` is configured) and flush the final
        queue-depth gauge.  Idempotent and safe under concurrent
        callers (a signal-path close racing a ``with``-block exit):
        the close lock serializes the drain, and late callers return
        once the first finished."""
        with self._close_lock:
            self._close_locked()

    def _close_locked(self) -> None:
        with self._cond:
            if self._drained:
                return
            self._closing = True
            self._cond.notify_all()
        t0 = time.perf_counter()
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        if self.session_checkpoint:
            try:
                self.write_session_checkpoint(self.session_checkpoint)
            except Exception as e:  # noqa: BLE001 — a checkpoint
                # failure must not mask the drain (the in-flight
                # results were already delivered); record it where
                # the operator actually looks, not only on a trace
                # that may not be running
                print(
                    "service: session checkpoint write failed: "
                    f"{type(e).__name__}: {e}",
                    file=sys.stderr,
                )
                tr = get_tracer()
                if tr.enabled:
                    tr.event(
                        "service-checkpoint-error", cat="service",
                        error=f"{type(e).__name__}: {e}"[:300],
                    )
        with self._repl_lock:
            repl = list(self._repl_clients.values())
            self._repl_clients = {}
        for cli in repl:
            cli.close()
        self._drained = True
        met = get_metrics()
        if met.enabled:
            met.gauge("service.queue_depth", 0)
        tr = get_tracer()
        if tr.enabled:
            tr.add_span(
                "service.drain", "service", t0,
                time.perf_counter() - t0,
                sessions=len(self._sessions),
            )
        # the drain itself is a flight trigger: the last thing a
        # terminating service leaves behind is its recent timeline
        self._flight_trigger("drain", None)

    #: minimum seconds between non-drain flight dumps: the FIRST
    #: trigger of a failure episode captures the interesting window;
    #: later triggers inside the interval would serialize the same
    #: ~4096-record ring again only to overwrite the file.  Under a
    #: shed storm this caps the dump cost at one write per interval
    #: instead of one per rejected request (a drain always dumps —
    #: it is the terminal artifact).
    _FLIGHT_DUMP_MIN_INTERVAL_S = 1.0

    def _flight_trigger(
        self, trigger: str, trace_id: Optional[str]
    ) -> None:
        """Dump the session's flight-recorder ring (when a dump path
        is configured and a session is active), throttled per
        ``_FLIGHT_DUMP_MIN_INTERVAL_S``.  Best-effort: the recorder
        must never take down the path that triggered it."""
        if not self.flight_dump:
            return
        rec = get_flight_recorder()
        if not rec.enabled:
            return
        now = time.perf_counter()
        if (
            trigger != "drain"
            and now - self._flight_last
            < self._FLIGHT_DUMP_MIN_INTERVAL_S
        ):
            return
        self._flight_last = now
        try:
            rec.dump(self.flight_dump, trigger, trace_id=trace_id)
        except OSError as e:
            print(
                f"service: flight dump failed: "
                f"{type(e).__name__}: {e}",
                file=sys.stderr,
            )

    def health(self) -> Dict[str, Any]:
        """The ``/healthz`` document (``telemetry/export.py``):
        liveness + readiness at a glance.  ``status`` flips ``ok`` →
        ``draining`` the moment a graceful shutdown starts and
        ``drained`` once the queue has fully delivered."""
        with self._cond:
            depth = len(self._queue)
            closing = self._closing
            drained = self._drained
            sessions = len(self._sessions)
        status = (
            "drained" if drained else "draining" if closing else "ok"
        )
        with self._stats_lock:
            return {
                "status": status,
                "queue_depth": depth,
                "sessions": sessions,
                "requests": self._n_requests,
                "shed": self._n_shed,
                "errors": self._n_errors,
                "drained": drained,
            }

    def __enter__(self) -> "SolverService":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- admission -------------------------------------------------------

    def submit(
        self,
        dcop: Any = None,
        algo: Optional[str] = None,
        algo_params: Optional[Mapping[str, Any]] = None,
        *,
        rounds: int = 200,
        seed: int = 0,
        chunk_size: int = 64,
        convergence_chunks: int = 0,
        n_restarts: int = 1,
        timeout: Optional[float] = None,
        session: Optional[str] = None,
        set_values: Optional[Mapping[str, Any]] = None,
        max_util_bytes: Optional[int] = None,
        bnb: Optional[str] = None,
        table_dtype: Optional[str] = None,
        table_format: Optional[str] = None,
        trace: Optional[Mapping[str, Any]] = None,
    ) -> PendingResult:
        """Admit one solve request; returns a :class:`PendingResult`.

        ``dcop`` is a DCOP object, a yaml file path, or yaml TEXT (any
        string containing a newline is treated as text — the wire
        protocol's form).  ``session`` names a session: its first
        request must carry the dcop and pins an incremental compiler;
        later requests may omit ``dcop`` and stream ``set_values``
        deltas ({external variable: value}) instead.
        ``max_util_bytes`` (exact algorithms with a bounded-memory
        plan — DPOP) caps the request's largest UTIL table via the
        memory-bounded contraction planner (``ops/membound.py``) —
        it folds into the algorithm params, so it also partitions
        dispatch groups like any other param.  ``bnb``
        (``auto|on|off``) selects the branch-and-bound pruned
        contraction kernels the same way (an algo param of the
        algorithms with a device contraction phase — dpop, maxsum;
        results bit-identical, ``docs/semirings.md``).  ``trace`` is
        the wire
        client's trace context (``telemetry/context.py`` wire form);
        omitted, the service mints a deterministic id at admission.
        Validation errors raise HERE (before admission); dispatch
        errors surface from ``PendingResult.result()``.
        """
        t_sub = time.perf_counter()
        with self._cond:
            if self._closing:
                raise ServiceError("service is closed")
        if n_restarts < 1:
            raise ValueError(
                f"n_restarts must be >= 1, got {n_restarts}"
            )
        if set_values is not None and session is None:
            raise ValueError(
                "set_values streams external-variable deltas into a "
                "pinned session — pass session=<name> (docs/serving.md)"
            )

        sess = self._sessions.get(session) if session else None
        if sess is None and session:
            # a failed-over session's first frame on this replica:
            # promote the replicated standby copy into the live table
            # so the follow-up costs compile.incremental, not a
            # re-pin (docs/serving.md, "The fleet")
            sess = self._promote_standby(session)
        if sess is not None:
            if dcop is not None:
                # a follow-up may resend the SAME dcop (a reconnecting
                # wire client naturally re-ships its yaml text); a
                # DIFFERENT one would silently solve the pinned
                # problem under the new problem's name — reject it
                _, key = self._load_dcop(dcop)
                if key != sess.dcop_key:
                    raise ServiceError(
                        f"session {session!r} is pinned to a "
                        "different dcop — close_session first, or "
                        "use a new session name (docs/serving.md)"
                    )
            dcop_obj, dcop_key = sess.dcop, sess.dcop_key
        else:
            if dcop is None:
                raise ValueError(
                    "dcop is required (only follow-up requests of an "
                    "open session may omit it)"
                )
            dcop_obj, dcop_key = self._load_dcop(dcop)
        if algo is None:
            raise ValueError("algo is required")

        from pydcop_tpu_torch.algorithms import (
            load_algorithm_module,
            prepare_algo_params,
        )

        algo_name, params_in = str(algo), dict(algo_params or {})
        module = load_algorithm_module(algo_name)
        if max_util_bytes is not None:
            if not any(
                p.name == "max_util_bytes"
                for p in module.algo_params
            ):
                raise ValueError(
                    "max_util_bytes bounds the exact contraction "
                    "engine's largest UTIL table (ops/membound.py) "
                    f"— {algo_name!r} has no such table to bound"
                )
            if int(max_util_bytes) <= 0:
                raise ValueError(
                    "max_util_bytes must be > 0, got "
                    f"{max_util_bytes}"
                )
            params_in = {
                **dict(params_in or {}),
                "max_util_bytes": int(max_util_bytes),
            }
        if bnb is not None:
            if not any(
                p.name == "bnb" for p in module.algo_params
            ):
                raise ValueError(
                    "bnb selects the branch-and-bound pruned "
                    "contraction kernels — supported by algorithms "
                    "with a device contraction phase (dpop, "
                    f"maxsum); {algo_name!r} has none"
                )
            if bnb not in ("auto", "on", "off"):
                raise ValueError(
                    f"bnb must be 'auto'|'on'|'off', got {bnb!r}"
                )
            params_in = {**dict(params_in or {}), "bnb": str(bnb)}
        if table_dtype is not None:
            if not any(
                p.name == "table_dtype" for p in module.algo_params
            ):
                raise ValueError(
                    "table_dtype selects the storage precision of "
                    "packed contraction tables — supported by the "
                    "exact contraction engine (dpop); "
                    f"{algo_name!r} has none (maxsum's "
                    "message-plane sibling is msg_dtype)"
                )
            from pydcop_tpu_torch.ops.padding import as_table_dtype

            params_in = {
                **dict(params_in or {}),
                "table_dtype": as_table_dtype(table_dtype),
            }
        if table_format is not None:
            if not any(
                p.name == "table_format"
                for p in module.algo_params
            ):
                raise ValueError(
                    "table_format selects the storage layout of "
                    "packed contraction tables — supported by the "
                    "exact contraction engine (dpop); "
                    f"{algo_name!r} has none"
                )
            from pydcop_tpu_torch.ops.sparse import as_table_format

            params_in = {
                **dict(params_in or {}),
                "table_format": as_table_format(table_format),
            }
        params = prepare_algo_params(params_in, module.algo_params)

        req = _Request(
            dcop=dcop_obj, dcop_key=dcop_key, algo=algo_name,
            params=params, rounds=rounds, seed=seed,
            chunk_size=chunk_size,
            convergence_chunks=convergence_chunks,
            n_restarts=n_restarts, timeout=timeout, session=session,
            set_values=dict(set_values) if set_values else None,
            pending=PendingResult(),
            dcop_src=_dcop_source(dcop),
            t_sub=t_sub,
        )
        self._apply_trace(req, trace)
        return self._admit(req)

    def _apply_trace(
        self, req: _Request, trace: Optional[Mapping[str, Any]]
    ) -> None:
        """Attach the request's trace context: the wire client's when
        the frame carried one, else a service-minted id that is pure
        in the per-service admission ordinal (so in-process traffic
        stitches and replays deterministically too)."""
        parsed = parse_wire_trace(trace)
        if parsed is not None:
            req.trace_id, req.trace_span, req.trace_attempt = parsed
            return
        with self._stats_lock:
            self._trace_ordinal += 1
            ordinal = self._trace_ordinal
        req.trace_id = mint_trace_id("local", ordinal)
        req.trace_span = attempt_span_id(req.trace_id, 1)

    def _admit(self, req: _Request) -> PendingResult:
        """The one admission tail (solve and infer requests share it):
        count, overload-check under the queue lock, enqueue or shed."""
        met = get_metrics()
        if met.enabled:
            met.inc("service.requests")
        t_admit = time.perf_counter()
        if not req.t_sub:
            req.t_sub = t_admit
        req.admit_s = t_admit - req.t_sub
        shed_reason = None
        depth = 0
        with self._cond:
            if self._closing:
                raise ServiceError("service is closed")
            depth = len(self._queue)
            shed_reason = self._shed_reason_locked(req.timeout)
            if shed_reason is None:
                req.enqueue_t = t_admit
                self._queue.append(req)
                self._cond.notify_all()
        with self._stats_lock:
            self._n_requests += 1
        if shed_reason is not None:
            self._shed(req, shed_reason, depth, t_admit)
        return req.pending

    def submit_infer(
        self,
        dcop: Any = None,
        query: str = "marginals",
        *,
        order: str = "pseudo_tree",
        beta: float = 1.0,
        tol: float = 1e-6,
        device: str = "auto",
        device_min_cells: int = 1 << 14,
        timeout: Optional[float] = None,
        map_vars: Optional[Sequence[str]] = None,
        external_dists: Optional[
            Mapping[str, Mapping[Any, float]]
        ] = None,
        max_util_bytes: Optional[int] = None,
        bnb: str = "auto",
        table_dtype: str = "f32",
        table_format: str = "dense",
        trace: Optional[Mapping[str, Any]] = None,
    ) -> PendingResult:
        """Admit one inference request (``docs/semirings.md``): the
        semiring contraction queries — ``marginals`` / ``log_z`` /
        ``map`` / ``kbest:<k>`` / ``marginal_map`` (``map_vars``) /
        ``expectation`` (``external_dists``) — served by the same
        tick loop as solves.  The QUERY joins the dispatch partition
        key: a tick of mixed-query traffic coalesces each query's
        requests into ONE merged contraction sweep
        (``run_infer_many`` — per-request results bit-identical to
        sequential ``api.infer`` calls) and never mixes sweeps across
        queries.  Validation errors raise here; dispatch errors
        surface from ``PendingResult.result()``."""
        t_sub = time.perf_counter()
        with self._cond:
            if self._closing:
                raise ServiceError("service is closed")
        from pydcop_tpu_torch.ops.semiring import (
            ELIMINATION_ORDERS,
            parse_query,
        )

        qkind, _ = parse_query(query)  # fail fast, nearest-name hint
        # the cross-field checks run_infer_many enforces must fail at
        # ADMISSION too — a doomed request must not occupy queue
        # depth and fail asynchronously a tick later
        if qkind == "marginal_map":
            if not map_vars:
                raise ValueError(
                    "marginal_map needs map_vars=[...] — the "
                    "variables maximized over"
                )
            if max_util_bytes is not None:
                raise ValueError(
                    "marginal_map cannot run memory-bounded "
                    "(docs/semirings.md, 'Structured cells')"
                )
        elif map_vars:
            raise ValueError(
                f"map_vars applies to query='marginal_map' only, "
                f"not {query!r}"
            )
        if external_dists and qkind != "expectation":
            raise ValueError(
                "external_dists applies to query='expectation' "
                f"only, not {query!r}"
            )
        if order not in ELIMINATION_ORDERS:
            raise ValueError(
                f"unknown elimination order {order!r} (expected one "
                f"of {ELIMINATION_ORDERS})"
            )
        if device not in ("auto", "never", "always"):
            raise ValueError(
                f"device must be 'auto'|'never'|'always', got "
                f"{device!r}"
            )
        if beta <= 0:
            raise ValueError(f"beta must be > 0, got {beta}")
        if max_util_bytes is not None and int(max_util_bytes) <= 0:
            raise ValueError(
                f"max_util_bytes must be > 0, got {max_util_bytes}"
            )
        if bnb not in ("auto", "on", "off"):
            raise ValueError(
                f"bnb must be 'auto'|'on'|'off', got {bnb!r}"
            )
        from pydcop_tpu_torch.ops.padding import as_table_dtype
        from pydcop_tpu_torch.ops.sparse import as_table_format

        table_dtype = as_table_dtype(table_dtype)  # fail at admission
        table_format = as_table_format(table_format)
        if dcop is None:
            raise ValueError("dcop is required")
        dcop_obj, dcop_key = self._load_dcop(dcop)
        req = _Request(
            dcop=dcop_obj, dcop_key=dcop_key,
            algo=f"infer:{query}", params={}, rounds=0, seed=0,
            chunk_size=0, convergence_chunks=0, n_restarts=1,
            timeout=timeout, session=None, set_values=None,
            pending=PendingResult(), dcop_src=_dcop_source(dcop),
            query=str(query),
            infer_kw={
                "order": str(order),
                "beta": float(beta),
                "tol": float(tol),
                "device": str(device),
                "device_min_cells": int(device_min_cells),
                "map_vars": (
                    tuple(map_vars) if map_vars else None
                ),
                "external_dists": (
                    {
                        str(n): dict(d)
                        for n, d in external_dists.items()
                    }
                    if external_dists
                    else None
                ),
                "max_util_bytes": (
                    int(max_util_bytes)
                    if max_util_bytes is not None
                    else None
                ),
                "bnb": str(bnb),
                "table_dtype": table_dtype,
                "table_format": table_format,
            },
        )
        req.t_sub = t_sub
        self._apply_trace(req, trace)
        return self._admit(req)

    def solve(self, *args, **kwargs) -> Dict[str, Any]:
        """Blocking convenience: ``submit(...).result()``."""
        return self.submit(*args, **kwargs).result()

    def infer(self, *args, **kwargs) -> Dict[str, Any]:
        """Blocking convenience: ``submit_infer(...).result()``."""
        return self.submit_infer(*args, **kwargs).result()

    # -- overload control ------------------------------------------------

    def _shed_reason_locked(self, timeout: Optional[float]):
        """Why this request must be shed at admission, or None.

        Two triggers (docs/serving.md): the bounded queue is full, or
        the request carries a deadline the service already knows it
        cannot meet.  ``timeout`` is the request's END-TO-END budget
        from admission (dispatch hands the remainder to the engine,
        which truncates at chunk boundaries with terminal
        ``status="timeout"``); we shed only when the predicted queue
        WAIT ALONE — full ticks queued ahead of it times the median
        recent tick duration — already consumes it, i.e. the request would
        reach dispatch with nothing left.  An idle service therefore
        never sheds, however tight the budget.  Shedding at admission
        costs microseconds; admitting a doomed request would cost a
        dispatch slot and still return nothing."""
        depth = len(self._queue)
        if depth >= self.max_queue:
            return "queue-full"
        if timeout is not None and self._tick_med:
            ticks_ahead = depth // self.tick.max_batch
            if ticks_ahead * self._tick_med >= timeout:
                return "deadline"
        return None

    def _shed(
        self,
        req: _Request,
        reason: str,
        depth: int,
        t_admit: float,
    ) -> None:
        met = get_metrics()
        tr = get_tracer()
        latency = time.perf_counter() - t_admit
        if met.enabled:
            met.inc("service.shed")
            met.observe(
                "service.shed_latency_s", latency,
                buckets=_LATENCY_BUCKETS,
            )
        if tr.enabled:
            tr.event(
                "service-shed", cat="service", reason=reason,
                algo=req.algo, queue_depth=depth,
                trace=req.trace_id,
            )
        with self._stats_lock:
            self._n_shed += 1
            self._shed_lats.append(latency)
        req.pending._set_result(
            {
                "status": "shed",
                "shed_reason": reason,
                "queue_depth": depth,
                "algo": req.algo,
                "trace": req.trace_id,
                # a shed never reaches dispatch: the whole breakdown
                # is the admission segment
                "phases": {"admission": req.admit_s + latency},
            }
        )
        self._flight_trigger("shed", req.trace_id)

    # -- wire-server hooks (ServiceServer bookkeeping) -------------------

    def note_shed(self, reason: str) -> None:
        """Record a request shed BEFORE admission (the wire server's
        per-connection in-flight cap) so overload shows up in one
        place regardless of which layer refused the work."""
        met = get_metrics()
        if met.enabled:
            met.inc("service.shed")
        tr = get_tracer()
        if tr.enabled:
            tr.event("service-shed", cat="service", reason=reason)
        with self._stats_lock:
            self._n_shed += 1

    def note_frame_rejected(self) -> None:
        met = get_metrics()
        if met.enabled:
            met.inc("service.frames_rejected")
        with self._stats_lock:
            self._n_frames_rejected += 1

    def note_replayed_reply(self) -> None:
        met = get_metrics()
        if met.enabled:
            met.inc("service.replayed_replies")
        with self._stats_lock:
            self._n_replayed_replies += 1

    def close_session(self, name: str) -> bool:
        """Drop a pinned session (frees its compiled state); returns
        whether it existed.  A replicated standby copy of the same
        name drops too — a closed session must not resurrect through
        a later promotion."""
        with self._repl_lock:
            self._standby_sessions.pop(name, None)
        with self._cond:
            return self._sessions.pop(name, None) is not None

    # -- session checkpoint / restore ------------------------------------

    def write_session_checkpoint(self, path: str) -> Dict[str, Any]:
        """Serialize every restorable pinned session — the dcop
        identity (yaml text or path), the ORDERED applied
        ``set_values`` deltas, and the per-session segment counter —
        plus a final :meth:`stats` snapshot, atomically, to ``path``
        (JSON).  ``serve --resume`` replays it so reconnecting
        sessions' follow-ups stay ``compile.incremental``-only.

        Object-pinned in-process sessions serialize through
        ``dcop_yaml`` when possible; ones that cannot are listed under
        ``"skipped"`` instead of failing the drain."""
        with self._cond:
            sessions = dict(self._sessions)
        entries: List[Dict[str, Any]] = []
        skipped: List[str] = []
        for name, sess in sessions.items():
            src = sess.source
            if src is None:
                try:
                    from pydcop_tpu_torch.dcop.yamldcop import dcop_yaml

                    src = ("yaml", dcop_yaml(sess.dcop))
                except Exception:  # noqa: BLE001 — not every
                    # in-process constraint round-trips through yaml
                    skipped.append(name)
                    continue
            entries.append(
                {
                    "name": name,
                    "source": list(src),
                    "deltas": sess.deltas,
                    "segments": sess.segments,
                    "exact": _exact_doc(sess),
                }
            )
        doc = {
            "kind": "pydcop_tpu-service-sessions",
            "version": 1,
            # canonical JSON-safe form: pad_policy may be a PadPolicy
            # OBJECT (as_pad_policy accepts both) and must still
            # checkpoint — and compare equal at resume regardless of
            # which spelling either side used
            "pad_policy": _pad_policy_doc(self.pad_policy),
            "sessions": entries,
            "skipped": skipped,
            "stats": self.stats(),
        }
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(doc, f)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        tr = get_tracer()
        if tr.enabled:
            tr.event(
                "service-checkpoint", cat="service",
                sessions=len(entries), skipped=len(skipped),
            )
        return doc

    def restore_sessions(self, path: str) -> int:
        """Replay a drained service's session checkpoint: rebuild each
        session's dcop, pin a fresh IncrementalCompiler, and re-apply
        the recorded ``set_values`` deltas IN ORDER — the exact
        incremental-update arithmetic of the original service, so a
        reconnecting client's next follow-up lands on bit-identical
        device tables and costs ``compile.incremental`` only (the
        replay itself pays the one segment-1 ``compile.full``, at
        startup, before any request is admitted).  Returns the number
        of sessions restored.

        The three broken-checkpoint shapes fail with STRUCTURED
        errors (missing file, truncated/non-JSON content, schema
        drift) — ``serve --resume`` surfaces them as a clean exit, so
        a fleet health watcher sees the replica as dead instead of a
        hung or silently-empty one."""
        try:
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
        except FileNotFoundError:
            raise ServiceError(
                f"session checkpoint {path} does not exist — the "
                "previous run never drained there (or the path is "
                "wrong); start without resume, or point at the real "
                "checkpoint"
            ) from None
        except ValueError as e:
            raise ServiceError(
                f"session checkpoint {path} is not valid JSON "
                f"(truncated or corrupted write?): {e}"
            ) from None
        if (
            not isinstance(doc, dict)
            or doc.get("kind") != "pydcop_tpu-service-sessions"
        ):
            raise ServiceError(
                f"{path} is not a service session checkpoint"
            )
        if doc.get("version") != 1:
            raise ServiceError(
                f"session checkpoint {path} has schema version "
                f"{doc.get('version')!r}, this build reads version 1 "
                "— re-drain under the current build (docs/serving.md)"
            )
        if doc.get("pad_policy") != _pad_policy_doc(self.pad_policy):
            raise ServiceError(
                f"checkpoint was written under pad_policy="
                f"{doc.get('pad_policy')!r}, the service runs "
                f"{_pad_policy_doc(self.pad_policy)!r} — resumed "
                "sessions would land in different shape buckets "
                "(docs/serving.md)"
            )
        restored = 0
        skipped: List[Tuple[str, str]] = []
        for entry in doc.get("sessions", ()):
            # per-entry tolerance, mirroring the write side's
            # "skipped" list: one stale entry (a cleaned-up yaml
            # path, a since-invalid dcop) must not abort the whole
            # resume and lose every OTHER session
            try:
                name, sess = self._build_session_from_entry(entry)
            except Exception as e:  # noqa: BLE001 — skip, record
                skipped.append(
                    (
                        str(entry.get("name")),
                        f"{type(e).__name__}: {e}"[:200],
                    )
                )
                continue
            with self._cond:
                self._sessions[name] = sess
            restored += 1
        if skipped:
            tr = get_tracer()
            if tr.enabled:
                tr.event(
                    "service-restore-skipped", cat="service",
                    sessions=[n for n, _ in skipped],
                    errors=[err for _, err in skipped],
                )
        met = get_metrics()
        if met.enabled and restored:
            met.inc("service.sessions_restored", restored)
        with self._stats_lock:
            self._n_sessions_restored += restored
        tr = get_tracer()
        if tr.enabled:
            tr.event(
                "service-restore", cat="service", sessions=restored,
            )
        return restored

    def _build_session_from_entry(
        self, entry: Mapping[str, Any]
    ) -> Tuple[str, _Session]:
        """Rebuild one checkpoint/replication session entry through
        the restore replay: load the dcop from its serialized
        identity, pin a fresh IncrementalCompiler, pay the one
        segment-1 ``compile.full``, and re-apply the recorded deltas
        IN ORDER (``compile.incremental`` each) — bit-identical
        device tables to the service that wrote the entry."""
        from pydcop_tpu_torch.engine.incremental import IncrementalCompiler

        name = str(entry["name"])
        kind, val = entry["source"]
        if kind == "yaml":
            from pydcop_tpu_torch.dcop.yamldcop import load_dcop

            dcop = load_dcop(val)
            key: Tuple = (
                "yaml",
                hashlib.sha256(val.encode("utf-8")).hexdigest(),
            )
        elif kind == "path":
            from pydcop_tpu_torch.dcop.yamldcop import load_dcop_from_file

            dcop = load_dcop_from_file(val)
            st = os.stat(os.path.realpath(val))
            key = (
                "path", os.path.realpath(val),
                st.st_mtime_ns, st.st_size,
            )
        else:
            raise ServiceError(f"unknown source kind {kind!r}")
        compiler = IncrementalCompiler(
            dcop, pad_policy=self.pad_policy, device=self.device
        )
        sess = _Session(compiler, dcop, key, source=(kind, val))
        ext: Dict[str, Any] = {}
        compiler.compile({}, ext)  # segment 1 (the one full)
        for delta in entry.get("deltas", ()):
            ext.update(delta)
            compiler.compile({}, ext)  # replayed incremental
        sess.ext_values = ext
        sess.deltas = [dict(d) for d in entry.get("deltas", ())]
        sess.segments = int(entry.get("segments", 0))
        # warm the memoized exact sessions the entry recorded: ONE
        # solve at the final accumulated state re-fills the message
        # memo and pre-warms the 1-row kernels (engine/memo.py), so
        # the session's first LIVE follow-up is already an O(delta)
        # memo re-solve — the exact-path analogue of the replayed
        # compile.incremental contract above
        for algo, params in (entry.get("exact") or {}).items():
            if str(algo) != "dpop":
                continue
            try:
                from pydcop_tpu_torch.engine.memo import ExactSession

                es = ExactSession(
                    dcop,
                    pad_policy=self.pad_policy,
                    memo_bytes=self.session_memo_bytes,
                    device=self.device,
                )
                if ext:
                    es.set_values(ext)
                es.solve(dict(params or {}))
            except Exception:  # noqa: BLE001 — the warm replay is
                # an optimization; the live path rebuilds lazily
                continue
            sess.exact[str(algo)] = es
            sess.exact_params[str(algo)] = dict(params or {})
        return name, sess

    # -- fleet replication (docs/serving.md, "The fleet") ----------------

    def session_entry(self, name: str) -> Optional[Dict[str, Any]]:
        """One session's replication entry — exactly the checkpoint
        schema (serialized dcop identity + ordered delta log + segment
        counter), so the standby applies it through the SAME restore
        replay the checkpoint/resume contract already pins as
        bit-identical.  None when the session does not exist or its
        in-process dcop cannot serialize."""
        with self._cond:
            sess = self._sessions.get(name)
        if sess is None:
            return None
        src = sess.source
        if src is None:
            try:
                from pydcop_tpu_torch.dcop.yamldcop import dcop_yaml

                src = ("yaml", dcop_yaml(sess.dcop))
            except Exception:  # noqa: BLE001 — same tolerance as
                # the checkpoint writer's "skipped" list
                return None
        return {
            "name": name,
            "source": list(src),
            "deltas": [dict(d) for d in sess.deltas],
            "segments": sess.segments,
            "exact": _exact_doc(sess),
        }

    def set_standbys(self, addrs: Sequence[str]) -> int:
        """Configure this replica's replication targets (its hash-ring
        successors — the fleet controller computes them from
        ``engine.fleet.standby_map``) and WARM them: every currently
        live session re-streams immediately, so a standby attached
        late (a rebalance, a restarted fleet member) holds a full
        copy before the next failover could need it.  Returns the
        number of sessions streamed."""
        clean = [str(a) for a in addrs]
        with self._repl_lock:
            old = list(self._repl_clients.values())
            self._repl_clients = {}
            self._standby_addrs = clean
        for cli in old:
            cli.close()
        with self._cond:
            names = list(self._sessions)
        for name in names:
            self.replicate_session(name)
        return len(names)

    def replicate_session(
        self,
        name: str,
        cache: Optional[Dict[str, Any]] = None,
    ) -> None:
        """Stream one session's current replication entry to every
        configured standby (the wire server calls this after each
        delivered session reply, BEFORE the reply reaches the client
        — so any reply a client observed is already recoverable).
        ``cache`` piggybacks the delivered ``(ikey, reply)`` pair so
        the standby pre-populates its reply cache: a failover retry
        of an answered request replays there instead of re-solving.
        A session that no longer exists streams a tombstone (the
        standby drops its copy).  Best-effort per standby: a
        replication failure is counted and traced, never raised into
        the delivery path."""
        with self._repl_lock:
            if not self._standby_addrs:
                return
        entry = self.session_entry(name)
        if entry is None:
            entry = {"name": name, "closed": True}
        with self._repl_lock:
            addrs = list(self._standby_addrs)
            for addr in addrs:
                self._replicate_to_locked(addr, entry, cache)

    def _replicate_to_locked(
        self,
        addr: str,
        entry: Dict[str, Any],
        cache: Optional[Dict[str, Any]],
    ) -> None:
        met = get_metrics()
        try:
            cli = self._repl_clients.get(addr)
            if cli is None:
                cli = ServiceClient(
                    addr, timeout=5.0, retry_window=0.5
                )
                self._repl_clients[addr] = cli
            cli._call("replicate", entry=entry, cache=cache)
        except (ServiceError, OSError) as e:
            # drop the client so the next entry reconnects fresh; the
            # standby re-syncs from the full delta log it carries
            stale = self._repl_clients.pop(addr, None)
            if stale is not None:
                stale.close()
            with self._stats_lock:
                self._n_replication_errors += 1
            if met.enabled:
                met.inc("service.replication_errors")
            tr = get_tracer()
            if tr.enabled:
                tr.event(
                    "service-replication-error", cat="service",
                    standby=addr, session=entry.get("name"),
                    error=f"{type(e).__name__}: {e}"[:200],
                )
            return
        with self._stats_lock:
            self._n_replicated_segments += 1
        if met.enabled:
            met.inc("service.replicated_segments")

    def apply_replica_entry(
        self, entry: Mapping[str, Any]
    ) -> Dict[str, Any]:
        """Apply one replicated session entry as a STANDBY (the
        ``replicate`` wire op).  When the entry's delta log extends
        the copy we already hold (same source, our applied deltas are
        a prefix), only the tail replays — ``compile.incremental``
        per new delta, zero fulls; anything else (first sight, a
        diverged log, a re-pinned source) rebuilds through the
        checkpoint-restore replay.  A ``closed`` tombstone drops the
        copy."""
        name = str(entry.get("name"))
        if not name:
            raise ServiceError("replicate entry has no session name")
        if entry.get("closed"):
            with self._repl_lock:
                self._standby_sessions.pop(name, None)
            return {"mode": "closed", "segments": 0}
        deltas = [dict(d) for d in entry.get("deltas", ())]
        with self._repl_lock:
            sess = self._standby_sessions.get(name)
            if (
                sess is not None
                and list(sess.source or ())
                == list(entry.get("source", ()))
                and sess.deltas == deltas[: len(sess.deltas)]
                and int(entry.get("segments", 0)) >= sess.segments
            ):
                mode = "incremental"
                for delta in deltas[len(sess.deltas):]:
                    sess.ext_values.update(delta)
                    sess.compiler.compile({}, sess.ext_values)
                sess.deltas = deltas
                sess.segments = int(
                    entry.get("segments", sess.segments)
                )
                # standby exact sessions follow the tail WITHOUT
                # re-solving: set_values re-tabulates only touched
                # constraints, so the memo (warm since the rebuild
                # solve) serves the promoted session's first
                # follow-up as an O(tail) re-contraction
                sess.exact_params.update(
                    {
                        str(a): dict(p or {})
                        for a, p in (
                            entry.get("exact") or {}
                        ).items()
                    }
                )
                for es in list(sess.exact.values()):
                    try:
                        es.set_values(sess.ext_values)
                    except Exception:  # noqa: BLE001 — drop the
                        # copies; promotion rebuilds lazily
                        sess.exact.clear()
                        break
            else:
                mode = "rebuild"
                name, sess = self._build_session_from_entry(entry)
                self._standby_sessions[name] = sess
        with self._stats_lock:
            self._n_replica_updates += 1
        met = get_metrics()
        if met.enabled:
            met.inc("service.replica_updates")
        return {"mode": mode, "segments": sess.segments}

    def _promote_standby(self, name: str) -> Optional["_Session"]:
        """Move a replicated standby copy into the LIVE session table
        — the failed-over session's first frame lands here, and its
        follow-up must cost ``compile.incremental`` exactly as it
        would have on the dead owner."""
        with self._repl_lock:
            sess = self._standby_sessions.pop(name, None)
        if sess is None:
            return None
        with self._cond:
            live = self._sessions.setdefault(name, sess)
        if live is sess:
            with self._stats_lock:
                self._n_sessions_promoted += 1
            met = get_metrics()
            if met.enabled:
                met.inc("service.sessions_promoted")
            tr = get_tracer()
            if tr.enabled:
                tr.event(
                    "service-promote", cat="service", session=name,
                    segments=sess.segments,
                )
        return live

    # -- stats -----------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """Always-on serving aggregates: request/tick/dispatch counts,
        coalesce ratio, occupancy and queue-wait/latency percentiles
        over a bounded recent window."""
        with self._stats_lock:
            waits = list(self._queue_waits)
            lats = list(self._latencies)
            occs = [float(o) for o in self._occupancies]
            shed_lats = list(self._shed_lats)
            out = {
                "requests": self._n_requests,
                "ticks": self._n_ticks,
                "dispatches": self._n_dispatches,
                "coalesced_requests": self._n_coalesced,
                "pad_instances": self._n_pad_instances,
                "errors": self._n_errors,
                "shed": self._n_shed,
                "frames_rejected": self._n_frames_rejected,
                "sessions_restored": self._n_sessions_restored,
                "replayed_replies": self._n_replayed_replies,
                "replica_updates": self._n_replica_updates,
                "replicated_segments": self._n_replicated_segments,
                "replication_errors": self._n_replication_errors,
                "sessions_promoted": self._n_sessions_promoted,
                "standby_sessions": len(self._standby_sessions),
                "sessions": len(self._sessions),
                "queue_depth": len(self._queue),
                "drained": self._drained,
            }
        out["coalesce_ratio"] = (
            round(len(lats) and sum(occs) / max(1, len(occs)), 4)
            if occs
            else 0.0
        )
        out["queue_wait_s"] = {
            "p50": _percentile(waits, 50),
            "p99": _percentile(waits, 99),
            "max": max(waits) if waits else 0.0,
        }
        out["latency_s"] = {
            "p50": _percentile(lats, 50),
            "p99": _percentile(lats, 99),
            "max": max(lats) if lats else 0.0,
        }
        out["batch_occupancy"] = {
            "p50": _percentile(occs, 50),
            "max": max(occs) if occs else 0.0,
        }
        # admission-to-reject latency: the overload acceptance wants a
        # BOUNDED p99 here — shedding must stay cheap under pressure
        out["shed_latency_s"] = {
            "p50": _percentile(shed_lats, 50),
            "p99": _percentile(shed_lats, 99),
            "max": max(shed_lats) if shed_lats else 0.0,
        }
        return out

    # -- dcop loading + compiled-problem cache ---------------------------

    def _load_dcop(self, dcop: Any) -> Tuple[Any, Tuple]:
        """Normalize a request's dcop to (DCOP object, cache key).

        yaml TEXT keys by content hash (repeat submissions of the same
        text share one compile), paths by (realpath, mtime, size),
        objects by identity (the cache entry pins the object, so the
        id can never be recycled under the key)."""
        from pydcop_tpu_torch.dcop.dcop import DCOP

        if isinstance(dcop, DCOP):
            return dcop, ("obj", id(dcop))
        if isinstance(dcop, str) and "\n" in dcop:
            key = (
                "yaml",
                hashlib.sha256(dcop.encode("utf-8")).hexdigest(),
            )
            with self._cond:
                cached = self._compiled.get(key)
            if cached is not None:
                return cached[0], key
            from pydcop_tpu_torch.dcop.yamldcop import load_dcop

            return load_dcop(dcop), key
        if isinstance(dcop, (str, list, tuple)):
            from pydcop_tpu_torch.dcop.yamldcop import load_dcop_from_file

            if isinstance(dcop, str):
                path = os.path.realpath(dcop)
                st = os.stat(path)
                key = ("path", path, st.st_mtime_ns, st.st_size)
                with self._cond:
                    cached = self._compiled.get(key)
                if cached is not None:
                    return cached[0], key
            else:
                key = ("paths", tuple(dcop))
            return load_dcop_from_file(dcop), key
        raise ValueError(
            f"dcop must be a DCOP object, a yaml path, or yaml text — "
            f"got {type(dcop).__name__}"
        )

    def _compiled_problem(self, req: _Request):
        """The request's CompiledProblem, from the LRU cache when the
        dcop identity was seen before: repeated requests skip the
        tabulation and the host-to-device copy (the entries hold the
        problem's tensors on the service's device)."""
        key = req.dcop_key
        with self._cond:
            hit = self._compiled.get(key)
            if hit is not None and (
                key[0] != "obj" or hit[0] is req.dcop
            ):
                self._compiled.move_to_end(key)
                return hit[1]
        from pydcop_tpu_torch.ops.compile import compile_dcop

        problem = compile_dcop(
            req.dcop, pad_policy=self.pad_policy, device=self.device
        )
        with self._cond:
            self._compiled[key] = (req.dcop, problem)
            while len(self._compiled) > self._compile_cache_max:
                self._compiled.popitem(last=False)
        return problem

    # -- the tick loop ---------------------------------------------------

    def _run(self) -> None:
        if self.device.type == "cuda":
            # the kernels launch on the current device's stream: make
            # the service's device current on this thread, whatever
            # the submitting threads have current
            import torch

            torch.cuda.set_device(self.device)
        while True:
            with self._cond:
                while not self._queue and not self._closing:
                    self._cond.wait()
                if not self._queue:
                    return  # closing, drained
                # tick policy: fire on max_batch pending, or when the
                # oldest request has waited max_wait
                while (
                    len(self._queue) < self.tick.max_batch
                    and not self._closing
                ):
                    left = self.tick.max_wait - (
                        time.perf_counter() - self._queue[0].enqueue_t
                    )
                    if left <= 0:
                        break
                    self._cond.wait(timeout=left)
                batch = [
                    self._queue.popleft()
                    for _ in range(
                        min(len(self._queue), self.tick.max_batch)
                    )
                ]
            tick_t0 = time.perf_counter()
            try:
                self._dispatch_tick(batch)
            except Exception as e:  # noqa: BLE001 — the worker must
                # outlive ANY tick (an escaped telemetry/bookkeeping
                # error would otherwise kill the thread silently and
                # leave every future request queued forever): fail
                # the batch's undelivered requests, keep ticking
                try:
                    self._fail(batch, e)
                except Exception:  # noqa: BLE001 — even the failure
                    # path (tracer/metrics) can be what's broken;
                    # unblocking the clients is the one hard duty left
                    for req in batch:
                        if not req.pending.done():
                            req.pending._set_error(
                                ServiceError(
                                    f"tick dispatch failed: "
                                    f"{type(e).__name__}: {e}"
                                )
                            )
            # feed the deadline-aware shed's capacity estimate: how
            # long a tick of work actually takes right now
            dur = time.perf_counter() - tick_t0
            with self._cond:
                self._tick_durs.append(dur)
                self._tick_med = _percentile(
                    list(self._tick_durs), 50
                )

    def _dispatch_tick(self, batch: List[_Request]) -> None:
        from pydcop_tpu_torch.engine.supervisor import supervision

        met = get_metrics()
        tr = get_tracer()
        tick_t = time.perf_counter()
        for req in batch:
            req.queue_wait = tick_t - req.enqueue_t
            if met.enabled:
                met.observe(
                    "service.queue_wait_s", req.queue_wait,
                    buckets=_LATENCY_BUCKETS,
                )
            if tr.enabled:
                tr.add_span(
                    "service.queue-wait", "service", req.enqueue_t,
                    req.queue_wait, algo=req.algo,
                    trace=req.trace_id,
                )
        with self._stats_lock:
            self._n_ticks += 1
            self._queue_waits.extend(r.queue_wait for r in batch)
        if met.enabled:
            met.inc("service.ticks")
            met.gauge("service.queue_depth", len(self._queue))

        # session requests keep FIFO order per session; stateless
        # solves coalesce into groups; infer requests partition by
        # QUERY (plus knobs) and merge per partition
        with supervision(self._sup):
            stateless: List[_Request] = []
            infer_reqs: List[_Request] = []
            for req in batch:
                if req.query is not None:
                    infer_reqs.append(req)
                elif req.session is not None:
                    self._dispatch_session(req)
                else:
                    stateless.append(req)
            if stateless:
                self._dispatch_groups(stateless)
            if infer_reqs:
                self._dispatch_infer_groups(infer_reqs)

    # -- dispatch: coalesced stateless groups ----------------------------

    def _group_key(self, req: _Request) -> Tuple:
        from pydcop_tpu_torch.engine.host_batch import statics_signature

        return (
            req.algo,
            statics_signature(req.params),
            req.rounds,
            req.chunk_size,
            req.convergence_chunks,
            req.n_restarts,
            # timeouts act GROUP-wide at chunk boundaries
            # (run_many_batched), so a request carrying one may only
            # coalesce with requests carrying the same one — a tight
            # deadline must never truncate a batchmate's solve
            req.timeout,
        )

    def _dispatch_groups(self, reqs: List[_Request]) -> None:
        partitions: "OrderedDict[Tuple, List[_Request]]" = OrderedDict()
        for req in reqs:
            partitions.setdefault(self._group_key(req), []).append(req)
        for part in partitions.values():
            from pydcop_tpu_torch.algorithms import load_algorithm_module

            module = load_algorithm_module(part[0].algo)
            try:
                if hasattr(module, "solve_host"):
                    self._dispatch_host(part, module)
                else:
                    self._dispatch_device(part, module)
            except Exception as e:  # noqa: BLE001 — fail this
                # partition's requests, keep serving the others
                self._fail(part, e)

    def _finish(
        self, req: _Request, result: Dict[str, Any], group_n: int
    ) -> None:
        met = get_metrics()
        tr = get_tracer()
        now = time.perf_counter()
        latency = now - req.enqueue_t
        result["queue_wait"] = req.queue_wait
        result["instances_batched"] = group_n
        result.pop("telemetry", None)  # service-level, not per-request
        result["trace"] = req.trace_id
        # the per-request phase breakdown (docs/observability.md,
        # "Serving observability"): contiguous segments from submit
        # entry to this delivery — their sum is the server-side share
        # of the client-observed latency.  `queue` runs from enqueue
        # to the request's GROUP starting to process (so a late group
        # in a multi-group tick reports its true wait, not the tick's
        # start), `decode` from the device sync to this delivery.
        phases = {
            "admission": round(req.admit_s, 6),
            "queue": round(
                max(
                    (req.dispatch_t or now) - req.enqueue_t, 0.0
                ),
                6,
            ),
            "compile": round(req.compile_s, 6),
            "device": round(req.device_s, 6),
            "decode": round(
                max(now - req.decode_t0, 0.0) if req.decode_t0 else 0.0,
                6,
            ),
        }
        result["phases"] = phases
        if met.enabled:
            met.observe(
                "service.latency_s", latency, buckets=_LATENCY_BUCKETS
            )
            if group_n > 1:
                met.inc("service.coalesced")
            # deterministic work delivered (FAQ cost-model unit):
            # UTIL/contraction cells for exact solves ("util_cells" on
            # dpop results, "cells" on infer results) — feeds the
            # cells/s column in `top` and the perf-drift tooling
            # (docs/performance.md)
            cells = result.get("util_cells") or result.get("cells")
            if isinstance(cells, (int, float)) and cells > 0:
                met.inc("service.work_cells", int(cells))
        if tr.enabled:
            tr.add_span(
                "service.request", "service", req.enqueue_t, latency,
                algo=req.algo, instances=group_n,
                status=result.get("status"), trace=req.trace_id,
                phases=phases,
            )
        with self._stats_lock:
            self._latencies.append(latency)
            if group_n > 1:
                self._n_coalesced += 1
        req.pending._set_result(result)
        if result.get("status") == "degraded":
            # a quarantined lane: the evidence of WHY (the nan_inject
            # fault event, the supervisor actions, the batchmates'
            # spans) is on the ring right now — dump it
            self._flight_trigger("quarantine", req.trace_id)

    def _fail(self, reqs: List[_Request], error: BaseException) -> None:
        # a partition can span several stacked groups; groups that
        # already delivered must keep their results when a LATER
        # group's dispatch raises
        reqs = [r for r in reqs if not r.pending.done()]
        if not reqs:
            return
        met = get_metrics()
        tr = get_tracer()
        if tr.enabled:
            tr.event(
                "service-error", cat="service",
                error=f"{type(error).__name__}: {error}"[:300],
                requests=len(reqs),
                trace=[r.trace_id for r in reqs if r.trace_id]
                or None,
            )
        if met.enabled:
            met.inc("service.errors", len(reqs))
        with self._stats_lock:
            self._n_errors += len(reqs)
        for req in reqs:
            req.pending._set_error(
                ServiceError(
                    f"dispatch failed for algo={req.algo!r}: "
                    f"{type(error).__name__}: {error}"
                )
            )
        # an unrecoverable dispatch is the flight recorder's reason to
        # exist: the failing group's spans + supervisor events are on
        # the ring, the reply only carries the error string
        self._flight_trigger("error", reqs[0].trace_id)

    def _record_dispatch(self, k: int, padded: int) -> None:
        met = get_metrics()
        if met.enabled:
            met.inc("service.dispatches")
            met.observe(
                "service.batch_occupancy", k,
                buckets=(1, 2, 4, 8, 16, 32, 64, 128),
            )
            if padded:
                met.inc("service.pad_instances", padded)
        with self._stats_lock:
            self._n_dispatches += 1
            self._occupancies.append(k)
            self._n_pad_instances += padded

    def _dispatch_device(self, part: List[_Request], module) -> None:
        from pydcop_tpu_torch.api import _result_dict
        from pydcop_tpu_torch.engine.batched import run_many_batched
        from pydcop_tpu_torch.ops.compile import stack_problems

        tr = get_tracer()
        r0 = part[0]
        # phase attribution: the first group's `compile` segment opens
        # at the partition's problem-compile, later groups' at their
        # own iteration start (their wait behind earlier groups'
        # device runs is queue time, which `dispatch_t` delimits)
        t_part0 = time.perf_counter()
        problems = [self._compiled_problem(r) for r in part]
        groups = stack_problems(problems)
        del problems
        first_group = True
        while groups:
            stacked = groups.pop(0)
            g0 = t_part0 if first_group else time.perf_counter()
            first_group = False
            group = [part[i] for i in stacked.indices]
            k = len(group)
            # occupancy bucketing: pad the group to a pow-2 instance
            # count by repeating the last member, as the JAX package
            # does (its runner cache keys on K); pad lanes re-solve a
            # real instance and are discarded below
            padded = 0
            if self.instance_bucket == "pow2" and k > 1:
                k_pad = _next_pow2(k)
                if k_pad != k:
                    padded = k_pad - k
                    stacked = stack_problems(
                        stacked.host_problems
                        + [stacked.host_problems[-1]] * padded
                    )[0]
            # the group key pins one shared timeout per partition
            run_timeout = None
            if r0.timeout is not None:
                run_timeout = max(
                    r0.timeout
                    - (time.perf_counter() - r0.enqueue_t),
                    0.01,
                )
            self._record_dispatch(k, padded)
            params_list = [g.params for g in group]
            seeds = [g.seed for g in group]
            if padded:
                params_list = params_list + [params_list[-1]] * padded
                seeds = seeds + [seeds[-1]] * padded
            t_run0 = time.perf_counter()
            for req in group:
                req.dispatch_t = g0
                req.compile_s = t_run0 - g0
            # every span/event recorded inside the dispatch — the
            # dispatch span itself, supervisor retries/faults,
            # quarantine events — tags with the group's trace ids
            hand = [stacked]  # run_many_batched takes the only reference
            del stacked
            with trace_scope([g.trace_id for g in group]):
                with tr.span(
                    "service.dispatch", cat="service", instances=k,
                    padded=padded, algo=r0.algo,
                ):
                    results = run_many_batched(
                        hand,
                        module,
                        params_list,
                        rounds=r0.rounds,
                        seeds=seeds,
                        timeout=run_timeout,
                        chunk_size=r0.chunk_size,
                        convergence_chunks=r0.convergence_chunks,
                        n_restarts=r0.n_restarts,
                    )
            t_done = time.perf_counter()
            for req in group:
                req.device_s = t_done - t_run0
                req.decode_t0 = t_done
            for req, rr in zip(group, results):  # pads fall off zip
                out = _result_dict(rr)
                out["time"] = rr.time / k
                self._finish(req, out, k)

    def _dispatch_host(self, part: List[_Request], module) -> None:
        """Exact host-path algorithms (DPOP, SyncBB): one
        ``run_many_host`` call per partition — DPOP requests merge
        their UTIL sweeps exactly as ``api.solve_many`` merges them."""
        from pydcop_tpu_torch.engine.host_batch import run_many_host

        tr = get_tracer()
        r0 = part[0]
        k = len(part)
        # the group key pins one shared timeout per partition
        run_timeout = None
        if r0.timeout is not None:
            run_timeout = max(
                r0.timeout - (time.perf_counter() - r0.enqueue_t),
                0.01,
            )
        self._record_dispatch(k, 0)
        t_run0 = time.perf_counter()
        for req in part:
            # host-path phase attribution: compile (dcop -> tables)
            # happens inside run_many_host, inseparable from the
            # sweep — the whole call is the `device` segment
            req.dispatch_t = t_run0
            req.compile_s = 0.0
        with trace_scope([g.trace_id for g in part]):
            with tr.span(
                "service.dispatch", cat="service", instances=k,
                padded=0, algo=r0.algo,
            ):
                results = run_many_host(
                    [g.dcop for g in part],
                    module,
                    [g.params for g in part],
                    timeout=run_timeout,
                    pad_policy=self.pad_policy,
                    device=self.device,
                )
        t_done = time.perf_counter()
        for req in part:
            req.device_s = t_done - t_run0
            req.decode_t0 = t_done
        for req, out in zip(part, results):
            self._finish(req, out, out.get("instances_batched", k))

    # -- dispatch: coalesced inference partitions ------------------------

    def _infer_group_key(self, req: _Request) -> Tuple:
        """The infer dispatch partition key: QUERY first — mixed-query
        traffic in one tick must coalesce per query, never across —
        then every knob that changes the sweep's arithmetic or its
        group-wide timeout."""
        kw = req.infer_kw
        ed = kw.get("external_dists")
        ed_key = (
            None
            if not ed
            else tuple(
                sorted(
                    (
                        n,
                        tuple(
                            sorted(
                                (str(v), float(p))
                                for v, p in d.items()
                            )
                        ),
                    )
                    for n, d in ed.items()
                )
            )
        )
        return (
            "infer", req.query, kw["order"], kw["beta"], kw["tol"],
            kw["device"], kw["device_min_cells"], kw["map_vars"],
            ed_key, kw["max_util_bytes"], kw.get("bnb", "auto"),
            kw.get("table_dtype", "f32"),
            kw.get("table_format", "dense"), req.timeout,
        )

    def _dispatch_infer_groups(self, reqs: List[_Request]) -> None:
        partitions: "OrderedDict[Tuple, List[_Request]]" = (
            OrderedDict()
        )
        for req in reqs:
            partitions.setdefault(
                self._infer_group_key(req), []
            ).append(req)
        for part in partitions.values():
            try:
                self._dispatch_infer(part)
            except Exception as e:  # noqa: BLE001 — fail this
                # partition's requests, keep serving the others
                self._fail(part, e)

    def _dispatch_infer(self, part: List[_Request]) -> None:
        """One merged ``run_infer_many`` sweep per infer partition:
        same-bucket contractions from different requests share one
        stacked dispatch, and per-request results equal sequential
        ``api.infer`` calls (the infer_many contract)."""
        from pydcop_tpu_torch.ops.semiring import run_infer_many

        tr = get_tracer()
        r0 = part[0]
        kw = r0.infer_kw
        k = len(part)
        run_timeout = None
        if r0.timeout is not None:
            run_timeout = max(
                r0.timeout - (time.perf_counter() - r0.enqueue_t),
                0.01,
            )
        self._record_dispatch(k, 0)
        mv = kw["map_vars"]
        t_run0 = time.perf_counter()
        for req in part:
            req.dispatch_t = t_run0
            req.compile_s = 0.0  # plan+kernels build inside the sweep
        with trace_scope([g.trace_id for g in part]):
            with tr.span(
                "service.dispatch", cat="service", instances=k,
                padded=0, algo=r0.algo,
            ):
                results = run_infer_many(
                    [g.dcop for g in part],
                    r0.query,
                    order=kw["order"],
                    beta=kw["beta"],
                    tol=kw["tol"],
                    device=kw["device"],
                    device_min_cells=kw["device_min_cells"],
                    pad_policy=self.pad_policy,
                    timeout=run_timeout,
                    max_util_bytes=kw["max_util_bytes"],
                    map_vars=list(mv) if mv else None,
                    external_dists=kw["external_dists"],
                    bnb=kw.get("bnb", "auto"),
                    table_dtype=kw.get("table_dtype", "f32"),
                    table_format=kw.get("table_format", "dense"),
                    torch_device=self.device,
                )
        t_done = time.perf_counter()
        for req in part:
            req.device_s = t_done - t_run0
            req.decode_t0 = t_done
        for req, out in zip(part, results):
            self._finish(req, out, k)

    # -- dispatch: session-affine requests -------------------------------

    def _dispatch_session(self, req: _Request) -> None:
        try:
            result = self._solve_session(req)
        except Exception as e:  # noqa: BLE001 — per-request failure
            self._fail([req], e)
            return
        self._finish(req, result, 1)

    def _solve_session(self, req: _Request) -> Dict[str, Any]:
        from pydcop_tpu_torch.api import _result_dict
        from pydcop_tpu_torch.engine.batched import run_batched

        tr = get_tracer()
        sess = self._sessions.get(req.session)
        if sess is None:
            from pydcop_tpu_torch.engine.incremental import (
                IncrementalCompiler,
            )

            sess = _Session(
                IncrementalCompiler(
                    req.dcop, pad_policy=self.pad_policy,
                    device=self.device,
                ),
                req.dcop,
                req.dcop_key,
                source=req.dcop_src,
            )
            self._sessions[req.session] = sess
            met = get_metrics()
            if met.enabled:
                met.inc("service.sessions_opened")
        if req.set_values:
            unknown = set(req.set_values) - set(
                sess.dcop.external_variables
            )
            if unknown:
                raise ServiceError(
                    f"set_values names {sorted(unknown)}, not external "
                    "variables of the session's dcop — session deltas "
                    "update externals only (structure changes need a "
                    "new session, docs/serving.md)"
                )
            sess.ext_values.update(req.set_values)
            sess.record_delta(req.set_values)
        module = _load_module(req.algo)
        if hasattr(module, "solve_host"):
            return self._solve_session_exact(req, sess, module)
        t_compile0 = time.perf_counter()
        req.dispatch_t = t_compile0
        problem, _fp = sess.compiler.compile({}, sess.ext_values)
        if problem is None:
            raise ServiceError(
                "session dcop has no live variables to solve"
            )
        sess.segments += 1
        run_timeout = None
        if req.timeout is not None:
            run_timeout = max(
                req.timeout - (time.perf_counter() - req.enqueue_t),
                0.01,
            )
        self._record_dispatch(1, 0)
        t_run0 = time.perf_counter()
        req.compile_s = t_run0 - t_compile0
        with trace_scope([req.trace_id]):
            with tr.span(
                "service.dispatch", cat="service", instances=1,
                padded=0, algo=req.algo, session=req.session,
                segment=sess.segments,
            ):
                result = run_batched(
                    problem,
                    module,
                    req.params,
                    rounds=req.rounds,
                    seed=req.seed,
                    timeout=run_timeout,
                    chunk_size=req.chunk_size,
                    convergence_chunks=req.convergence_chunks,
                    n_restarts=req.n_restarts,
                )
        t_done = time.perf_counter()
        req.device_s = t_done - t_run0
        req.decode_t0 = t_done
        out = _result_dict(result)
        out["session"] = req.session
        out["segment"] = sess.segments
        return out

    def _solve_session_exact(
        self, req: _Request, sess: _Session, module
    ) -> Dict[str, Any]:
        """Session dispatch for EXACT algorithms (the ``solve_host``
        modules).  DPOP follow-ups run through the memoized
        contraction session (``engine/memo.py``): ``set_values``
        re-tabulates only the touched constraints and the UTIL sweep
        re-contracts only the dirty root-to-changed-constraint path —
        every other node is a memo hit.  Other exact algos re-solve a
        pinned private clone.  The
        IncrementalCompiler device-table path is bypassed: exact
        sweeps consume host tables, which the exact session
        re-tabulates itself."""
        tr = get_tracer()
        t_compile0 = time.perf_counter()
        req.dispatch_t = t_compile0
        es = sess.exact.get(req.algo)
        if es is None:
            if req.algo == "dpop":
                from pydcop_tpu_torch.engine.memo import ExactSession

                es = ExactSession(
                    sess.dcop,
                    pad_policy=self.pad_policy,
                    memo_bytes=self.session_memo_bytes,
                    device=self.device,
                )
            else:
                es = _PlainExactSession(sess.dcop, module, self.device)
            sess.exact[req.algo] = es
        if sess.ext_values:
            es.set_values(sess.ext_values)
        try:
            sess.exact_params[req.algo] = json.loads(
                json.dumps(dict(req.params))
            )
        except (TypeError, ValueError):
            # non-JSON params: the session still serves, it just
            # cannot warm-replay through a checkpoint
            sess.exact_params.pop(req.algo, None)
        sess.segments += 1
        run_timeout = None
        if req.timeout is not None:
            run_timeout = max(
                req.timeout
                - (time.perf_counter() - req.enqueue_t),
                0.01,
            )
        self._record_dispatch(1, 0)
        t_run0 = time.perf_counter()
        req.compile_s = t_run0 - t_compile0
        with trace_scope([req.trace_id]):
            with tr.span(
                "service.dispatch", cat="service", instances=1,
                padded=0, algo=req.algo, session=req.session,
                segment=sess.segments,
            ):
                out = es.solve(req.params, timeout=run_timeout)
        t_done = time.perf_counter()
        req.device_s = t_done - t_run0
        req.decode_t0 = t_done
        out["session"] = req.session
        out["segment"] = sess.segments
        return out


class _PlainExactSession:
    """Pinned session state for exact algorithms WITHOUT a memoized
    sweep (syncbb): a private dcop clone whose externals follow the
    session's ``set_values`` stream; every solve is a full
    ``solve_host`` on the service's device."""

    def __init__(self, dcop, module, device) -> None:
        from pydcop_tpu_torch.engine.memo import _clone_dcop

        self.module = module
        self.device = device
        self.dcop = _clone_dcop(dcop)

    def set_values(self, values: Mapping[str, Any]) -> None:
        evs = self.dcop.external_variables
        for name, val in values.items():
            ev = evs.get(name)
            if ev is not None and ev.value != val:
                ev.value = val

    def solve(
        self,
        params: Optional[Mapping[str, Any]] = None,
        timeout: Optional[float] = None,
    ) -> Dict[str, Any]:
        return self.module.solve_host(
            self.dcop, dict(params or {}), timeout=timeout,
            device=self.device,
        )


def _load_module(algo_name: str):
    from pydcop_tpu_torch.algorithms import load_algorithm_module

    return load_algorithm_module(algo_name)


# ---------------------------------------------------------------------------
# wire protocol: newline-JSON frames (the JAX package's frames)
# ---------------------------------------------------------------------------
#
# request:  {"op": "solve", "id": N, "cid": client-id, "ikey":
#            idempotency-key, "algo": ..., "dcop": yaml-text | path,
#            "params": {...}, "rounds": ..., "seed": ...,
#            "session": ..., "set_values": {...}, ...}
#           {"op": "stats" | "ping" | "close_session" | "shutdown",
#            "id": N, ...}
# response: {"id": N, "ok": true, "result"|"stats"|...: ...}
#           {"id": N, "ok": false, "error": "..."}
#
# Solve frames PIPELINE: the server admits them asynchronously and
# replies (tagged with the request id) as results land, up to a
# per-connection in-flight cap — the wire-level backpressure knob;
# frames beyond the cap are answered immediately with
# status="shed".  A malformed or oversized frame gets a structured
# error reply and the connection STAYS OPEN (framing is
# newline-delimited, so the stream resyncs at the next newline).
#
# Idempotent retries: each solve frame carries an idempotency key
# ("ikey", stable across resends of the same logical request); the
# server remembers its last replies in a bounded cache, so a client
# that lost a connection AFTER the result was computed (the
# conn_drop chaos kind, or a real peer death) reconnects, resends,
# and is answered from the cache — never re-solved.

_SOLVE_FIELDS = (
    "rounds", "seed", "chunk_size", "convergence_chunks",
    "n_restarts", "timeout", "session", "set_values",
    "max_util_bytes", "bnb", "table_dtype", "table_format",
)

#: fields an ``op: "infer"`` frame may carry — mirrors
#: :meth:`SolverService.submit_infer` (the query itself rides the
#: frame's ``query`` field and joins the dispatch partition key)
_INFER_FIELDS = (
    "order", "beta", "tol", "device", "device_min_cells",
    "timeout", "map_vars", "external_dists", "max_util_bytes",
    "bnb", "table_dtype", "table_format",
)

#: results are trimmed for the wire: the per-round cost trace can be
#: orders of magnitude bigger than the answer
_WIRE_DROP = ("cost_trace", "restart_costs")

#: inbound frame size cap: big enough for any realistic shipped yaml,
#: small enough that one hostile (or corrupted) line cannot balloon a
#: handler's memory — oversized frames get a structured error reply
_MAX_FRAME_BYTES = 32 * 1024 * 1024

#: how long a reply send may block on a slow peer before the
#: connection is declared dead (send-only: receive stays unbounded so
#: idle keep-alive connections survive)
_SEND_TIMEOUT_S = 30


def _read_frame(reader):
    """One inbound frame from a buffered reader.

    Returns ``(msg, None)`` for a valid frame, ``(None, None)`` when
    the peer closed, and ``(None, error_text)`` for a malformed or
    oversized frame — the connection stays usable (newline framing
    resyncs at the next newline; oversized lines are drained first),
    so one bad frame costs its sender an error reply, not the
    connection and every pipelined request behind it."""
    try:
        line = reader.readline(_MAX_FRAME_BYTES + 1)
    except (OSError, ValueError):
        return None, None
    if not line:
        return None, None
    if not line.endswith(b"\n"):
        if len(line) > _MAX_FRAME_BYTES:
            # drain the rest of the oversized line so the stream
            # resyncs on the next newline
            while True:
                try:
                    chunk = reader.readline(_MAX_FRAME_BYTES)
                except (OSError, ValueError):
                    return None, None
                if not chunk or chunk.endswith(b"\n"):
                    break
            return None, (
                f"frame exceeds {_MAX_FRAME_BYTES} bytes"
            )
        return None, None  # EOF mid-frame: treat as closed
    try:
        msg = json.loads(line.decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        return None, f"malformed frame: {e}"
    if not isinstance(msg, dict):
        return None, "malformed frame: not a JSON object"
    return msg, None


def _corrupt_payload(payload: bytes) -> bytes:
    """The frame_corrupt chaos kind: invalid-UTF-8 garbage in place of
    the payload's head, framing (trailing newline, length) preserved —
    the receiving side's frame validation must reject it cleanly."""
    return b"\xff\xfe\xfd\xfc" + payload[4:]


#: outbound reply queue bound per connection: a peer that stops
#: reading while this many computed replies pile up is declared dead
#: (its results remain in the reply cache for a reconnect)
_MAX_QUEUED_REPLIES = 64


class _ConnState:
    """Per-connection server bookkeeping: the socket, the client's
    declared id (``cid``), the chaos scope (fresh per connection so
    retries re-roll their fault hashes), the per-connection reply
    sequence the wire fault decisions key on, the in-flight request
    count the backpressure cap reads, and the outbound reply queue a
    dedicated per-connection writer thread drains — result delivery
    (which runs on the tick worker) only ever ENQUEUES, so one
    stalled peer can never block dispatch for everyone else."""

    __slots__ = (
        "sock", "cid", "scope", "reply_seq", "flushed", "inflight",
        "lock", "cond", "outq", "alive",
    )

    def __init__(self, sock: socket.socket, scope: str) -> None:
        self.sock = sock
        self.cid: Optional[str] = None
        self.scope = scope
        self.reply_seq = 0
        self.flushed = 0  # highest reply seq actually sent
        self.inflight = 0
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)
        self.outq: deque = deque()
        self.alive = True

    def wait_flushed(self, timeout: float) -> None:
        """Block until every queued reply has been SENT (not just
        popped) or the connection dies — the ordering guarantee
        behind shutdown replies and handler teardown."""
        deadline = time.monotonic() + timeout
        with self.cond:
            while self.alive and (
                self.outq or self.flushed < self.reply_seq
            ):
                left = deadline - time.monotonic()
                if left <= 0:
                    return
                self.cond.wait(left)


class ServiceServer:
    """TCP front for a :class:`SolverService`: accepts connections,
    one handler thread per connection, newline-JSON frames.

    Hardened for the real world (docs/serving.md):

    - solve frames pipeline up to ``max_inflight`` per connection;
      frames beyond the cap are answered ``status="shed"`` instead of
      queueing unboundedly behind one socket;
    - malformed / oversized frames get a structured error reply and
      the connection survives;
    - solve replies are cached by idempotency key (bounded LRU,
      ``reply_cache`` entries), so a retry of a dropped-but-computed
      response replays the answer instead of re-solving;
    - the service's seeded :class:`~pydcop_tpu_torch.faults.plan.FaultPlan`
      wire kinds (``conn_drop``, ``slow_client``, ``frame_corrupt``)
      inject HERE, in the reply path — the serving loop's chaos seam.
    """

    def __init__(
        self,
        service: SolverService,
        host: str = "127.0.0.1",
        port: int = 0,
        max_inflight: int = 8,
        reply_cache: int = 512,
    ):
        if max_inflight < 1:
            raise ValueError(
                f"max_inflight must be >= 1, got {max_inflight}"
            )
        self.service = service
        self.max_inflight = max_inflight
        plan = service.chaos_plan
        self._plan = (
            plan
            if plan is not None and plan.wire_faults_configured
            else None
        )
        self._server = socket.create_server((host, port))
        self.address: Tuple[str, int] = (
            host, self._server.getsockname()[1]
        )
        self._shutdown = threading.Event()
        self._threads: List[threading.Thread] = []
        self._conns: List[socket.socket] = []
        self._states: List[_ConnState] = []  # for close-time flush
        self._lock = threading.Lock()
        self._conn_counter = 0
        # per-client-id connection ordinals (chaos scope freshness on
        # reconnect): bounded LRU like the reply cache — default
        # client ids are unique per client instance, so a resident
        # server would otherwise grow one entry per client EVER
        # served (an evicted cid that returns restarts at ordinal 1,
        # which only re-bases its fault hashes)
        self._cid_conns: "OrderedDict[str, int]" = OrderedDict()
        self._cid_conns_max = 4096
        self._replies: "OrderedDict[str, Dict[str, Any]]" = (
            OrderedDict()
        )
        self._reply_cache_max = reply_cache
        # idempotency keys whose solve is STILL RUNNING: a retry that
        # arrives before the reply cache is populated (client-side
        # timeout shorter than the solve, a slow_client hold) attaches
        # to the in-flight PendingResult instead of submitting a
        # duplicate solve — "never re-solved" covers the in-flight
        # window, not just completed replies
        self._inflight_ikeys: Dict[str, PendingResult] = {}
        # serializes SESSION-frame admission against the `replicate`
        # op: a primary's delta-log stream and the router's failover
        # re-forward arrive on two independent connections, so without
        # a common lock the re-forward's reply-cache check can run
        # BEFORE the replicated {entry + piggybacked reply} applies
        # while its submit runs AFTER — promoting the fresh standby
        # copy and re-executing an already-answered segment.  Held
        # around {apply entry + cache insert} on one side and
        # {cache re-check + submit} on the other; stateless frames
        # never take it.
        self._replica_admission = threading.Lock()
        self._accept = threading.Thread(
            target=self._accept_loop, name="solver-service-accept",
            daemon=True,
        )
        self._accept.start()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until :meth:`close` / a ``shutdown`` op / a SIGTERM
        relayed through :meth:`request_shutdown` (or the timeout);
        returns True when shut down."""
        return self._shutdown.wait(timeout)

    def inflight(self) -> int:
        """Wire-level in-flight request count across all connections
        (the ``/healthz`` ``inflight`` field)."""
        with self._lock:
            states = list(self._states)
        total = 0
        for st in states:
            with st.lock:
                total += st.inflight
        return total

    def request_shutdown(self) -> None:
        """Ask the serve loop to stop (signal-handler safe: only sets
        an event — the thread blocked in :meth:`wait` does the actual
        teardown, so the graceful drain never runs inside a signal
        handler)."""
        self._shutdown.set()

    def close(self) -> None:
        self._shutdown.set()
        try:
            self._server.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns)
            states = list(self._states)
            threads = list(self._threads)
        # flush before destroying: replies computed during a graceful
        # drain sit in per-connection writer queues — tearing the
        # sockets down first would silently drop them, breaking the
        # "finish and deliver" drain contract.  One shared deadline
        # bounds the whole flush (a genuinely stalled peer forfeits
        # its tail, as always).
        deadline = time.monotonic() + 5.0
        for st in states:
            st.wait_flushed(max(0.0, deadline - time.monotonic()))
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        for t in threads:
            t.join(timeout=5)

    def __enter__(self) -> "ServiceServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _accept_loop(self) -> None:
        while not self._shutdown.is_set():
            try:
                conn, _addr = self._server.accept()
            except OSError:
                return  # closed
            with self._lock:
                self._conns.append(conn)
            t = threading.Thread(
                target=self._handle, args=(conn,),
                name="solver-service-conn", daemon=True,
            )
            with self._lock:
                self._threads.append(t)
            t.start()

    def _handle(self, conn: socket.socket) -> None:
        try:
            # send-only timeout: the writer must not park forever on
            # a dead peer the TCP stack hasn't noticed; receives stay
            # unbounded so idle keep-alive connections survive
            import struct

            conn.setsockopt(
                socket.SOL_SOCKET, socket.SO_SNDTIMEO,
                struct.pack("ll", _SEND_TIMEOUT_S, 0),
            )
        except (OSError, AttributeError):
            pass
        with self._lock:
            self._conn_counter += 1
            idx = self._conn_counter
        st = _ConnState(conn, scope=f"conn{idx}")
        with self._lock:
            self._states.append(st)
        writer = threading.Thread(
            target=self._writer_loop, args=(st,),
            name="solver-service-writer", daemon=True,
        )
        writer.start()
        reader = conn.makefile("rb")
        try:
            while not self._shutdown.is_set():
                msg, err = _read_frame(reader)
                if msg is None and err is None:
                    return  # peer closed
                if err is not None:
                    self.service.note_frame_rejected()
                    if not self._reply(
                        st,
                        {
                            "id": None,
                            "ok": False,
                            "error": err,
                            "frame_rejected": True,
                        },
                    ):
                        return
                    continue
                cid = msg.get("cid")
                if cid is not None and st.cid is None:
                    st.cid = str(cid)
                    with self._lock:
                        k = self._cid_conns.get(st.cid, 0) + 1
                        self._cid_conns[st.cid] = k
                        self._cid_conns.move_to_end(st.cid)
                        while (
                            len(self._cid_conns)
                            > self._cid_conns_max
                        ):
                            self._cid_conns.popitem(last=False)
                    # scope = (client id, connection ordinal): fault
                    # hashes re-roll on reconnect, replay identically
                    # for the same seed + client behavior
                    st.scope = f"{st.cid}/{k}"
                if msg.get("op") in ("solve", "infer"):
                    self._handle_solve(st, msg)
                    continue
                rid = msg.get("id")
                ikey = msg.get("ikey")
                cached = None
                if ikey is not None:
                    with self._lock:
                        cached = self._replies.get(ikey)
                        if cached is not None:
                            self._replies.move_to_end(ikey)
                if cached is not None:
                    # a retried non-solve op whose ack was lost: the
                    # op already EXECUTED (e.g. close_session popped
                    # its session) — replay the original reply
                    # instead of re-executing and reporting a
                    # different answer
                    self.service.note_replayed_reply()
                    reply = dict(cached)
                else:
                    try:
                        reply = self._serve_op(msg)
                    except Exception as e:  # noqa: BLE001
                        reply = {
                            "ok": False,
                            "error": f"{type(e).__name__}: {e}",
                        }
                    if ikey is not None:
                        self._cache_reply(ikey, reply)
                reply["id"] = rid
                if not self._reply(st, reply):
                    return
                if msg.get("op") == "shutdown":
                    # flush the acknowledgement BEFORE flipping the
                    # shutdown event: teardown races the writer
                    # otherwise and the client would see a reset from
                    # a shutdown that succeeded
                    st.wait_flushed(5.0)
                    self._shutdown.set()
                    return
        finally:
            # give the writer a bounded window to flush what is
            # already queued (a final reply, an error), then signal
            # it down; on an idle close this is instant
            st.wait_flushed(5.0)
            with st.cond:
                st.alive = False
                st.cond.notify_all()
            writer.join(timeout=_SEND_TIMEOUT_S + 1)
            try:
                reader.close()
                conn.close()
            except OSError:
                pass
            # "concurrency is connections" means a resident server
            # sees millions of short-lived ones: drop this handler's
            # bookkeeping or _conns/_threads grow without bound
            with self._lock:
                try:
                    self._conns.remove(conn)
                except ValueError:
                    pass
                try:
                    self._states.remove(st)
                except ValueError:
                    pass
                try:
                    self._threads.remove(threading.current_thread())
                except ValueError:
                    pass

    # -- the reply path (where wire chaos injects) -----------------------

    def _reply(self, st: _ConnState, obj: Dict[str, Any]) -> bool:
        """Enqueue one reply frame for the connection's writer thread;
        returns False when the connection is gone.  Never blocks on
        the peer: result delivery runs on the tick worker, and a
        stalled client must cost only ITS connection, not a tick.  A
        peer that stops reading while the bounded queue fills is
        declared dead (the computed results stay in the reply cache
        for its reconnect).  Serialization happens on the WRITER
        thread too — a tick of large results must not pay
        ``json.dumps`` serially on the dispatch hot path."""
        overflow = False
        with st.cond:
            if not st.alive:
                return False
            if len(st.outq) >= _MAX_QUEUED_REPLIES:
                overflow = True
            else:
                st.outq.append(obj)
                st.cond.notify_all()
        if overflow:
            # actually disconnect the stalled peer (outside the cond:
            # _drop_conn re-acquires it) — just marking it dead would
            # leave the handler parked in readline forever and the
            # peer never learning it was dropped
            self._drop_conn(st)
            return False
        return True

    def _writer_loop(self, st: _ConnState) -> None:
        """Drain one connection's reply queue onto its socket.  The
        seeded wire fault kinds act here, in dequeue order (single
        writer, so the per-connection reply sequence the decisions
        key on is deterministic): ``slow_client`` holds the frame,
        ``frame_corrupt`` mangles its bytes (framing intact),
        ``conn_drop`` closes the socket instead of sending — the
        computed result stays in the reply cache for the client's
        idempotent retry."""
        plan = self._plan
        while True:
            with st.cond:
                while st.alive and not st.outq:
                    st.cond.wait()
                if not st.outq:
                    return  # closed and drained
                obj = st.outq.popleft()
                st.reply_seq += 1
                seq = st.reply_seq
                # a closing handler may be waiting for the drain
                st.cond.notify_all()
            payload = (json.dumps(obj) + "\n").encode("utf-8")
            if plan is not None:
                w = plan.wire
                if w.slow_client:
                    self._fault("slow_client", st.scope, seq, plan)
                    time.sleep(w.slow_client)
                if plan.decide_conn_drop(st.scope, seq):
                    self._fault("conn_drop", st.scope, seq, plan)
                    self._drop_conn(st)
                    return
                if plan.decide_frame_corrupt(st.scope, seq):
                    self._fault("frame_corrupt", st.scope, seq, plan)
                    payload = _corrupt_payload(payload)
            try:
                st.sock.sendall(payload)
            except (OSError, ValueError):
                with st.cond:
                    st.alive = False
                    st.cond.notify_all()
                return
            with st.cond:
                st.flushed = seq
                st.cond.notify_all()

    @staticmethod
    def _drop_conn(st: _ConnState) -> None:
        with st.cond:
            st.alive = False
            st.cond.notify_all()  # wake the writer so it exits
        try:
            # shutdown, not just close: the handler's makefile reader
            # still references the fd, so close() alone would leave
            # the wire open and neither end would ever see the drop
            st.sock.shutdown(socket.SHUT_RDWR)
            st.sock.close()
        except OSError:
            pass

    @staticmethod
    def _fault(kind: str, scope: str, seq: int, plan) -> None:
        met = get_metrics()
        tr = get_tracer()
        if met.enabled:
            met.inc(f"fault.{kind}")
        if tr.enabled:
            # conn=, not link=: trace-summary derives per-AGENT rows
            # from `link` args, and a connection scope is not an
            # agent — thousands of reconnecting clients would
            # otherwise drown the agent table in fake rows
            tr.event(
                kind, cat="fault", conn=scope, seq=seq,
                seed=plan.seed,
            )

    # -- ops -------------------------------------------------------------

    def _cache_reply(self, ikey: str, reply: Dict[str, Any]) -> None:
        """The one bounded-LRU reply-cache insert (solve and non-solve
        paths share it, so idempotency semantics cannot drift between
        them)."""
        with self._lock:
            self._replies[ikey] = dict(reply)
            self._replies.move_to_end(ikey)
            while len(self._replies) > self._reply_cache_max:
                self._replies.popitem(last=False)

    def _note_replay(self, msg: Dict[str, Any]) -> None:
        """One replayed reply: count it, and put a trace-tagged event
        on the timeline so `trace-summary --requests` stitches the
        retry attempt back to the ORIGINAL server spans instead of
        showing a gap (or inventing a phantom re-solve)."""
        self.service.note_replayed_reply()
        tr = get_tracer()
        if tr.enabled:
            wt = parse_wire_trace(msg.get("trace"))
            tr.event(
                "service-replay", cat="service",
                trace=wt[0] if wt else None,
                attempt=wt[2] if wt else None,
            )

    def _handle_solve(self, st: _ConnState, msg: Dict[str, Any]) -> None:
        rid = msg.get("id")
        ikey = msg.get("ikey")
        cached = None
        pending: Optional[PendingResult] = None
        if ikey is not None:
            # ONE lock acquisition over both lookups: deliver's
            # critical section (cache insert + in-flight unregister)
            # is atomic under the same lock, so a retry racing the
            # original's completion hits exactly one of the two —
            # checking them separately would leave a window where it
            # misses both and re-solves
            with self._lock:
                cached = self._replies.get(ikey)
                if cached is not None:
                    self._replies.move_to_end(ikey)
                else:
                    pending = self._inflight_ikeys.get(ikey)
        if cached is not None:
            # a retry of a computed-but-lost response: answer from
            # the bounded reply cache, never re-solve
            self._note_replay(msg)
            self._reply(st, {**cached, "id": rid})
            return
        with st.lock:
            over_cap = st.inflight >= self.max_inflight
            if not over_cap:
                st.inflight += 1
        if over_cap:
            # per-connection backpressure: a pipelining client past
            # its cap is shed immediately, not queued unboundedly
            self.service.note_shed("inflight-cap")
            self._reply(
                st,
                {
                    "id": rid,
                    "ok": True,
                    "result": {
                        "status": "shed",
                        # machine-readable token, like queue-full /
                        # deadline — clients dispatch on it
                        "shed_reason": "inflight-cap",
                        "max_inflight": self.max_inflight,
                    },
                },
            )
            return
        # a retry racing its original: the first frame's solve is
        # still in flight — attach this connection to it instead of
        # submitting a duplicate ("never re-solved" must cover the
        # in-flight window too, or a client timeout shorter than the
        # solve would burn a dispatch slot per retry and re-apply
        # session deltas)
        if pending is not None:
            self._note_replay(msg)
        else:
            pending = self._admit_and_submit(st, msg, rid, ikey)
            if pending is None:
                # already replied (a replicated-reply replay or a
                # validation error)
                return

        def deliver(p: PendingResult) -> None:
            with st.lock:
                st.inflight -= 1
            t_del0 = time.perf_counter()
            try:
                result = p.result(0)
                reply = {
                    "ok": True,
                    "result": {
                        k: v
                        for k, v in result.items()
                        if k not in _WIRE_DROP
                    },
                }
                # the last phase segment: terminal result -> reply
                # handed to the connection writer.  Serialization and
                # the socket send run after this frame leaves the
                # server's attribution window — the remaining gap in
                # a client-measured latency is wire time.
                phases = reply["result"].get("phases")
                if isinstance(phases, dict):
                    phases["reply_write"] = round(
                        time.perf_counter() - t_del0, 6
                    )
            except Exception as e:  # noqa: BLE001 — the error IS
                # the reply
                reply = {
                    "ok": False,
                    "error": f"{type(e).__name__}: {e}",
                }
            if ikey is not None:
                self._cache_reply(ikey, reply)
                with self._lock:
                    # cache first, THEN unregister: a retry arriving
                    # in between sees the cached reply
                    if self._inflight_ikeys.get(ikey) is p:
                        del self._inflight_ikeys[ikey]
            session = msg.get("session")
            if (
                session is not None
                and reply.get("ok")
                and (reply.get("result") or {}).get("status")
                != "shed"
            ):
                # replicate BEFORE the reply leaves: once the client
                # can observe this answer, the session state behind
                # it — and the cached reply a failover retry will ask
                # for — already lives on the standby chain
                self.service.replicate_session(
                    str(session),
                    cache=(
                        {"ikey": ikey, "reply": reply}
                        if ikey is not None
                        else None
                    ),
                )
            self._reply(st, {**reply, "id": rid})

        pending.add_done_callback(deliver)

    def _admit_and_submit(
        self,
        st: _ConnState,
        msg: Dict[str, Any],
        rid: Any,
        ikey: Optional[str],
    ) -> Optional[PendingResult]:
        """Admission past the caches: register the in-flight
        placeholder and submit.  Returns the PendingResult to deliver
        from, or None when this frame was already replied to here.

        Session frames run under ``_replica_admission``, serialized
        against the ``replicate`` op: a primary's final delta-log
        frame and the router's failover re-forward of the request
        that produced it arrive on two independent connections, so
        the piggybacked reply can land between `_handle_solve`'s
        first cache check and the submit — the re-check under the
        SHARED lock either replays it or commits to executing first
        (in which case the late entry parks as an inert standby copy
        and the identical piggybacked reply overwrites nothing)."""
        admission = (
            self._replica_admission
            if msg.get("session") is not None
            else None
        )
        if admission is not None:
            admission.acquire()
        try:
            if admission is not None and ikey is not None:
                with self._lock:
                    cached = self._replies.get(ikey)
                    if cached is not None:
                        self._replies.move_to_end(ikey)
                if cached is not None:
                    with st.lock:
                        st.inflight -= 1
                    self._note_replay(msg)
                    self._reply(st, {**cached, "id": rid})
                    return None
            placeholder: Optional[PendingResult] = None
            pending: Optional[PendingResult] = None
            if ikey is not None:
                # register a placeholder BEFORE submit: admission
                # itself can be slow (parsing a shipped yaml), and a
                # retry landing during it must attach here instead of
                # double-submitting.  The re-check closes the race
                # with another handler doing the same.
                placeholder = PendingResult()
                with self._lock:
                    existing = self._inflight_ikeys.get(ikey)
                    if existing is not None:
                        pending = existing
                        placeholder = None
                    else:
                        self._inflight_ikeys[ikey] = placeholder
            if pending is not None:
                self._note_replay(msg)
                return pending
            try:
                if msg.get("op") == "infer":
                    kwargs = {
                        k: msg[k]
                        for k in _INFER_FIELDS
                        if msg.get(k) is not None
                    }
                    real = self.service.submit_infer(
                        msg.get("dcop"),
                        msg.get("query", "marginals"),
                        trace=msg.get("trace"),
                        **kwargs,
                    )
                else:
                    kwargs = {
                        k: msg[k]
                        for k in _SOLVE_FIELDS
                        if msg.get(k) is not None
                    }
                    real = self.service.submit(
                        msg.get("dcop"),
                        msg.get("algo"),
                        msg.get("params") or None,
                        trace=msg.get("trace"),
                        **kwargs,
                    )
            except Exception as e:  # noqa: BLE001 — per-request
                if placeholder is not None:
                    # resolve attached retries with the SAME
                    # validation error, then unregister (errors
                    # are cheap to recompute, so no cache entry)
                    placeholder._set_error(
                        ServiceError(
                            f"{type(e).__name__}: {e}"
                        )
                    )
                    with self._lock:
                        if (
                            self._inflight_ikeys.get(ikey)
                            is placeholder
                        ):
                            del self._inflight_ikeys[ikey]
                with st.lock:
                    st.inflight -= 1
                self._reply(
                    st,
                    {
                        "id": rid,
                        "ok": False,
                        "error": f"{type(e).__name__}: {e}",
                    },
                )
                return None
            if placeholder is not None:
                # the placeholder IS the canonical in-flight
                # handle: mirror the real result into it
                ph = placeholder

                def _mirror(p: PendingResult) -> None:
                    if p._error is not None:
                        ph._set_error(p._error)
                    else:
                        ph._set_result(p._result)

                real.add_done_callback(_mirror)
                return ph
            return real
        finally:
            if admission is not None:
                admission.release()

    def _serve_op(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        op = msg.get("op")
        if op == "ping":
            return {"ok": True, "pong": True}
        if op == "stats":
            return {"ok": True, "stats": self.service.stats()}
        if op == "close_session":
            name = msg.get("session", "")
            closed = self.service.close_session(name)
            if closed:
                # stream the tombstone so the standby chain drops its
                # copy — a closed session must not fail over
                self.service.replicate_session(str(name))
            return {"ok": True, "closed": closed}
        if op == "replicate":
            entry = msg.get("entry")
            if not isinstance(entry, dict):
                raise ServiceError(
                    "replicate needs entry={session entry} "
                    "(docs/serving.md, 'The fleet')"
                )
            with self._replica_admission:
                # entry + piggybacked reply become visible atomically
                # w.r.t. session admission (_admit_and_submit): a
                # failover re-forward racing this frame either sees
                # both (replays) or neither (executes first)
                info = self.service.apply_replica_entry(entry)
                cache = msg.get("cache")
                if isinstance(cache, dict) and cache.get("ikey"):
                    # the primary's delivered reply rides along: cache
                    # it HERE so a failover retry of an answered
                    # request replays instead of re-solving
                    # (exactly-once)
                    replayed = dict(cache.get("reply") or {})
                    replayed.pop("id", None)
                    self._cache_reply(str(cache["ikey"]), replayed)
            return {"ok": True, "replicated": True, **info}
        if op == "standby":
            addrs = msg.get("standbys")
            if not isinstance(addrs, list) or not all(
                isinstance(a, str) for a in addrs
            ):
                raise ServiceError(
                    "standby needs standbys=[\"host:port\", ...] "
                    "(docs/serving.md, 'The fleet')"
                )
            streamed = self.service.set_standbys(addrs)
            return {
                "ok": True,
                "standbys": list(addrs),
                "streamed": streamed,
            }
        if op == "shutdown":
            return {"ok": True, "stopping": True}
        raise ServiceError(f"unknown op {op!r}")


#: per-process ordinal for default client ids (unique within the
#: process; combined with the pid for cross-process uniqueness)
_CLIENT_ORDINAL = [0]
_CLIENT_ORDINAL_LOCK = threading.Lock()


def _send(conn: socket.socket, obj: Dict[str, Any]) -> None:
    """One frame out: a JSON object and a newline, UTF-8."""
    conn.sendall((json.dumps(obj) + "\n").encode("utf-8"))


def _next_client_id() -> str:
    with _CLIENT_ORDINAL_LOCK:
        _CLIENT_ORDINAL[0] += 1
        n = _CLIENT_ORDINAL[0]
    return f"c{os.getpid():x}-{n}"


class ServiceClient:
    """Thin blocking client for a :class:`ServiceServer` (also
    exported as ``pydcop_tpu_torch.api.ServiceClient``; it imports
    without torch, and talks to either package's server).

    One request in flight at a time per client; open more clients for
    concurrency — concurrent clients are exactly what the service
    coalesces.  ``dcop`` arguments that name an existing file are
    read and shipped as yaml text, so the server needs no shared
    filesystem.

    Resilient by default: a dropped connection or a corrupt reply
    frame triggers keyed-backoff reconnect (``utils/backoff.py`` —
    jitter is a pure hash of ``(client id, attempt)``, so chaos
    replays reproduce retry timing) for up to ``retry_window``
    seconds, resending the SAME frame.  Every solve frame carries an
    idempotency key, so a retry of a request whose response was
    computed-but-lost is answered from the server's reply cache,
    never re-solved.  ``retry_window=0`` disables retries (failures
    surface as :class:`ServiceError` immediately).  Retries are
    counted on ``service.client_retries``.
    """

    def __init__(
        self,
        address: Union[str, Tuple[str, int]],
        timeout: Optional[float] = None,
        *,
        client_id: Optional[str] = None,
        retry_window: float = 5.0,
        backoff_seed: int = 0,
    ):
        if isinstance(address, str):
            host, _, port = address.rpartition(":")
            address = (host or "127.0.0.1", int(port))
        self._address: Tuple[str, int] = address
        self._timeout = timeout
        self.client_id = client_id or _next_client_id()
        self.retry_window = retry_window
        self._backoff_seed = backoff_seed
        self._lock = threading.Lock()
        self._next_id = 0
        self._closed = False
        # idempotency keys must be unique per logical request across
        # client LIFETIMES, not just within one: request ids restart
        # at 1 per instance, so a reused client_id (explicit, or a
        # recycled pid in the default) would otherwise collide with a
        # previous life's keys and replay ITS cached replies.  The
        # nonce scopes the keys to this instance; chaos scopes key on
        # client_id alone, so determinism is untouched.
        # graftlint: allow[impure-call] — entropy is the point here
        self._ikey_nonce = os.urandom(4).hex()
        self._sock: Optional[socket.socket] = None
        self._reader = None
        self._connect()  # fail fast on a dead address

    def _connect(self) -> None:
        self._sock = socket.create_connection(
            self._address, timeout=self._timeout
        )
        self._reader = self._sock.makefile("rb")

    def _teardown(self) -> None:
        try:
            if self._reader is not None:
                self._reader.close()
            if self._sock is not None:
                self._sock.close()
        except OSError:
            pass
        self._reader = None
        self._sock = None

    def _recv_checked(self, reader) -> Dict[str, Any]:
        """One reply frame through the SAME validation the server
        applies inbound (:func:`_read_frame` — one definition of the
        framing rules, not two drifting copies), raising instead of
        returning error tuples: a closed stream raises
        ConnectionError, an oversized / truncated / non-JSON /
        non-object frame raises ValueError.  Both are retryable (the
        frame_corrupt chaos kind lands here)."""
        reply, err = _read_frame(reader)
        if err is not None:
            if err.startswith("frame exceeds"):
                # unlike a chaos-corrupted frame, an OVERSIZED reply
                # is deterministic — every retry replays the same
                # frame from the server's cache — so retrying can
                # only burn the window before failing anyway
                raise ServiceError(f"reply {err}")
            raise ValueError(err)
        if reply is None:
            raise ConnectionError(
                "service connection closed mid-request"
            )
        return reply

    def _attempt(self, frame: Dict[str, Any]) -> Dict[str, Any]:
        if self._closed:
            # close() must WIN against an in-flight call's retry
            # loop — reconnecting a client the user just closed would
            # resurrect the socket for up to retry_window seconds
            raise ServiceError("client is closed")
        if self._sock is None:
            self._connect()
        # locals, not self._sock/_reader: a concurrent close() nulls
        # the attributes mid-attempt, and None.sendall would escape
        # the (OSError, ValueError) retry contract as AttributeError
        # — the closed file objects raise the RIGHT exceptions, and
        # the retry's _closed check then aborts cleanly
        sock, reader = self._sock, self._reader
        try:
            _send(sock, frame)
            while True:
                reply = self._recv_checked(reader)
                if reply.get("id") == frame["id"]:
                    return reply
                if (
                    reply.get("id") is None
                    and reply.get("frame_rejected")
                ):
                    # the server rejected OUR frame (malformed /
                    # oversized) — with one request in flight per
                    # connection it unambiguously belongs to this
                    # request, and resending the same frame can only
                    # be rejected again: surface, don't retry
                    raise ServiceError(
                        "server rejected the request frame: "
                        f"{reply.get('error')}"
                    )
        except (OSError, ValueError):
            # leave no half-read stream behind: the retry reconnects
            self._teardown()
            raise

    def _send(
        self, one_attempt: Callable[[], Dict[str, Any]], what: str
    ) -> Dict[str, Any]:
        """Run ``one_attempt`` once, or under the keyed-backoff retry
        loop for up to :attr:`retry_window` seconds (each retry counted
        as ``service.client_retries``); a transport failure raises
        :class:`ServiceTransportError` worded after ``what``."""
        from pydcop_tpu_torch.utils.backoff import (
            RETRY_BASE,
            RETRY_EXCEPTIONS,
            RETRY_FACTOR,
            RETRY_JITTER,
            RETRY_MAX_DELAY,
            call_with_backoff,
        )

        if self.retry_window <= 0:
            try:
                return one_attempt()
            except RETRY_EXCEPTIONS as e:
                raise ServiceTransportError(
                    f"{what} failed: {type(e).__name__}: {e}"
                ) from e
        met = get_metrics()

        def _note_retry(attempt: int, error: BaseException):
            if met.enabled:
                met.inc("service.client_retries")

        try:
            return call_with_backoff(
                one_attempt,
                retry_for=self.retry_window,
                exceptions=RETRY_EXCEPTIONS,
                base=RETRY_BASE,
                factor=RETRY_FACTOR,
                max_delay=RETRY_MAX_DELAY,
                jitter=RETRY_JITTER,
                key=f"service-client/{self.client_id}",
                seed=self._backoff_seed,
                on_retry=_note_retry,
                giving_up=lambda: self._closed,
            )
        except RETRY_EXCEPTIONS as e:
            raise ServiceTransportError(
                f"{what} failed after {self.retry_window}s of retries: "
                f"{type(e).__name__}: {e}"
            ) from e

    def _call(self, op: str, **fields) -> Dict[str, Any]:
        with self._lock:
            self._next_id += 1
            rid = self._next_id
            frame = {
                "op": op, "id": rid, "cid": self.client_id, **fields,
            }
            tid: Optional[str] = None
            attempts = [0]
            if op not in ("ping", "stats"):
                # stable across resends of this frame — the server's
                # reply-cache dedupe key.  Solves AND state-mutating
                # ops (close_session) need it: a retried
                # close_session whose ack was lost would otherwise
                # re-execute and report closed=False for a session
                # that WAS closed.  ping/stats are read-only and
                # should return fresh data on retry.
                frame["ikey"] = (
                    f"{self.client_id}:{self._ikey_nonce}:{rid}"
                )
                # the request trace id rides next to the idempotency
                # key: stable across resends (so a replayed reply
                # stitches to the ORIGINAL server spans), pure in
                # (client id, request ordinal) so chaos replays
                # produce identical stitched timelines
                # (telemetry/context.py)
                tid = mint_trace_id(self.client_id, rid)

            def _one_attempt() -> Dict[str, Any]:
                if tid is None:
                    return self._attempt(frame)
                attempts[0] += 1
                frame["trace"] = wire_trace(tid, attempts[0])
                tr = get_tracer()
                t0 = time.perf_counter()
                status = "ok"
                try:
                    return self._attempt(frame)
                except BaseException as e:
                    status = type(e).__name__
                    raise
                finally:
                    if tr.enabled:
                        tr.add_span(
                            "client.attempt", "service", t0,
                            time.perf_counter() - t0, trace=tid,
                            span=frame["trace"]["span"],
                            attempt=attempts[0], op=op,
                            status=status,
                        )

            t_req0 = time.perf_counter()
            req_status = "error"
            try:
                reply = self._send(_one_attempt, "service request")
                if reply.get("ok"):
                    req_status = str(
                        (reply.get("result") or {}).get(
                            "status", "ok"
                        )
                    )
            finally:
                # the whole-request span: its dur IS the
                # client-measured end-to-end latency the reply's
                # phase breakdown is judged against
                if tid is not None:
                    tr = get_tracer()
                    if tr.enabled:
                        tr.add_span(
                            "client.request", "service", t_req0,
                            time.perf_counter() - t_req0, trace=tid,
                            op=op, attempts=attempts[0],
                            status=req_status,
                        )
        if not reply.get("ok"):
            raise ServiceError(
                reply.get("error", "service request failed")
            )
        return reply

    def forward(
        self, frame: Mapping[str, Any]
    ) -> Dict[str, Any]:
        """Forward a received wire frame downstream — the fleet
        router's primitive (``engine/fleet.py``).  Only the
        wire-local ``id`` is rewritten; the ORIGINAL client's ``cid``,
        idempotency key and trace context ride through untouched, so
        the downstream reply cache dedupes on the END CLIENT's key (a
        failover re-forward of an answered request replays instead of
        re-solving) and the trace stitches across the hop.  Runs the
        same keyed-backoff retry loop as :meth:`_call`; a structured
        ``ok: false`` reply is RETURNED (the router relays it
        verbatim), only transport failure raises
        :class:`ServiceTransportError`."""
        with self._lock:
            self._next_id += 1
            fwd = dict(frame)
            fwd["id"] = self._next_id
            reply = self._send(lambda: self._attempt(fwd), "forward")
        out = dict(reply)
        out.pop("id", None)
        return out

    def solve(
        self,
        dcop: Optional[str] = None,
        algo: Optional[str] = None,
        params: Optional[Mapping[str, Any]] = None,
        **kwargs,
    ) -> Dict[str, Any]:
        """Solve over the wire; kwargs mirror
        :meth:`SolverService.submit` (rounds, seed, chunk_size,
        convergence_chunks, n_restarts, timeout, session,
        set_values)."""
        unknown = set(kwargs) - set(_SOLVE_FIELDS)
        if unknown:
            raise ValueError(
                f"unknown solve field(s) {sorted(unknown)}; the wire "
                f"protocol accepts {_SOLVE_FIELDS}"
            )
        if (
            isinstance(dcop, str)
            and "\n" not in dcop
            and os.path.isfile(dcop)
        ):
            with open(dcop, encoding="utf-8") as f:
                dcop = f.read()
        reply = self._call(
            "solve", dcop=dcop, algo=algo,
            params=dict(params) if params else None, **kwargs,
        )
        return reply["result"]

    def infer(
        self,
        dcop: Optional[str] = None,
        query: str = "marginals",
        **kwargs,
    ) -> Dict[str, Any]:
        """Inference over the wire; kwargs mirror
        :meth:`SolverService.submit_infer` (order, beta, tol, device,
        device_min_cells, timeout, map_vars, external_dists,
        max_util_bytes).  Mixed-query clients coalesce per query in
        the service's ticks."""
        unknown = set(kwargs) - set(_INFER_FIELDS)
        if unknown:
            raise ValueError(
                f"unknown infer field(s) {sorted(unknown)}; the wire "
                f"protocol accepts {_INFER_FIELDS}"
            )
        if (
            isinstance(dcop, str)
            and "\n" not in dcop
            and os.path.isfile(dcop)
        ):
            with open(dcop, encoding="utf-8") as f:
                dcop = f.read()
        reply = self._call(
            "infer", dcop=dcop, query=query, **kwargs,
        )
        return reply["result"]

    def stats(self) -> Dict[str, Any]:
        return self._call("stats")["stats"]

    def ping(self) -> bool:
        return bool(self._call("ping").get("pong"))

    def close_session(self, name: str) -> bool:
        return bool(
            self._call("close_session", session=name).get("closed")
        )

    def shutdown(self) -> None:
        """Ask the server process to stop serving.  Best-effort by
        nature: a transport failure counts as success, because a
        shutdown that WORKED kills the address the retry loop would
        need — the idempotent resend (shutdown frames do carry a key)
        can only bang on a dead listener until the window expires and
        surface a spurious error.  Only a structured server-side
        refusal raises."""
        try:
            self._call("shutdown")
        except ServiceTransportError:
            pass

    def close(self) -> None:
        # flag first, no lock: an in-flight call holds the client
        # lock for its whole request — close() aborts its retry loop
        # via the flag/giving_up instead of waiting it out
        self._closed = True
        self._teardown()

    def __enter__(self) -> "ServiceClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
