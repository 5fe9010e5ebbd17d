"""Seeded, fully deterministic fault plans (a copy of
``pydcop_tpu/faults/plan.py``, which imports no jax: the port keeps its
own copy rather than importing the JAX package).

The whole module is kept, so ``FaultPlan.from_spec`` parses every kind
and a plan's decisions are the JAX package's bit for bit.  The port
injects only the device-layer kinds (``device_oom``,
``device_transient``, ``nan_inject``, at ``engine/supervisor.py``);
``api.solve``/``solve_many`` reject the message-plane, wire and fleet
kinds with the JAX package's words.  The other modules named below are
the JAX package's.


A :class:`FaultPlan` answers, for every outbound message on a directed
agent link, "what happens to this one?" — and answers it identically
on every run with the same seed: each decision is a pure hash of
``(seed, link, per-link message sequence number, fault kind)``.  No
wall-clock, no RNG stream shared across threads, no iteration-order
dependence — the properties that make a fault sequence replayable.

Plans are built programmatically or parsed from the compact
``--chaos`` spec string (see :meth:`FaultPlan.from_spec`)::

    drop=0.05,dup=0.02,reorder=0.1,delay=0.1:0.05,
    a1>a2:drop=0.5,partition=a1-a2@0.5+2,crash=a3@1.5

- bare ``key=value`` clauses set the DEFAULT probabilities for every
  link; ``SRC>DST:key=value`` overrides one directed link and
  ``A-B:key=value`` both directions;
- ``delay=P:S`` delays a message by ``S`` seconds with probability
  ``P``;
- ``partition=A-B@START+DURATION`` blocks the link(s) between ``A``
  and ``B`` (``A-*``: every link touching ``A``; ``A>B``: one
  direction) from ``START`` seconds into the run for ``DURATION``
  seconds — messages are HELD and released at heal time, unless the
  outage outlives the tolerance grace window (then the link is
  declared dead, the permanent-failure path);
- ``crash=AGENT@T`` hard-kills the agent's process ``T`` seconds into
  the run (the scripted analogue of SIGKILL, for exercising the
  replication/repair machinery on demand).

Device-layer fault kinds (below the message plane; injected at the
supervised-dispatch seam of ``engine/supervisor.py``, same
``--chaos SPEC --chaos_seed N`` contract):

- ``device_oom=W`` / ``device_oom=W:R`` — every device dispatch whose
  *width* (vmapped instance lanes × restarts, or a DPOP level-stack
  height) exceeds ``W`` raises ``RESOURCE_EXHAUSTED`` (``W='-'``: no
  width cap); with ``:R``, dispatches covering more than ``R`` rounds
  OOM too.  A capacity model, not a coin flip: it is what makes the
  supervisor's degradation ladder (halve chunks, split groups)
  *converge* — once a dispatch fits the injected capacity it succeeds,
  exactly like real HBM.
- ``device_oom_bytes=N`` — every device dispatch whose PER-LANE
  joined table exceeds ``N`` bytes raises ``RESOURCE_EXHAUSTED``.
  The capacity model for the width-EXPONENTIAL dimension: the
  memory-bounded sweeps (``ops/membound.py``) answer it by
  re-planning at half their ``max_util_bytes`` budget
  (``membound.replans``), converging the moment the planned tables
  fit; dispatches that report no table size (the batched hot loops)
  are exempt.
- ``device_transient=P`` / ``device_transient=P:AFTER`` — each
  dispatch *attempt* fails with a transient runtime error with
  probability ``P``, hashed on ``(seed, dispatch scope, attempt
  seq)``; retries draw fresh seqs, so ``P < 1`` eventually succeeds.
  With ``:AFTER``, only attempts with seq > ``AFTER`` can fail — the
  deterministic "run fine for N dispatches, then die" schedule the
  crash-resume tests use.
- ``nan_inject=P`` / ``nan_inject=P:I`` — at each chunk boundary,
  poison an instance's carry with NaN with probability ``P`` (hashed
  on ``(seed, instance, boundary seq)``); ``:I`` restricts the
  injection to stack lane ``I`` of a ``solve_many`` group.

Wire-level fault kinds (the serving boundary; injected in the solver
service's frame loop, ``engine/service.py`` ``ServiceServer`` — same
``--chaos SPEC --chaos_seed N`` contract):

- ``conn_drop=P`` / ``conn_drop=P:AFTER`` — after computing a reply,
  close the connection WITHOUT sending it with probability ``P``
  (hashed on ``(seed, connection scope, per-connection reply seq)``);
  with ``:AFTER``, the first ``AFTER`` replies of every connection are
  exempt.  A reconnecting client re-rolls (its new connection carries
  a fresh scope), so ``P < 1`` retries eventually get through — and an
  idempotency-keyed retry of a dropped-but-computed response is
  answered from the server's reply cache, never re-solved.
- ``slow_client=W`` — hold every reply ``W`` seconds before sending
  (the scripted slow-draining client, for exercising backpressure and
  client-side timeouts).
- ``frame_corrupt=P`` / ``frame_corrupt=P:AFTER`` — corrupt the bytes
  of a reply frame (framing preserved, payload garbage) with
  probability ``P``, same hashing/exemption contract as ``conn_drop``;
  the client's frame validation rejects it and takes the reconnect
  path.

Fleet-level fault kinds (the replicated serving fleet;
``pydcop_tpu fleet --chaos`` — ``engine/fleet.py`` /
``commands/fleet.py``):

- ``replica_kill=T`` / ``replica_kill=T:IDX`` — SIGKILL one serving
  replica ``T`` seconds into the fleet's run.  With ``:IDX`` the
  victim is replica index ``IDX``; without it the victim is a pure
  hash of the seed (:meth:`FaultPlan.decide_replica_kill`), so a
  re-run with the same seed kills the same replica at the same time
  and the failover soak replays bit-for-bit.  The process-level
  analogue of ``crash=AGENT@T`` for the fleet: the router re-pins the
  dead replica's ring arc to its standby, which already holds the
  replicated session state.
"""

from __future__ import annotations

import hashlib
import re
from dataclasses import dataclass, field, replace
from typing import Dict, List, NamedTuple, Optional, Tuple


class FaultSpecError(ValueError):
    """Malformed ``--chaos`` spec (a usage error, not a failure)."""


@dataclass(frozen=True)
class LinkFaults:
    """Per-link fault probabilities (all default off)."""

    drop: float = 0.0
    dup: float = 0.0
    reorder: float = 0.0
    delay: float = 0.0  # probability
    delay_s: float = 0.05  # applied delay, seconds


@dataclass(frozen=True)
class Partition:
    """A timed outage between ``a`` and ``b`` (``b='*'``: every link
    touching ``a``); ``directed`` limits it to the a→b direction."""

    a: str
    b: str
    start: float
    duration: float
    directed: bool = False

    @property
    def end(self) -> float:
        return self.start + self.duration

    def covers(self, src: str, dst: str) -> bool:
        if self.a == src and self.b in (dst, "*"):
            return True
        if self.directed:
            return False
        return self.a == dst and self.b in (src, "*")


@dataclass(frozen=True)
class DeviceFaults:
    """Device-layer fault injection parameters (all default off).

    ``oom_width_cap``/``oom_rounds_cap`` model an HBM capacity: any
    supervised dispatch wider (more vmapped lanes) or longer (more
    scanned rounds) than the cap raises ``RESOURCE_EXHAUSTED`` —
    deterministically, so the supervisor's degradation ladder
    converges the moment a re-dispatch fits.  ``transient`` is a
    per-attempt failure probability (hashed, so retries with fresh
    sequence numbers can succeed); ``transient_after`` exempts the
    first N attempts of every scope (the deterministic
    "die mid-run" schedule).  ``nan`` poisons instance carries at
    chunk boundaries; ``nan_instance`` restricts it to one stack
    lane."""

    oom_width_cap: Optional[int] = None
    oom_rounds_cap: Optional[int] = None
    #: HBM capacity on the PER-LANE joined-table bytes of a dispatch
    #: (``device_oom_bytes=N``) — the width-exponential dimension the
    #: budgeted sweeps' replan ladder shrinks (``ops/membound.py``);
    #: dispatches that report no table size are exempt.
    oom_bytes_cap: Optional[int] = None
    transient: float = 0.0
    transient_after: int = 0
    nan: float = 0.0
    nan_instance: Optional[int] = None

    @property
    def configured(self) -> bool:
        return (
            self.oom_width_cap is not None
            or self.oom_rounds_cap is not None
            or self.oom_bytes_cap is not None
            or self.transient > 0.0
            or self.nan > 0.0
        )


@dataclass(frozen=True)
class WireFaults:
    """Wire-level fault injection parameters (all default off).

    ``conn_drop`` / ``frame_corrupt`` are per-reply probabilities
    hashed on ``(seed, connection scope, per-connection reply seq)``;
    their ``*_after`` fields exempt the first N replies of every
    connection (the deterministic "work, then fail" schedule —
    mirrors ``DeviceFaults.transient_after``).  ``slow_client`` delays
    every reply by that many seconds."""

    conn_drop: float = 0.0
    conn_drop_after: int = 0
    slow_client: float = 0.0
    frame_corrupt: float = 0.0
    frame_corrupt_after: int = 0

    @property
    def configured(self) -> bool:
        return (
            self.conn_drop > 0.0
            or self.slow_client > 0.0
            or self.frame_corrupt > 0.0
        )


@dataclass(frozen=True)
class FleetFaults:
    """Fleet-level fault injection parameters (all default off).

    ``replica_kill`` schedules a SIGKILL of one serving replica that
    many seconds into the fleet's run; ``replica_kill_instance`` pins
    the victim index (a kind MODIFIER — without it the victim is a
    pure hash of the seed, :meth:`FaultPlan.decide_replica_kill`)."""

    replica_kill: Optional[float] = None
    replica_kill_instance: Optional[int] = None

    @property
    def configured(self) -> bool:
        return self.replica_kill is not None


class Decision(NamedTuple):
    """The fate of one message (at most one fault fires per message —
    drop wins over dup over reorder over delay)."""

    drop: bool = False
    dup: bool = False
    reorder: bool = False
    delay: float = 0.0


_CLAUSE = re.compile(
    r"^(?:(?P<link>[^:=@]+):)?(?P<key>drop|dup|duplicate|reorder|delay)"
    r"=(?P<val>[^=]+)$"
)


def _u(seed: int, link: str, seq: int, kind: str) -> float:
    """Uniform [0, 1) from a keyed hash — the determinism core: the
    value depends on nothing but its four arguments."""
    h = hashlib.blake2b(
        f"{seed}|{link}|{seq}|{kind}".encode(), digest_size=8
    ).digest()
    return int.from_bytes(h, "big") / 2.0**64


@dataclass
class FaultPlan:
    """A complete, serializable fault schedule for one run."""

    seed: int = 0
    default: LinkFaults = field(default_factory=LinkFaults)
    links: Dict[Tuple[str, str], LinkFaults] = field(default_factory=dict)
    partitions: List[Partition] = field(default_factory=list)
    crashes: Dict[str, float] = field(default_factory=dict)
    device: DeviceFaults = field(default_factory=DeviceFaults)
    wire: WireFaults = field(default_factory=WireFaults)
    fleet: FleetFaults = field(default_factory=FleetFaults)
    spec: Optional[str] = None  # the source text, for run metadata

    # -- construction ---------------------------------------------------

    @classmethod
    def from_spec(cls, spec: str, seed: int = 0) -> "FaultPlan":
        """Parse the compact ``--chaos`` spec string (module doc)."""
        plan = cls(seed=seed, spec=spec)
        overrides: Dict[Tuple[str, str], Dict[str, float]] = {}
        defaults: Dict[str, float] = {}
        device_fields: Dict[str, object] = {}
        wire_fields: Dict[str, object] = {}
        fleet_fields: Dict[str, object] = {}
        for raw in spec.split(","):
            clause = raw.strip()
            if not clause:
                continue
            if clause.startswith("partition="):
                plan.partitions.append(_parse_partition(clause[10:]))
                continue
            if clause.startswith("crash="):
                agent, t = _parse_at(clause[6:], "crash")
                plan.crashes[agent] = t
                continue
            if clause.startswith(
                (
                    "device_oom=",
                    "device_oom_bytes=",
                    "device_transient=",
                    "nan_inject=",
                )
            ):
                key, val = clause.split("=", 1)
                device_fields.update(
                    _parse_device_value(key, val, clause)
                )
                continue
            if clause.startswith(
                ("conn_drop=", "slow_client=", "frame_corrupt=")
            ):
                key, val = clause.split("=", 1)
                wire_fields.update(
                    _parse_wire_value(key, val, clause)
                )
                continue
            if clause.startswith("replica_kill="):
                key, val = clause.split("=", 1)
                fleet_fields.update(
                    _parse_fleet_value(key, val, clause)
                )
                continue
            m = _CLAUSE.match(clause)
            if not m:
                raise FaultSpecError(
                    f"chaos spec: cannot parse clause {clause!r} "
                    "(expected key=value, LINK:key=value, "
                    "partition=A-B@S+D or crash=AGENT@T)"
                )
            key = {"duplicate": "dup"}.get(m["key"], m["key"])
            fields = _parse_fault_value(key, m["val"], clause)
            if m["link"] is None:
                defaults.update(fields)
            else:
                for lk in _parse_link(m["link"]):
                    overrides.setdefault(lk, {}).update(fields)
        plan.default = LinkFaults(**defaults)
        for lk, fields in overrides.items():
            plan.links[lk] = replace(plan.default, **fields)
        if device_fields:
            plan.device = DeviceFaults(**device_fields)
        if wire_fields:
            plan.wire = WireFaults(**wire_fields)
        if fleet_fields:
            plan.fleet = FleetFaults(**fleet_fields)
        plan.validate()
        return plan

    def validate(self) -> None:
        for lf in [self.default, *self.links.values()]:
            for name in ("drop", "dup", "reorder", "delay"):
                p = getattr(lf, name)
                if not 0.0 <= p <= 1.0:
                    raise FaultSpecError(
                        f"chaos spec: {name} probability {p} outside "
                        "[0, 1]"
                    )
            if lf.delay_s < 0:
                raise FaultSpecError(
                    f"chaos spec: negative delay {lf.delay_s}s"
                )
        for p in self.partitions:
            if p.start < 0 or p.duration <= 0:
                raise FaultSpecError(
                    f"chaos spec: partition window @{p.start}+"
                    f"{p.duration} must have start >= 0, duration > 0"
                )
        for agent, t in self.crashes.items():
            if t < 0:
                raise FaultSpecError(
                    f"chaos spec: crash={agent}@{t} in the past"
                )
        d = self.device
        for name in ("transient", "nan"):
            p = getattr(d, name)
            if not 0.0 <= p <= 1.0:
                raise FaultSpecError(
                    f"chaos spec: device {name} probability {p} "
                    "outside [0, 1]"
                )
        for name in ("oom_width_cap", "oom_rounds_cap", "nan_instance"):
            v = getattr(d, name)
            if v is not None and v < 0:
                raise FaultSpecError(
                    f"chaos spec: device {name}={v} must be >= 0"
                )
        if d.transient_after < 0:
            raise FaultSpecError(
                f"chaos spec: device_transient AFTER="
                f"{d.transient_after} must be >= 0"
            )
        w = self.wire
        for name in ("conn_drop", "frame_corrupt"):
            p = getattr(w, name)
            if not 0.0 <= p <= 1.0:
                raise FaultSpecError(
                    f"chaos spec: wire {name} probability {p} "
                    "outside [0, 1]"
                )
        for name in ("conn_drop_after", "frame_corrupt_after"):
            v = getattr(w, name)
            if v < 0:
                raise FaultSpecError(
                    f"chaos spec: wire {name}={v} must be >= 0"
                )
        if w.slow_client < 0:
            raise FaultSpecError(
                f"chaos spec: slow_client={w.slow_client}s must be "
                ">= 0"
            )
        fl = self.fleet
        if fl.replica_kill is not None and fl.replica_kill < 0:
            raise FaultSpecError(
                f"chaos spec: replica_kill={fl.replica_kill} in the "
                "past"
            )
        if (
            fl.replica_kill_instance is not None
            and fl.replica_kill_instance < 0
        ):
            raise FaultSpecError(
                "chaos spec: replica_kill instance="
                f"{fl.replica_kill_instance} must be >= 0"
            )

    def referenced_agents(self) -> set:
        """Every agent name the plan targets (crash schedules,
        partition endpoints, per-link overrides; ``*`` wildcards
        excluded).  Runtimes check these against their real roster —
        a misspelled name would otherwise inject nothing while the
        run still records the plan as applied."""
        names = set(self.crashes)
        for p in self.partitions:
            names.add(p.a)
            if p.b != "*":
                names.add(p.b)
        for src, dst in self.links:
            names.update((src, dst))
        return names

    @property
    def message_faults_configured(self) -> bool:
        """True when anything beyond crash schedules is configured —
        engines without a message plane accept crash-only plans.
        Device-layer fault kinds are deliberately NOT message faults:
        they target the supervised device dispatch of the batched
        engine (``engine/supervisor.py``)."""
        return bool(
            self.partitions
            or self.links
            or self.default != LinkFaults()
        )

    @property
    def device_faults_configured(self) -> bool:
        """True when any device-layer fault kind (``device_oom``,
        ``device_transient``, ``nan_inject``) is configured."""
        return self.device.configured

    @property
    def wire_faults_configured(self) -> bool:
        """True when any wire-level fault kind (``conn_drop``,
        ``slow_client``, ``frame_corrupt``) is configured — these
        inject at the solver service's frame loop
        (``engine/service.py``), nowhere else."""
        return self.wire.configured

    @property
    def fleet_faults_configured(self) -> bool:
        """True when any fleet-level fault kind (``replica_kill``) is
        configured — these inject at the replicated serving fleet's
        process level (``commands/fleet.py``), nowhere else: a single
        service, solve, or host runtime has no replica to kill."""
        return self.fleet.configured

    # -- queries (all pure) ---------------------------------------------

    def link_faults(self, src: str, dst: str) -> LinkFaults:
        return self.links.get((src, dst), self.default)

    def decide(self, src: str, dst: str, seq: int) -> Decision:
        """The fate of message number ``seq`` (1-based, per directed
        link).  Pure: (seed, link, seq) fully determine the result."""
        lf = self.link_faults(src, dst)
        link = f"{src}>{dst}"
        if lf.drop and _u(self.seed, link, seq, "drop") < lf.drop:
            return Decision(drop=True)
        if lf.dup and _u(self.seed, link, seq, "dup") < lf.dup:
            return Decision(dup=True)
        if lf.reorder and _u(self.seed, link, seq, "reorder") < lf.reorder:
            return Decision(reorder=True)
        if lf.delay and _u(self.seed, link, seq, "delay") < lf.delay:
            return Decision(delay=lf.delay_s)
        return Decision()

    def decisions(self, src: str, dst: str, n: int) -> List[Decision]:
        """The first ``n`` decisions of a link — the replay/audit view
        (two plans with equal seed+spec return identical lists)."""
        return [self.decide(src, dst, i) for i in range(1, n + 1)]

    def partition_heal(
        self, src: str, dst: str, now: float
    ) -> Optional[float]:
        """If the link is partitioned at ``now`` (seconds into the
        run), the time the LAST covering window heals; else None."""
        ends = [
            p.end
            for p in self.partitions
            if p.covers(src, dst) and p.start <= now < p.end
        ]
        return max(ends) if ends else None

    def crash_at(self, agent: str) -> Optional[float]:
        return self.crashes.get(agent)

    # -- device-layer queries (all pure, engine/supervisor.py seam) ------

    def oom_injected(
        self,
        width: int,
        rounds: Optional[int] = None,
        table_bytes: Optional[int] = None,
    ) -> bool:
        """Whether a device dispatch of ``width`` vmapped lanes
        covering ``rounds`` scanned rounds with a ``table_bytes``
        per-lane joined table exceeds the injected capacity — a
        deterministic capacity model (no hashing), so a degraded
        re-dispatch that fits always succeeds: chunk halvings and
        group splits converge on the width/rounds caps, and the
        budgeted sweeps' budget-halving replans
        (``ops/membound.py``) converge on the bytes cap exactly
        like real HBM."""
        d = self.device
        if d.oom_width_cap is not None and width > d.oom_width_cap:
            return True
        if (
            d.oom_bytes_cap is not None
            and table_bytes is not None
            and table_bytes > d.oom_bytes_cap
        ):
            return True
        return (
            d.oom_rounds_cap is not None
            and rounds is not None
            and rounds > d.oom_rounds_cap
        )

    def decide_device_transient(self, scope: str, seq: int) -> bool:
        """Whether dispatch attempt number ``seq`` (1-based, per
        supervisor scope) fails transiently.  Pure in
        ``(seed, scope, seq)``; retry attempts draw fresh seqs, so
        probabilities < 1 eventually let a retry through."""
        d = self.device
        if not d.transient or seq <= d.transient_after:
            return False
        if d.transient >= 1.0:
            return True
        return (
            _u(self.seed, scope, seq, "device_transient") < d.transient
        )

    def decide_nan_inject(self, instance: int, seq: int) -> bool:
        """Whether stack lane ``instance`` gets its carry poisoned at
        chunk boundary ``seq``.  Pure in ``(seed, instance, seq)``."""
        d = self.device
        if not d.nan:
            return False
        if d.nan_instance is not None and instance != d.nan_instance:
            return False
        if d.nan >= 1.0:
            return True
        return (
            _u(self.seed, f"lane{instance}", seq, "nan_inject") < d.nan
        )

    # -- wire-level queries (all pure, engine/service.py frame loop) -----

    def decide_conn_drop(self, scope: str, seq: int) -> bool:
        """Whether reply number ``seq`` (1-based, per connection) of
        connection ``scope`` is dropped — computed but never sent, the
        connection closed.  Pure in ``(seed, scope, seq)``; a
        reconnect's scope is fresh, so probabilities < 1 let a retry
        through eventually."""
        w = self.wire
        if not w.conn_drop or seq <= w.conn_drop_after:
            return False
        if w.conn_drop >= 1.0:
            return True
        return _u(self.seed, scope, seq, "conn_drop") < w.conn_drop

    def decide_frame_corrupt(self, scope: str, seq: int) -> bool:
        """Whether reply number ``seq`` of connection ``scope`` has
        its frame bytes corrupted.  Same contract as
        :meth:`decide_conn_drop`."""
        w = self.wire
        if not w.frame_corrupt or seq <= w.frame_corrupt_after:
            return False
        if w.frame_corrupt >= 1.0:
            return True
        return (
            _u(self.seed, scope, seq, "frame_corrupt") < w.frame_corrupt
        )

    # -- fleet-level queries (all pure, commands/fleet.py seam) ----------

    def decide_replica_kill(
        self, n_replicas: int
    ) -> Optional[Tuple[float, int]]:
        """The fleet's scripted kill, if any: ``(T, victim index)``.
        The victim is the pinned ``:IDX`` when given (rejected when
        out of range), else a pure hash of the seed over the replica
        count — two fleets with the same seed, spec, and size kill
        the same replica at the same time, which is what lets the
        failover soak replay bit-for-bit."""
        fl = self.fleet
        if fl.replica_kill is None:
            return None
        if n_replicas < 1:
            raise FaultSpecError(
                "chaos spec: replica_kill needs at least one replica"
            )
        if fl.replica_kill_instance is not None:
            if fl.replica_kill_instance >= n_replicas:
                raise FaultSpecError(
                    "chaos spec: replica_kill instance="
                    f"{fl.replica_kill_instance} out of range for "
                    f"{n_replicas} replica(s)"
                )
            return fl.replica_kill, fl.replica_kill_instance
        victim = min(
            int(
                _u(self.seed, "fleet", 1, "replica_kill")
                * n_replicas
            ),
            n_replicas - 1,
        )
        return fl.replica_kill, victim

    def to_meta(self) -> Dict[str, object]:
        """The replay record for run metadata: spec + seed reconstruct
        the plan exactly (``FaultPlan.from_spec(spec, seed)``)."""
        return {"spec": self.spec, "seed": self.seed}


# -- spec parsing helpers ------------------------------------------------


def _parse_fault_value(key: str, val: str, clause: str) -> Dict[str, float]:
    try:
        if key == "delay":
            if ":" in val:
                p, s = val.split(":", 1)
                return {"delay": float(p), "delay_s": float(s)}
            return {"delay": float(val)}
        return {key: float(val)}
    except ValueError:
        raise FaultSpecError(
            f"chaos spec: bad number in clause {clause!r}"
        ) from None


def _parse_device_value(
    key: str, val: str, clause: str
) -> Dict[str, object]:
    """Parse one device-layer clause into :class:`DeviceFaults`
    fields (``device_oom=W[:R]``, ``device_transient=P[:AFTER]``,
    ``nan_inject=P[:I]`` — module docstring)."""
    head, _, tail = val.partition(":")
    try:
        if key == "device_oom":
            out: Dict[str, object] = {}
            if head.strip() not in ("-", "*", ""):
                out["oom_width_cap"] = int(head)
            if tail:
                out["oom_rounds_cap"] = int(tail)
            if not out:
                raise ValueError("empty device_oom clause")
            return out
        if key == "device_oom_bytes":
            if tail:
                # reject rather than silently drop: a clause that
                # parses but means less than the user wrote would
                # fake chaos coverage (the wire-kind rule)
                raise ValueError(
                    "device_oom_bytes takes a single byte count"
                )
            return {"oom_bytes_cap": int(head)}
        if key == "device_transient":
            out = {"transient": float(head)}
            if tail:
                out["transient_after"] = int(tail)
            return out
        # nan_inject
        out = {"nan": float(head)}
        if tail:
            out["nan_instance"] = int(tail)
        return out
    except ValueError:
        raise FaultSpecError(
            f"chaos spec: bad number in clause {clause!r} (expected "
            "device_oom=W[:R], device_oom_bytes=N, "
            "device_transient=P[:AFTER] or nan_inject=P[:INSTANCE])"
        ) from None


def _parse_wire_value(
    key: str, val: str, clause: str
) -> Dict[str, object]:
    """Parse one wire-level clause into :class:`WireFaults` fields
    (``conn_drop=P[:AFTER]``, ``slow_client=W``,
    ``frame_corrupt=P[:AFTER]`` — module docstring)."""
    head, _, tail = val.partition(":")
    try:
        if key == "slow_client":
            if tail:
                raise ValueError("slow_client takes one value")
            return {"slow_client": float(head)}
        out: Dict[str, object] = {key: float(head)}
        if tail:
            out[f"{key}_after"] = int(tail)
        return out
    except ValueError:
        raise FaultSpecError(
            f"chaos spec: bad number in clause {clause!r} (expected "
            "conn_drop=P[:AFTER], slow_client=W or "
            "frame_corrupt=P[:AFTER])"
        ) from None


def _parse_fleet_value(
    key: str, val: str, clause: str
) -> Dict[str, object]:
    """Parse one fleet-level clause into :class:`FleetFaults` fields
    (``replica_kill=T[:IDX]`` — module docstring)."""
    head, _, tail = val.partition(":")
    try:
        out: Dict[str, object] = {key: float(head)}
        if tail:
            out[f"{key}_instance"] = int(tail)
        return out
    except ValueError:
        raise FaultSpecError(
            f"chaos spec: bad number in clause {clause!r} (expected "
            "replica_kill=T[:IDX])"
        ) from None


def _parse_link(text: str) -> List[Tuple[str, str]]:
    if ">" in text:
        src, dst = text.split(">", 1)
        return [(src.strip(), dst.strip())]
    if "-" in text:
        a, b = (s.strip() for s in text.split("-", 1))
        return [(a, b), (b, a)]
    raise FaultSpecError(
        f"chaos spec: link {text!r} must be SRC>DST or A-B"
    )


def _parse_partition(text: str) -> Partition:
    try:
        link, window = text.split("@", 1)
        start, duration = window.split("+", 1)
    except ValueError:
        raise FaultSpecError(
            f"chaos spec: partition {text!r} must be A-B@START+DURATION"
        ) from None
    directed = ">" in link
    if directed:
        a, b = link.split(">", 1)
    elif "-" in link:
        a, b = link.split("-", 1)
    else:
        raise FaultSpecError(
            f"chaos spec: partition link {link!r} must be A-B, A>B "
            "or A-*"
        )
    try:
        return Partition(
            a.strip(), b.strip(), float(start), float(duration),
            directed=directed,
        )
    except ValueError:
        raise FaultSpecError(
            f"chaos spec: bad number in partition {text!r}"
        ) from None


def _parse_at(text: str, kind: str) -> Tuple[str, float]:
    try:
        name, t = text.split("@", 1)
        return name.strip(), float(t)
    except ValueError:
        raise FaultSpecError(
            f"chaos spec: {kind}={text!r} must be {kind}=NAME@SECONDS"
        ) from None
