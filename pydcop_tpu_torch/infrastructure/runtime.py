"""``solve_host()`` — run a DCOP on the host message-driven runtime
(a port of ``pydcop_tpu/infrastructure/runtime.py``; reference:
``pydcop/infrastructure/run.py:run_local_thread_dcop``).

Two execution modes over the SAME computations:

- ``mode='sim'``: a deterministic single-thread event loop.  Pending
  messages live in per-(src, dest) FIFO channels; each step picks a
  random nonempty channel (seeded) and delivers its head.  This models
  asynchrony (any interleaving ACROSS channels, in-order within one,
  matching the reference's queue delivery) while staying reproducible —
  the workhorse of the async-parity tests.
- ``mode='thread'``: one real thread per agent
  (``infrastructure.agents.Agent``), in-process queue delivery — the
  reference's ``--mode thread`` execution model.

Termination: quiescence (no pending messages — host algorithms stop
re-sending stable messages), a message budget, or wall-clock timeout.
Algorithms with tie-moves (DSA B/C) never quiesce under asynchrony, so
the runtime tracks the ANYTIME BEST assignment (as the reference
orchestrator does) and reports it as ``cost``/``assignment``, with the
last state in ``final_*``.  Result dict matches the reference surface:
``{assignment, cost, cycle, msg_count, msg_size, status, time}``
(``cycle`` reports delivered messages, the async analogue of rounds).
"""

from __future__ import annotations

import random
import time
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

from pydcop_tpu_torch.algorithms import (
    AlgorithmDef,
    ComputationDef,
    load_algorithm_module,
    prepare_algo_params,
)
from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.graphs import load_graph_module
from pydcop_tpu_torch.infrastructure.computations import (
    Message,
    MessagePassingComputation,
    VariableComputation,
)


def _placement(
    dcop: DCOP, comp_names: List[str], distribution
) -> Dict[str, List[str]]:
    """agent -> [computation names]: given Distribution, else dcop
    agents round-robin, else one agent per computation (the
    reference's oneagent default)."""
    placement: Dict[str, List[str]] = {}
    if distribution is not None:
        # same validation the hostnet orchestrator applies: a stale
        # placement must fail loudly, not KeyError mid-build or drop
        # entries silently
        hosted = set(distribution.computations)
        missing = [c for c in comp_names if c not in hosted]
        if missing:
            raise ValueError(
                f"placement leaves computation(s) {missing} unhosted"
            )
        extra = sorted(hosted - set(comp_names))
        if extra:
            raise ValueError(
                f"placement names unknown computation(s) {extra} "
                "(not in this problem's graph)"
            )
        for cname in comp_names:
            placement.setdefault(
                distribution.agent_for(cname), []
            ).append(cname)
    elif dcop.agents:
        agent_names = sorted(dcop.agents)
        for i, cname in enumerate(comp_names):
            placement.setdefault(
                agent_names[i % len(agent_names)], []
            ).append(cname)
    else:
        for cname in comp_names:
            placement.setdefault(f"a_{cname}", []).append(cname)
    return placement


def _build_computations(
    dcop: DCOP,
    algo_name: str,
    params: Dict[str, Any],
    seed: int,
    distribution=None,
    accel: Optional[set] = None,
    pending_refs: Optional[Dict[str, Dict[str, Any]]] = None,
    graph=None,
    device=None,
) -> Tuple[List[MessagePassingComputation], Optional[Dict[str, List[str]]]]:
    """Build one computation per graph node; agents named in ``accel``
    get their whole placed sub-graph as ONE compiled island
    (``build_island`` proxies) instead of per-node host computations.
    Returns ``(computations, placement)`` — placement is None unless
    islands forced it to be computed here (one graph build either way).
    ``pending_refs[agent]['fn']`` is the island's late-bound
    inbox-drained probe — the runtime rebinds it once its delivery
    structure exists.  Islands compile onto ``device``."""
    module = load_algorithm_module(algo_name)
    if not hasattr(module, "build_computation"):
        raise ValueError(
            f"{algo_name}: no host build_computation — only the batched "
            "engine supports this algorithm"
        )
    if graph is None:
        graph = load_graph_module(module.GRAPH_TYPE).build_computation_graph(
            dcop
        )
    algo_def = AlgorithmDef(algo_name, params, dcop.objective)
    defs = {
        node.name: ComputationDef(node, algo_def) for node in graph.nodes
    }
    accel = accel or set()
    if not accel:
        return [
            module.build_computation(defs[n], seed=seed) for n in defs
        ], None
    placement = _placement(dcop, list(defs), distribution)
    unknown = accel - set(placement)
    if unknown:
        raise ValueError(
            f"accel_agents {sorted(unknown)} have no computations "
            f"placed on them (agents: {sorted(placement)})"
        )
    computations: List[MessagePassingComputation] = []
    for aname, cnames in placement.items():
        if aname in accel:
            ref = {"fn": lambda: 0, "comps": set(cnames)}
            pending_refs[aname] = ref
            computations.extend(
                module.build_island(
                    [defs[c] for c in sorted(cnames)],
                    dcop,
                    seed=seed,
                    pending_fn=lambda ref=ref: ref["fn"](),
                    device=device,
                )
            )
        else:
            computations.extend(
                module.build_computation(defs[c], seed=seed)
                for c in cnames
            )
    return computations, placement


def solve_host(
    dcop: DCOP,
    algo: Union[str, AlgorithmDef],
    algo_params: Optional[Mapping[str, Any]] = None,
    mode: str = "sim",
    timeout: Optional[float] = None,
    max_msgs: Optional[int] = None,
    seed: int = 0,
    distribution=None,
    rounds: Optional[int] = None,
    msg_log: Optional[str] = None,
    accel_agents=None,
    chaos: Optional[str] = None,
    chaos_seed: int = 0,
    device=None,
) -> Dict[str, Any]:
    """Solve ``dcop`` with the host message-driven runtime.

    ``device`` is where the ``accel_agents`` islands compile and step
    (default: the CUDA device; ``"cpu"`` for the CPU); host computations
    run in Python either way.

    ``msg_log`` writes every delivered message's full content to a
    JSONL file (the reference's per-message log option — one line per
    message in ``simple_repr`` wire form).

    ``chaos``/``chaos_seed`` (thread mode): apply a deterministic
    fault-injection plan (``pydcop_tpu_torch.faults``, ``docs/faults.md``)
    to every agent's outbound messages.  Crash schedules need killable
    OS processes (``mode='process'``); sim needs no chaos layer at all
    — its event loop is already a seeded, controlled schedule.

    The budget is ``max_msgs`` delivered messages; when only ``rounds``
    is given it is converted as rounds × number of computations (one
    activation per computation ≈ one synchronous round), so a CLI
    ``--rounds`` budget stays meaningful across engines.

    The run normally ends by *quiescence* (no queued or in-flight
    messages — algorithms stop re-sending stable messages), the
    host-engine analogue of the reference's stable-message stop
    conditions; see ``docs/termination.md`` for the full mapping
    across engines.
    """
    t0 = time.perf_counter()
    from pydcop_tpu_torch.algorithms import resolve_algo
    from pydcop_tpu_torch.telemetry import get_tracer

    tracer = get_tracer()
    algo_name, params_in = resolve_algo(algo, algo_params)
    module = load_algorithm_module(algo_name)
    params = prepare_algo_params(params_in, module.algo_params)

    chaos_plan = None
    if chaos:
        if mode != "thread":
            raise ValueError(
                "chaos fault injection needs a communication layer to "
                "wrap — use mode='thread' (in-process) or "
                "mode='process' (TCP); the sim event loop is already "
                "a seeded, fully controlled schedule"
            )
        from pydcop_tpu_torch.faults import FaultPlan

        chaos_plan = FaultPlan.from_spec(chaos, chaos_seed)
        if tracer.enabled:
            # the plan lands on the trace timeline so injected-fault
            # events downstream carry their seed/spec provenance
            tracer.event(
                "chaos-plan", cat="fault", spec=chaos, seed=chaos_seed
            )
        if chaos_plan.crashes:
            raise ValueError(
                "chaos crash=AGENT@T schedules hard-kill an agent OS "
                "process — use mode='process' (thread-mode agents "
                "share this interpreter)"
            )

    # compiled islands (heterogeneous deployment, as in the hostnet
    # runtime): agents named in accel_agents host their placed
    # sub-graph as one array-engine island behind per-node proxies
    accel = set(accel_agents or ())
    if accel:
        from pydcop_tpu_torch.algorithms import require_island_support

        require_island_support(module, algo_name)
    pending_refs: Dict[str, Dict[str, Any]] = {}

    # a strategy NAME resolves here, over the one graph this run
    # builds anyway (placement files / Distribution objects arrive
    # already resolved from the embedding layer).  Sim without islands
    # has no agent containers — a strategy's result would be
    # discarded, so don't compute it (and don't error on undeclared
    # agents for a call that never needed them)
    graph = None
    if mode == "sim" and not accel:
        distribution = None
    if isinstance(distribution, str):
        if not hasattr(module, "GRAPH_TYPE"):
            raise ValueError(
                f"{algo_name}: no GRAPH_TYPE — cannot compute a "
                f"distribution strategy for it"
            )
        graph = load_graph_module(module.GRAPH_TYPE).build_computation_graph(
            dcop
        )
        if not dcop.agents:
            raise ValueError(
                f"distribution={distribution!r} needs declared agents "
                "(the dcop has none); declare AgentDefs or pass a "
                "placement file"
            )
        from pydcop_tpu_torch.distribution import compute_distribution

        distribution = compute_distribution(
            distribution, graph, list(dcop.agents.values()),
            hints=dcop.dist_hints, algo_module=module,
        )

    with tracer.span("build-computations", cat="phase", algo=algo_name):
        computations, placement = _build_computations(
            dcop, algo_name, params, seed,
            distribution=distribution, accel=accel,
            pending_refs=pending_refs, graph=graph, device=device,
        )

    if max_msgs is None:
        max_msgs = (
            rounds * len(computations) if rounds else 100_000
        )

    # anytime-best tracking (what the reference orchestrator records):
    # async variants with tie-moves (DSA B/C) never quiesce, so the
    # budget-stopped run's meaningful result is the best state seen
    var_comps = [
        c for c in computations if isinstance(c, VariableComputation)
    ]
    sign = -1.0 if dcop.objective == "max" else 1.0
    best = {"cost": float("inf"), "assignment": {}}
    trace: List[float] = []  # anytime cost stream (--collect_on CSVs)
    trace_msgs: List[int] = []  # delivered count at each snapshot

    def snapshot(delivered: int = 0) -> None:
        assignment = {c.variable.name: c.current_value for c in var_comps}
        if any(v is None for v in assignment.values()):
            return
        cost = dcop.solution_cost(assignment)
        trace.append(cost)
        trace_msgs.append(delivered)
        if tracer.enabled:
            tracer.event(
                "snapshot", cat="cycle", cost=cost, delivered=delivered
            )
        if sign * cost < best["cost"]:
            best["cost"] = sign * cost
            best["assignment"] = assignment

    log = None
    if msg_log is not None:
        from pydcop_tpu_torch.infrastructure.communication import MessageLog

        log = MessageLog(msg_log)
    chaos_info: Dict[str, Any] = {}  # filled by _run_threads (events)
    try:
        with tracer.span("deliver-loop", cat="phase", mode=mode):
            if mode == "sim":
                status, delivered, size = _run_sim(
                    computations, timeout, max_msgs, seed, t0, snapshot,
                    msg_log=log, pending_refs=pending_refs,
                )
            elif mode == "thread":
                status, delivered, size = _run_threads(
                    dcop, computations, timeout, max_msgs, distribution,
                    t0, snapshot, msg_log=log, placement=placement,
                    pending_refs=pending_refs, chaos_plan=chaos_plan,
                    chaos_info=chaos_info,
                )
            else:
                raise ValueError(f"solve_host: unknown mode {mode!r}")
    finally:
        if log is not None:
            log.close()

    snapshot(delivered)
    assignment = {c.variable.name: c.current_value for c in var_comps}
    if any(v is None for v in assignment.values()):
        # stopped before every computation selected a value (short
        # timeout/budget mid-UTIL for dpop/syncbb): fall back to the
        # best sampled assignment — same guard as the hostnet
        # orchestrator's final collect — instead of crashing inside
        # constraint evaluation
        assignment = dict(best["assignment"])
        cost = sign * best["cost"] if assignment else None
    else:
        cost = dcop.solution_cost(assignment)
    best_cost = sign * best["cost"] if best["assignment"] else None
    return {
        "assignment": best["assignment"],
        "cost": best_cost,  # back to the native sign
        "final_assignment": assignment,
        "final_cost": cost,
        "cycle": delivered,
        "msg_count": delivered,
        "msg_size": size,
        "status": status,
        "time": time.perf_counter() - t0,
        "cost_trace": trace,
        "trace_subsampled": True,  # one entry per snapshot, not cycle
        # actual delivered count per snapshot, so the metrics CSVs can
        # label rows exactly instead of reconstructing proportionally
        "trace_msgs": trace_msgs,
        # fault-injection replay record (spec + seed + event counts)
        **(
            {"chaos": {**chaos_plan.to_meta(), **chaos_info}}
            if chaos_plan is not None
            else {}
        ),
    }


def _run_sim(
    computations: List[MessagePassingComputation],
    timeout: Optional[float],
    max_msgs: int,
    seed: int,
    t0: float,
    snapshot,
    msg_log=None,
    pending_refs: Optional[Dict[str, Dict[str, Any]]] = None,
) -> Tuple[str, int, int]:
    rnd = random.Random(seed)
    # per-(src, dest) FIFO channels: asynchrony means ANY interleaving
    # ACROSS channels, but messages within one channel stay ordered
    # (the reference's queue/TCP delivery guarantees this; violating it
    # lets a stale message clobber a newer one and breaks convergence)
    from collections import deque

    channels: Dict[Tuple[str, str], "deque"] = {}
    nonempty: List[Tuple[str, str]] = []
    by_name = {c.name: c for c in computations}

    # islands flush when THEIR inbox drains — the same per-agent probe
    # as the hostnet/thread runtimes (a global in-flight count would
    # let an unrelated queued message suppress the island's final
    # flush and quiesce with unpropagated boundary beliefs).  The
    # delivered message is decremented before its handler runs, so 0
    # really means drained.
    dest_ref: Dict[str, Dict[str, Any]] = {}
    for ref in (pending_refs or {}).values():
        ref["queued"] = 0
        ref["fn"] = lambda ref=ref: ref["queued"]
        for cname in ref["comps"]:
            dest_ref[cname] = ref

    def sender(src: str, dest: str, msg: Message) -> None:
        if dest not in by_name:
            raise ValueError(f"message to unknown computation {dest!r}")
        ch = (src, dest)
        q = channels.get(ch)
        if q is None:
            q = channels[ch] = deque()
        if not q:
            nonempty.append(ch)
        q.append(msg)
        r = dest_ref.get(dest)
        if r is not None:
            r["queued"] += 1

    for c in computations:
        c.message_sender = sender
    # start in randomized order — part of the modeled asynchrony
    order = list(computations)
    rnd.shuffle(order)
    for c in order:
        c.start()

    # sim delivers straight off its channels (no Messaging router), so
    # the message-plane telemetry hooks live here; guards are one
    # attribute check each
    from pydcop_tpu_torch.telemetry import get_metrics, get_tracer

    met = get_metrics()
    tr = get_tracer()
    delivered = 0
    size = 0
    status = "finished"  # quiescence
    snap_every = max(1, len(computations))
    while nonempty:
        if delivered % snap_every == 0:
            snapshot(delivered)
        if delivered >= max_msgs:
            status = "msg_budget"
            break
        if timeout is not None and time.perf_counter() - t0 > timeout:
            status = "timeout"
            break
        i = rnd.randrange(len(nonempty))
        nonempty[i], nonempty[-1] = nonempty[-1], nonempty[i]
        ch = nonempty[-1]
        q = channels[ch]
        msg = q.popleft()
        if not q:
            nonempty.pop()
        src, dest = ch
        r = dest_ref.get(dest)
        if r is not None:
            r["queued"] -= 1
        delivered += 1
        size += msg.size
        if met.enabled:
            met.inc("msg.delivered")
            met.inc("msg.size", msg.size)
        if tr.detailed:
            tr.event(
                "deliver", cat="message", agent="_sim",
                src=src, dest=dest, type=msg.type,
            )
        if msg_log is not None:
            msg_log.log("_sim", src, dest, msg)
        by_name[dest].on_message(src, msg)
    for c in computations:
        c.stop()
    return status, delivered, size


def _run_threads(
    dcop: DCOP,
    computations: List[MessagePassingComputation],
    timeout: Optional[float],
    max_msgs: int,
    distribution,
    t0: float,
    snapshot,
    msg_log=None,
    placement: Optional[Dict[str, List[str]]] = None,
    pending_refs: Optional[Dict[str, Dict[str, Any]]] = None,
    chaos_plan=None,
    chaos_info: Optional[Dict[str, Any]] = None,
) -> Tuple[str, int, int]:
    from pydcop_tpu_torch.infrastructure.agents import Agent
    from pydcop_tpu_torch.infrastructure.communication import (
        InProcessCommunicationLayer,
    )

    if placement is None:
        placement = _placement(
            dcop, [c.name for c in computations], distribution
        )

    if len(placement) > 512:
        import logging

        logging.getLogger(__name__).warning(
            "thread mode with %d agents: one OS thread per agent "
            "starves the GIL well before 1000 agents (the classic "
            "thread-per-agent scaling wall, measured in BASELINE.md) "
            "— prefer mode='sim', fewer agents via a distribution, or "
            "the batched engine",
            len(placement),
        )

    from pydcop_tpu_torch.infrastructure.discovery import Discovery

    comm = InProcessCommunicationLayer()
    discovery = Discovery()  # dynamic directory: add/remove events
    by_name = {c.name: c for c in computations}
    errors: List[Tuple[str, BaseException]] = []
    agents = []
    # fault injection: each agent sends through its OWN chaos wrapper
    # over the shared in-process layer (the plan keys faults by
    # directed agent link, and the wrapper needs to know its sender)
    if chaos_plan is not None:
        unknown = chaos_plan.referenced_agents() - set(placement)
        if unknown:
            raise ValueError(
                f"chaos spec names unknown agent(s) {sorted(unknown)} "
                f"(this run's agents: {sorted(placement)}) — those "
                "faults would never fire"
            )
    chaos_layers = []
    for aname, comp_names in placement.items():
        plane = comm
        if chaos_plan is not None:
            from pydcop_tpu_torch.faults import ChaosCommunicationLayer

            plane = ChaosCommunicationLayer(comm, chaos_plan, aname)
            chaos_layers.append(plane)
        agent = Agent(
            aname, plane,
            on_error=lambda comp, e: errors.append((comp, e)),
            discovery=discovery,
            msg_log=msg_log,
        )
        for cname in comp_names:
            agent.deploy_computation(by_name[cname])
        agents.append(agent)
        if pending_refs and aname in pending_refs:
            # island flush probe: drained when nothing is WAITING —
            # Messaging.queued excludes the in-flight message, so the
            # probe is exact both inside a handler and from on_start
            pending_refs[aname]["fn"] = (
                lambda a=agent: a.messaging.queued
            )

    for a in agents:
        a.start()
    for a in agents:
        a.start_computations()

    # run until quiescent (all queues empty twice in a row), message
    # budget, or timeout
    status = "finished"
    idle_checks = 0
    while True:
        time.sleep(0.02)
        total = sum(a.messaging.count_msg for a in agents)
        snapshot(total)  # values are plain attributes; a torn read at
        # worst yields a mix of valid values, whose cost is still a
        # valid anytime sample
        if timeout is not None and time.perf_counter() - t0 > timeout:
            status = "timeout"
            break
        if total >= max_msgs:
            status = "msg_budget"
            break
        # a chaos-held message (delay / partition hold) is in flight
        # but invisible to every Messaging queue — quiescence must
        # wait for it or a delayed message would arrive after "done"
        if all(a.is_idle for a in agents) and not any(
            w.in_flight for w in chaos_layers
        ):
            idle_checks += 1
            if idle_checks >= 3:
                break
        else:
            idle_checks = 0
    for a in agents:
        a.stop()
    for a in agents:
        a.join(timeout=1.0)
    for w in chaos_layers:
        w.close()  # stop the timer wheels (inner layer has no close)
    if chaos_info is not None and chaos_layers:
        events: Dict[str, int] = {}
        for w in chaos_layers:
            for kind, n in w.event_summary().items():
                events[kind] = events.get(kind, 0) + n
        chaos_info["events"] = events
    if errors:
        comp, err = errors[0]
        raise RuntimeError(
            f"computation {comp!r} failed in thread mode: {err!r}"
        ) from err
    delivered = sum(a.messaging.count_msg for a in agents)
    size = sum(a.messaging.size_msg for a in agents)
    return status, delivered, size
