"""Dynamic (scenario-driven) runs with replication and repair (port of
``pydcop_tpu/engine/dynamic.py``).

Role-equivalent to the reference's ``pydcop run`` path (SURVEY §3.5:
``commands/run.py`` → orchestrator playing ``Scenario`` events against
``ResilientAgent``s).  The engine's state is a dict of tensors, so
dynamics become:

- **delay event**: solve for a deterministic round budget
  (``delay × rounds_per_second``; the batched engine is synchronous, so
  wall-clock delays map to round budgets for reproducibility).
- **remove_agent**: the agent's computations are orphaned; agents
  holding their replicas decide new hosts by solving a *reparation
  DCOP* on this same engine and device (``replication.repair``);
  computations with no live replica are **lost**: their variable
  freezes at its last value (it becomes an external variable) and the
  remaining problem is recompiled and resumed from the carried state.
- **add_agent**: joins the live pool (hosts future replicas/repairs).
- **set_value**: an external variable changes; the constraints that
  read it are re-sliced at the new value and their device tables
  patched (``engine/incremental.py``), and solving resumes.

Between events the solve state carries over at FULL fidelity whenever
the recompiled problem is unchanged (fingerprint match: every delay
and every clean migration): the complete algorithm state (Max-Sum
messages, DBA/GDBA weights, values) transfers into the next segment,
the batched equivalent of the reference resuming computations from
their replicated state.  When an event reshapes the problem (a lost
variable freezes into an external, an external value changes), the
carry degrades to declared initial values, exactly as the reference
loses the state of computations with no surviving replica.

Every segment runs on ``device`` (the CUDA device unless the caller
asks for the CPU) and draws its rounds from a device
``torch.Generator`` seeded from the segment's seed
(``engine/batched.py:round_generator``): a stochastic algorithm's
segments follow the port's streams, not the JAX package's.
"""

from __future__ import annotations

import time
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Union

import numpy as np

from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.dcop.objects import AgentDef
from pydcop_tpu_torch.dcop.scenario import Scenario
from pydcop_tpu_torch.device import DeviceLike, resolve_device

if TYPE_CHECKING:
    from pydcop_tpu_torch.distribution.objects import Distribution


def run_dynamic(
    dcop: DCOP,
    algo: str,
    algo_params: Optional[Dict[str, Any]] = None,
    scenario: Optional[Scenario] = None,
    distribution: Union[str, "Distribution"] = "oneagent",
    k_target: int = 0,
    rounds_per_second: float = 20.0,
    final_rounds: int = 100,
    seed: int = 0,
    timeout: Optional[float] = None,
    repair_algo: str = "mgm",
    mesh=None,
    n_shards: int = 1,
    chunk_size: int = 64,
    chunk_callback=None,
    pad_policy="none",
    device: DeviceLike = None,
) -> Dict[str, Any]:
    """Play a scenario against a DCOP and return the result dict
    (reference ``pydcop run`` JSON shape + ``events`` log), with the
    JAX package's keys in its order.

    ``device`` is where every segment, the compiled problem and the
    reparation solves run: the CUDA device by default (raising
    ``NoCudaDeviceError`` without one), or ``"cpu"``.  With ``mesh``
    and ``n_shards`` set (a ``parallel.Mesh`` of ``n_shards`` shards,
    or a ``ProcessMesh`` of as many processes, each running this same
    call), every segment's problem is compiled with that shard count (a
    full recompile after every event) and runs sharded over the mesh.
    ``chunk_callback`` is forwarded to each segment's
    :func:`~pydcop_tpu_torch.engine.batched.run_batched`.

    Segment compiles go through
    :class:`~pydcop_tpu_torch.engine.incremental.IncrementalCompiler`:
    delay events reuse the cached compiled problem outright,
    ``set_value`` events patch the affected device tables, and only
    structure-changing events (a variable freezing) pay a full host
    recompile.  ``pad_policy`` (``"pow2"``/``"pow2:<floor>"``,
    ``ops/padding.py``) buckets the compiled shapes.
    """
    from pydcop_tpu_torch.algorithms import (
        load_algorithm_module,
        prepare_algo_params,
    )
    from pydcop_tpu_torch.distribution.objects import Distribution
    from pydcop_tpu_torch.graphs import load_graph_module
    from pydcop_tpu_torch.replication import (
        repair_placement,
        replica_distribution,
    )

    t0 = time.perf_counter()
    if mesh is not None:
        from pydcop_tpu_torch.parallel.mesh import check_mesh

        check_mesh(n_shards, mesh)
    dev = resolve_device(device)
    module = load_algorithm_module(algo)
    if not hasattr(module, "step"):
        raise ValueError(
            f"Dynamic runs need a batched algorithm; {algo!r} is "
            "host-side (exact) — use a local-search or max-sum algorithm"
        )
    param_names = {p.name for p in module.algo_params}
    if "initial" not in param_names:
        raise ValueError(
            f"Algorithm {algo!r} does not support value carry-over "
            "(no 'initial' parameter); pick one that does"
        )
    params = prepare_algo_params(algo_params, module.algo_params)

    graph_module = load_graph_module(module.GRAPH_TYPE)
    graph = graph_module.build_computation_graph(dcop)
    computation_memory = getattr(module, "computation_memory", None)
    # each computation's footprint, evaluated once: the replica
    # placement reads it once per candidate agent (the JAX package
    # evaluates the hook there each time; the values are the same)
    foot_of = (
        {n.name: float(computation_memory(n)) for n in graph.nodes}
        if computation_memory is not None
        else {}
    )

    def footprint(comp: str) -> float:
        return foot_of.get(comp, 1.0)

    live_agents: Dict[str, AgentDef] = dict(dcop.agents)
    if isinstance(distribution, Distribution):
        dist = distribution
    else:
        from pydcop_tpu_torch.distribution import compute_distribution

        dist = compute_distribution(
            distribution,
            graph,
            live_agents.values(),
            hints=dcop.dist_hints,
            algo_module=module,
            computation_memory=computation_memory,
        )

    replicas = (
        replica_distribution(
            dist, live_agents.values(), k_target, footprint=footprint
        )
        if k_target > 0
        else None
    )

    # mutable run state
    frozen: Dict[str, Any] = {}  # lost variable → frozen value
    ext_overrides: Dict[str, Any] = {}
    current_values: Dict[str, Any] = {}
    events_log: List[Dict[str, Any]] = []
    traces: List[np.ndarray] = []
    cycles = 0
    messages = 0
    status = "finished"
    # full-state carry (reference parity: computations resume from
    # their REPLICATED STATE after a migration, not from scratch).  The
    # batched state (Max-Sum messages, DBA weights, ...) transfers
    # verbatim across segments whenever the recompiled problem is
    # byte-identical (fingerprint match), which is every delay event
    # and every remove_agent whose orphans all migrated.  Events that
    # freeze a variable or change an external value reshape the
    # problem, so only values carry there.
    carry_state: Optional[Dict[str, Any]] = None
    carry_fp: Optional[str] = None
    state_transfers = 0

    from pydcop_tpu_torch.engine.incremental import IncrementalCompiler

    compiler = IncrementalCompiler(
        dcop, n_shards=n_shards, pad_policy=pad_policy, device=dev
    )

    def run_segment(n_rounds: int, seg_seed: int) -> bool:
        """One solve segment; returns whether full state carried."""
        nonlocal cycles, messages, current_values, status
        nonlocal carry_state, carry_fp, state_transfers
        import dataclasses as dc

        from pydcop_tpu_torch.engine.batched import run_batched
        from pydcop_tpu_torch.ops.compile import encode_assignment
        from pydcop_tpu_torch.telemetry import get_tracer

        t_seg = time.perf_counter()
        problem, fp = compiler.compile(frozen, ext_overrides)
        if problem is None:
            return False  # everything frozen/lost
        carried = carry_state is not None and fp == carry_fp
        seg_params = dict(params)
        if not carried and current_values:
            real_names = tuple(
                problem.var_names[: problem.n_real_vars]
            )
            known = {
                name: current_values[name]
                for name in real_names
                if name in current_values
            }
            if len(known) == len(real_names):
                problem = dc.replace(
                    problem, init_idx=encode_assignment(problem, known)
                )
                seg_params["initial"] = "declared"
        remaining = (
            None if timeout is None else timeout - (time.perf_counter() - t0)
        )
        result = run_batched(
            problem,
            module,
            seg_params,
            rounds=n_rounds,
            seed=seg_seed,
            timeout=remaining,
            chunk_size=chunk_size,
            mesh=mesh,
            chunk_callback=chunk_callback,
            initial_state=carry_state if carried else None,
            return_state=True,
        )
        cycles += result.cycles
        messages += result.messages
        traces.append(np.asarray(result.cost_trace))
        current_values.update(result.assignment)
        carry_state = result.state
        carry_fp = fp
        if carried:
            state_transfers += 1
        if result.status == "timeout":
            status = "timeout"
        elif result.status == "degraded" and status != "timeout":
            # a NaN-quarantined segment reported its last-finite
            # anytime best; later segments restart from that snapshot,
            # but the run must still SAY it degraded (sticky, like
            # timeout)
            status = "degraded"
        get_tracer().add_span(
            "segment", "cycle", t_seg, time.perf_counter() - t_seg,
            rounds=result.cycles, state_carried=carried,
        )
        return carried

    def remove_agent(name: str) -> Dict[str, Any]:
        nonlocal replicas, dist
        if name not in live_agents:
            return {"action": "remove_agent", "agent": name, "error": "unknown"}
        live_agents.pop(name)
        orphans = (
            dist.computations_hosted(name) if name in dist.agents else []
        )
        for comp in orphans:
            dist.remove_computation(comp)
        candidates = {
            comp: [
                a
                for a in (replicas.replicas(comp) if replicas else [])
                if a in live_agents
            ]
            for comp in orphans
        }
        remaining_cap = {
            a: live_agents[a].capacity
            - sum(footprint(c) for c in dist.computations_hosted(a))
            for a in live_agents
        }
        from pydcop_tpu_torch.telemetry import get_tracer

        with get_tracer().span("repair", cat="repair", agent=name):
            placed = repair_placement(
                candidates,
                live_agents.values(),
                remaining_capacity=remaining_cap,
                footprint=footprint,
                algo=repair_algo,
                seed=seed,
                device=dev,
            )
        lost = []
        for comp in orphans:
            if comp in placed:
                dist.host_on_agent(placed[comp], [comp])
            else:
                lost.append(comp)
                if comp in dcop.variables:
                    frozen[comp] = current_values.get(
                        comp, dcop.variables[comp].domain[0]
                    )
        # re-establish k-resilience over the survivors
        if replicas is not None and live_agents:
            replicas = replica_distribution(
                dist, live_agents.values(), k_target, footprint=footprint
            )
        return {
            "action": "remove_agent",
            "agent": name,
            "orphaned": sorted(orphans),
            "migrated": placed,
            "lost": sorted(lost),
        }

    # initial settle: run one segment before the first event, as the
    # reference deploys + runs before playing the scenario
    rng_seq = seed
    run_segment(final_rounds, rng_seq)

    for event in scenario or Scenario():
        if timeout is not None and time.perf_counter() - t0 > timeout:
            status = "timeout"
            break
        if event.is_delay:
            n = max(1, int(round(event.delay * rounds_per_second)))
            rng_seq += 1
            carried = run_segment(n, rng_seq)
            events_log.append(
                {"type": "delay", "rounds": n, "state_carried": carried}
            )
            continue
        for action in event.actions or []:
            args = action.args
            if action.type == "remove_agent":
                entry = remove_agent(args["agent"])
            elif action.type == "add_agent":
                name = args["agent"]
                live_agents[name] = AgentDef(
                    name, capacity=float(args.get("capacity", 100.0))
                )
                if replicas is not None:
                    replicas = replica_distribution(
                        dist,
                        live_agents.values(),
                        k_target,
                        footprint=footprint,
                    )
                entry = {"action": "add_agent", "agent": name}
            elif action.type == "set_value":
                vname = args["variable"]
                if vname not in dcop.external_variables:
                    entry = {
                        "action": "set_value",
                        "variable": vname,
                        "error": "not an external variable",
                    }
                else:
                    ev = dcop.external_variables[vname]
                    value = ev.domain.to_domain_value(args["value"])
                    ext_overrides[vname] = value
                    entry = {
                        "action": "set_value",
                        "variable": vname,
                        "value": value,
                    }
            else:
                entry = {"action": action.type, "error": "unknown action"}
            events_log.append({"type": "event", "id": event.id, **entry})

    # final settle after the last event
    rng_seq += 1
    run_segment(final_rounds, rng_seq)

    assignment = {
        name: current_values.get(name, frozen.get(name))
        for name in dcop.variables
    }
    ext_vals = {
        name: ext_overrides.get(name, ev.value)
        for name, ev in dcop.external_variables.items()
    }
    cost = dcop.solution_cost({**assignment, **ext_vals})
    trace = (
        np.concatenate(traces) if traces else np.zeros(0, dtype=np.float32)
    )
    return {
        "assignment": assignment,
        "cost": cost,
        "cycle": cycles,
        "msg_count": messages,
        "msg_size": messages,
        "status": status,
        "time": time.perf_counter() - t0,
        "events": events_log,
        "state_transfers": state_transfers,
        "lost_computations": sorted(frozen),
        "agents_final": sorted(live_agents),
        "replicas": replicas.mapping if replicas is not None else None,
        "cost_trace": trace.tolist(),
    }
