"""Embedding API (port of ``pydcop_tpu/api.py``'s ``solve`` in batched
mode, and its exact host path).

``solve()`` loads a DCOP and takes one of two paths, as the JAX package
does:

- the batched engine (Max-Sum, A-Max-Sum, the local-search family): it
  compiles the DCOP, runs the algorithm and returns the result dict with
  the JAX package's keys ``{assignment, cost, final_assignment,
  final_cost, cycle, msg_count, msg_size, status, time, cost_trace}``,
  plus ``restart_costs`` when ``n_restarts > 1``;
- the exact host path (``dpop`` and ``syncbb``, whose modules have
  ``solve_host``): DPOP walks its pseudo-tree on the host with the UTIL
  joins on the device and returns the JAX package's DPOP result dict
  (the keys above plus ``util_time``, ``util_backend``, ``util_cells``,
  ``util_device_nodes``, ``util_host_nodes`` and ``util_dispatches``;
  ``max_util_bytes``, ``table_dtype`` and ``table_format`` pick the
  memory-bounded sweep and the storage of its device tables);
  SyncBB's token walk runs on the host alone.  ``pad_policy`` buckets
  DPOP's level dispatches; checkpoints and restarts do not apply.

On the batched engine ``pad_policy`` buckets the compiled problem's
shapes (``ops/padding.py``).

``solve_many()`` solves several DCOPs at once: same-shape instances
(after ``pad_policy`` bucketing) run as one group on the batched engine,
one launch of each kernel per round for the whole group
(``engine/batched.py:run_many_batched``), and DPOP instances merge their
UTIL phases into one sweep (``engine/host_batch.py``).

``infer()`` and ``infer_many()`` answer exact probabilistic queries over
a DCOP's cost model (``map``, ``log_z``, ``marginals``, ``kbest:<k>``,
``marginal_map``, ``expectation``) with the semiring contraction sweep
(``ops/semiring.py``), returning the JAX package's result dicts.

Every ``solve``, ``solve_many``, ``infer`` and ``infer_many`` call runs
inside a telemetry session (``pydcop_tpu_torch.telemetry``) and attaches
its summary as ``result["telemetry"]``; ``trace=`` also writes the
span/event timeline to a file (``trace_format`` ``"jsonl"`` or
``"chrome"``).

The run goes to the CUDA device unless ``device="cpu"`` is passed
(``torch_device="cpu"`` for ``infer``, whose ``device`` keyword keeps the
JAX package's meaning, the offload policy); without a CUDA device it
raises.

On the batched engine ``checkpoint_path``/``checkpoint_every``/``resume``
save the run state to an ``.npz`` file and continue from it
(``engine/checkpoint.py``); DPOP and ``infer`` prune their device
contractions by branch and bound (``bnb``, ``"auto"`` by default).

Every call runs under a supervisor of its own
(``engine/supervisor.py``): ``retry_budget``, ``chunk_floor``,
``on_numeric_fault`` and the device-layer ``chaos`` kinds on ``solve``
and ``solve_many``, ``retry_budget`` on ``infer`` and ``infer_many``.

``mode="sim"`` and ``mode="thread"`` run the host message-driven
runtime (``infrastructure/runtime.py:solve_host``): one computation per
graph node, on a seeded event loop or on one thread per agent, with
``distribution`` shaping the placement, ``msg_log`` logging every
delivered message, message-plane ``chaos`` in thread mode, and the
agents named in ``accel_agents`` hosting their subgraph as one compiled
island on ``device`` (Max-Sum and A-Max-Sum islands launch the factor
and q-update kernels on the card).  ``mode="process"`` runs the same
computations in one OS process per agent over TCP
(``infrastructure/hostnet.py``): the agent processes take ``device``
for their islands.  ``ui_port`` serves the live feed
(``infrastructure/ui.py``) of a batched or process run.

``SolverService``, ``ServiceClient`` and ``ServiceError`` (the
continuous-batching solver service, ``engine/service.py``) and
``FleetRouter``, ``FleetError``, ``HashRing``, ``Replica`` and
``standby_map`` (the replicated fleet, ``engine/fleet.py``) load on
first use; importing this module loads no torch.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Dict, Mapping, Optional, Sequence, Union

from pydcop_tpu_torch.algorithms import (
    load_algorithm_module,
    prepare_algo_params,
)

if TYPE_CHECKING:
    from pydcop_tpu_torch.device import DeviceLike

# The solver-service surface re-exports lazily, and nothing above loads
# torch: ``api.ServiceClient`` is a pure-socket client that a process
# without torch can use against a remote ``serve``.
_SERVICE_EXPORTS = ("ServiceClient", "ServiceError", "SolverService")
_FLEET_EXPORTS = (
    "FleetError", "FleetRouter", "HashRing", "Replica", "standby_map",
)


def __getattr__(name):
    if name in _SERVICE_EXPORTS:
        from pydcop_tpu_torch.engine import service as _service

        return getattr(_service, name)
    if name in _FLEET_EXPORTS:
        from pydcop_tpu_torch.engine import fleet as _fleet

        return getattr(_fleet, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def solve(
    dcop,
    algo,
    algo_params: Optional[Mapping[str, Any]] = None,
    rounds: int = 200,
    timeout: Optional[float] = None,
    seed: int = 0,
    convergence_chunks: int = 0,
    chunk_size: int = 64,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 1,
    resume: bool = False,
    mode: str = "batched",
    n_restarts: int = 1,
    pad_policy: str = "none",
    device: DeviceLike = None,
    trace: Optional[str] = None,
    trace_format: str = "jsonl",
    max_util_bytes: Optional[int] = None,
    bnb: Optional[str] = None,
    table_dtype: Optional[str] = None,
    table_format: Optional[str] = None,
    chaos: Optional[str] = None,
    chaos_seed: int = 0,
    retry_budget: Optional[int] = None,
    chunk_floor: Optional[int] = None,
    on_numeric_fault: Optional[str] = None,
    compile_cache: Optional[str] = None,
    ui_port: Optional[int] = None,
    nb_agents: Optional[int] = None,
    msg_log: Optional[str] = None,
    accel_agents: Optional[Sequence[str]] = None,
    distribution: Optional[Any] = None,
    k_target: int = 0,
) -> Dict[str, Any]:
    """Solve a DCOP (object or yaml path) and return the result dict,
    with the run's ``telemetry`` block; ``trace`` also writes the
    span/event timeline to that file (``trace_format`` ``"jsonl"`` or
    ``"chrome"``).

    ``max_util_bytes``, ``bnb``, ``table_dtype`` and ``table_format``
    are the discoverable spellings of the algorithm parameters of the
    same names, checked as the JAX package checks them (an algorithm
    without the parameter raises ``ValueError``).  ``max_util_bytes``
    (DPOP) caps every UTIL table at that many device bytes through the
    memory-bounded planner (``ops/membound.py``): results stay exact,
    a device OOM re-plans at half the budget, and the result carries a
    ``membound`` block.  ``bnb`` (DPOP, Max-Sum; ``"auto"``, ``"on"``,
    ``"off"``) prunes the device contractions by branch and bound, with
    results bit-identical to ``"off"``.

    On the batched engine ``checkpoint_path`` saves the run state every
    ``checkpoint_every`` chunks (and at the end) to that ``.npz`` file,
    and ``resume=True`` continues from it when it exists
    (``engine/batched.py:run_batched``).

    The call runs under its own supervisor (``engine/supervisor.py``):
    ``retry_budget`` bounds the transient retries of each device
    dispatch, ``chunk_floor`` is the smallest chunk a device OOM may
    halve the run to, ``on_numeric_fault`` (``"quarantine"``: a NaN cost
    ends the run ``status="degraded"`` with its last finite best;
    ``"raise"``) picks the answer to a NaN cost.  ``chaos``/``chaos_seed``
    take the device-layer fault kinds (``device_oom``,
    ``device_transient``, ``nan_inject``) and inject them at that
    supervisor, and the result records the plan as ``result["chaos"]``.

    ``compile_cache`` (the JAX package's persistent XLA cache) has no
    counterpart and takes only None, as in :func:`solve_many`.

    ``algo`` is a name or an ``AlgorithmDef`` (explicit ``algo_params``
    override its params).  ``mode`` is ``"batched"`` (the default),
    ``"sim"`` (the deterministic seeded event loop of the host runtime),
    ``"thread"`` (one thread per agent) or ``"process"`` (one local OS
    process per agent over TCP, ``nb_agents`` of them): the JAX
    package's modes, with its checks and messages.  In the host modes
    ``distribution`` (a strategy name, a ``distribute --output`` file or a
    ``Distribution``) places the computations on agents, ``accel_agents``
    names the agents that host their subgraph as one compiled island on
    ``device``, ``msg_log`` writes every delivered message as a JSON
    line, and the thread and process modes take the message-plane
    ``chaos`` kinds; process mode also takes ``k_target`` (replica-based
    migration when an agent process dies).  The agent processes of
    process mode compile their islands on ``device``: a default run
    needs a card in every island agent, and fails with the agent's
    error otherwise.  The batched engine accepts and ignores
    ``distribution``.  ``ui_port`` serves the live feed (SSE
    ``/events`` and ``/state``) of a batched or process run.

    >>> result = solve("examples/graph_coloring_3.yaml", "maxsum",
    ...                {"damping": 0.5}, rounds=100, device="cpu")
    >>> result["assignment"], result["cost"]
    """
    from pydcop_tpu_torch.telemetry import session

    _no_compile_cache(compile_cache)
    with session(trace, trace_format) as tel:
        result = _solve(
            dcop, algo, algo_params, rounds=rounds, timeout=timeout,
            seed=seed, convergence_chunks=convergence_chunks,
            chunk_size=chunk_size, checkpoint_path=checkpoint_path,
            checkpoint_every=checkpoint_every, resume=resume, mode=mode,
            n_restarts=n_restarts,
            pad_policy=pad_policy, device=device,
            max_util_bytes=max_util_bytes, bnb=bnb,
            table_dtype=table_dtype, table_format=table_format,
            chaos=chaos, chaos_seed=chaos_seed, retry_budget=retry_budget,
            chunk_floor=chunk_floor, on_numeric_fault=on_numeric_fault,
            ui_port=ui_port, nb_agents=nb_agents, msg_log=msg_log,
            accel_agents=accel_agents, distribution=distribution,
            k_target=k_target,
        )
        result["telemetry"] = tel.summary()
    return result


def _device_chaos(chaos, chaos_seed, caller: str):
    """The :class:`~pydcop_tpu_torch.faults.plan.FaultPlan` of ``chaos``
    (None without one), with the JAX package's rejections of the kinds
    a batched ``solve``/``solve_many`` cannot inject."""
    if not chaos:
        return None
    from pydcop_tpu_torch.faults import FaultPlan

    plan = FaultPlan.from_spec(chaos, chaos_seed)
    one = "a one-shot solve" if caller == "solve" else "solve_many"
    if plan.message_faults_configured or plan.crashes:
        if caller == "solve":
            raise ValueError(
                "chaos message-plane faults and crash schedules "
                "target the message-driven runtimes — use "
                "mode='thread' or 'process' (crash schedules against "
                "the batched dynamic engine go through the `run` "
                "command's --chaos, which scripts them as scenario "
                "events).  The batched engine accepts the "
                "DEVICE-layer kinds only: device_oom, "
                "device_transient, nan_inject (docs/faults.md)"
            )
        raise ValueError(
            "solve_many runs on the batched engine, which has no "
            "message plane — chaos accepts the DEVICE-layer "
            "kinds only: device_oom, device_transient, "
            "nan_inject (docs/faults.md)"
        )
    if plan.wire_faults_configured:
        raise ValueError(
            "wire-level chaos kinds (conn_drop/slow_client/"
            "frame_corrupt) inject at the solver service's frame "
            "loop — use `pydcop_tpu serve --chaos` "
            f"(docs/serving.md); {one} has no serving wire"
        )
    if plan.fleet_faults_configured:
        raise ValueError(
            "fleet-level chaos kinds (replica_kill) act on a "
            "replicated serving fleet's processes — use "
            "`pydcop_tpu fleet --chaos` (docs/faults.md); "
            f"{one} has no fleet"
        )
    return plan


def _contraction_knobs(
    algo, module, params_in, max_util_bytes, bnb, table_dtype,
    table_format,
):
    """Fold ``solve``'s contraction keywords into the algorithm params,
    with the JAX package's checks (``pydcop_tpu/api.py``)."""
    from pydcop_tpu_torch.ops.padding import as_table_dtype
    from pydcop_tpu_torch.ops.sparse import as_table_format

    names = {p.name for p in module.algo_params}
    params_in = dict(params_in or {})
    if max_util_bytes is not None:
        if "max_util_bytes" not in names:
            raise ValueError(
                "max_util_bytes bounds the exact contraction engine's "
                "largest UTIL/message table — supported by algorithms "
                "with a bounded-memory plan (dpop) and by api.infer; "
                f"{algo!r} has no such table to bound"
            )
        if int(max_util_bytes) <= 0:
            # the algo-param route's 0 means "off", but an EXPLICIT
            # budget of <= 0 is a sizing bug
            raise ValueError(
                f"max_util_bytes must be > 0, got {max_util_bytes}"
            )
        params_in["max_util_bytes"] = int(max_util_bytes)
    if bnb is not None:
        if "bnb" not in names:
            raise ValueError(
                "bnb selects the branch-and-bound pruned contraction "
                "kernels — supported by algorithms with a device "
                f"contraction phase (dpop, maxsum); {algo!r} has none"
            )
        params_in["bnb"] = str(bnb)
    if table_dtype is not None:
        if "table_dtype" not in names:
            raise ValueError(
                "table_dtype selects the storage precision of the "
                "device contraction tables — supported by algorithms "
                f"with a device contraction phase (dpop) and by "
                f"api.infer; {algo!r} has none (maxsum's message-plane "
                "sibling is msg_dtype)"
            )
        params_in["table_dtype"] = as_table_dtype(table_dtype)
    if table_format is not None:
        if "table_format" not in names:
            raise ValueError(
                "table_format selects the storage layout of the device "
                "contraction tables — supported by algorithms with a "
                f"device contraction phase (dpop) and by api.infer; "
                f"{algo!r} has none"
            )
        params_in["table_format"] = as_table_format(table_format)
    return params_in


def _host_mode_checks(
    mode, pad_policy, retry_budget, chunk_floor, on_numeric_fault,
    max_util_bytes, chaos, chaos_seed,
) -> None:
    """The JAX package's refusals of the batched engine's knobs and of
    the foreign chaos kinds on a message-driven mode."""
    from pydcop_tpu_torch.ops.padding import as_pad_policy

    if as_pad_policy(pad_policy).enabled:
        raise ValueError(
            "pad_policy shapes the batched engine's compiled arrays; "
            f"mode={mode!r} does not compile the whole problem"
        )
    if (
        retry_budget is not None
        or chunk_floor is not None
        or on_numeric_fault is not None
    ):
        raise ValueError(
            "retry_budget/chunk_floor/on_numeric_fault configure the "
            "batched engine's supervised device dispatch "
            f"(engine/supervisor.py); mode={mode!r} has no device "
            "dispatch to supervise"
        )
    if max_util_bytes is not None:
        raise ValueError(
            "max_util_bytes bounds the batched engine's exact "
            "contraction sweeps (ops/membound.py); the "
            f"message-driven mode={mode!r} never builds whole UTIL "
            "tables to bound"
        )
    if chaos:
        # a device-layer clause on a host runtime would no-op silently
        # (the chaos layer only reads message-plane fields)
        from pydcop_tpu_torch.faults import FaultPlan

        plan_probe = FaultPlan.from_spec(chaos, chaos_seed)
        if plan_probe.device_faults_configured:
            raise ValueError(
                "device-layer chaos kinds (device_oom/"
                "device_transient/nan_inject) inject at the batched "
                "engine's supervised device dispatch "
                f"(engine/supervisor.py); mode={mode!r} has no device "
                "dispatch — use mode='batched' (docs/faults.md)"
            )
        if plan_probe.wire_faults_configured:
            raise ValueError(
                "wire-level chaos kinds (conn_drop/slow_client/"
                "frame_corrupt) inject at the solver service's frame "
                f"loop (engine/service.py); mode={mode!r} has no "
                "serving wire — use `pydcop_tpu serve --chaos` "
                "(docs/serving.md)"
            )
        if plan_probe.fleet_faults_configured:
            raise ValueError(
                "fleet-level chaos kinds (replica_kill) act on a "
                "replicated serving fleet's processes "
                f"(engine/fleet.py); mode={mode!r} has no fleet — "
                "use `pydcop_tpu fleet --chaos` (docs/faults.md)"
            )


def _solve_host_mode(
    dcop, algo, algo_params, *, mode, rounds, timeout, seed,
    checkpoint_path, resume, ui_port, n_restarts, nb_agents, msg_log,
    accel_agents, distribution, k_target, chaos, chaos_seed, device,
) -> Dict[str, Any]:
    """``mode="sim"``/``"thread"``/``"process"``: the JAX package's
    checks, then the host runtime."""
    if mode == "process":
        if checkpoint_path is not None or resume or n_restarts != 1:
            raise ValueError(
                "checkpoint/resume and n_restarts are only supported "
                "on the batched engine, not mode='process'"
            )
        return _solve_process(
            dcop, algo, algo_params, rounds=rounds, timeout=timeout,
            seed=seed, nb_agents=nb_agents, ui_port=ui_port,
            msg_log=msg_log, accel_agents=accel_agents,
            distribution=distribution, k_target=k_target,
            chaos=chaos, chaos_seed=chaos_seed, device=device,
        )
    if mode not in ("thread", "sim"):
        raise ValueError(f"solve: unknown mode {mode!r}")
    if checkpoint_path is not None or resume:
        raise ValueError(
            "checkpoint/resume is only supported on the batched "
            f"engine, not mode={mode!r}"
        )
    if ui_port is not None:
        raise ValueError(
            "ui_port (live observability) is only supported on "
            f"the batched engine, not mode={mode!r}"
        )
    if n_restarts != 1:
        raise ValueError(
            "n_restarts (batched parallel restarts) is only "
            f"supported on the batched engine, not mode={mode!r}"
        )
    if nb_agents is not None:
        raise ValueError(
            "nb_agents is the process count of mode='process'; "
            f"mode={mode!r} decides its own parallelism"
        )
    if k_target:
        raise ValueError(
            "k_target (replica-based migration) needs killable "
            "agent OS processes — mode='process' only"
        )
    from pydcop_tpu_torch.device import resolve_device
    from pydcop_tpu_torch.infrastructure import solve_host

    dev = resolve_device(device)
    # sim consults placement only for island grouping — don't resolve a
    # distribution whose result would be discarded.  Strategy NAMES pass
    # through as-is (the runtime computes them over the graph it builds
    # anyway); files/objects resolve here.
    dist_obj = None
    if distribution is not None and (mode == "thread" or accel_agents):
        if _is_strategy_name(distribution):
            _validate_strategy_name(distribution)
            dist_obj = distribution
        else:
            dist_obj = _resolve_distribution(dcop, distribution)
    return solve_host(
        dcop, algo, algo_params, mode=mode, timeout=timeout,
        seed=seed, rounds=rounds, msg_log=msg_log,
        accel_agents=accel_agents, distribution=dist_obj,
        chaos=chaos, chaos_seed=chaos_seed, device=dev,
    )


def _batched_mode_checks(k_target, accel_agents, msg_log, nb_agents):
    """The JAX package's refusals of the host-runtime keywords on the
    batched engine."""
    if k_target:
        raise ValueError(
            "k_target (replica-based migration) is a host-runtime "
            "mode — use mode='process' (the batched engine's "
            "resilience is engine-level: engine/dynamic.py)"
        )
    if accel_agents:
        raise ValueError(
            "accel_agents (compiled islands) deploys through the host "
            "runtimes' agents — use mode='sim', 'thread' or 'process' "
            "(or the orchestrator/agent CLI with --accel_agents); the "
            "batched engine is all-accelerator already"
        )
    if msg_log is not None:
        raise ValueError(
            "msg_log records individual message contents — only the "
            "message-driven modes (thread/sim/process) deliver them; "
            "the batched engine fuses a round into one device step "
            "and the exact host-path solvers (dpop/syncbb) are "
            "vectorized.  Run the algorithm with mode='thread'/'sim'/"
            "'process' to log its messages."
        )
    if nb_agents is not None:
        raise ValueError(
            "nb_agents is the process count of mode='process'; other "
            "modes decide their own parallelism"
        )


def _is_strategy_name(distribution) -> bool:
    """A string that is not an existing file is a strategy name."""
    import os

    return isinstance(distribution, str) and not os.path.isfile(
        distribution
    )


def _validate_strategy_name(name: str) -> None:
    """Fail fast on an unloadable strategy (also catches mistyped
    placement-file paths, indistinguishable from names here)."""
    from pydcop_tpu_torch.distribution import load_distribution_module

    try:
        load_distribution_module(name)
    except Exception as e:
        raise ValueError(
            f"distribution {name!r} is neither an existing placement "
            f"file nor a loadable strategy: {e}"
        )


def _resolve_distribution(dcop, distribution):
    """Normalize a non-strategy ``solve(distribution=...)``: pass
    through a ``Distribution``, or load a ``distribute --output`` yaml
    path.  Strategy names are resolved by the runtime that owns the
    computation graph (``runtime.solve_host``)."""
    if distribution is None:
        return None
    from pydcop_tpu_torch.distribution import Distribution

    if isinstance(distribution, Distribution):
        return distribution
    import os

    if not os.path.isfile(str(distribution)):
        raise ValueError(
            f"{distribution!r}: not a placement file (expected a yaml "
            "`distribution:` mapping of agent -> computation names, "
            "the `distribute --output` format)"
        )
    import yaml

    with open(distribution) as f:
        spec = yaml.safe_load(f)
    mapping = spec.get("distribution") if isinstance(spec, dict) else None
    if not isinstance(mapping, dict):
        raise ValueError(
            f"{distribution}: not a placement file (expected a "
            "yaml `distribution:` mapping of agent -> computation "
            "names, the `distribute --output` format)"
        )
    return Distribution(mapping)


def _solve_process(
    dcop, algo, algo_params, *, rounds, timeout, seed, nb_agents, ui_port,
    msg_log=None, accel_agents=None, distribution=None, k_target=0,
    chaos=None, chaos_seed=0, device=None,
) -> Dict[str, Any]:
    """One-call multi-process solve (the JAX package's
    ``api._solve_process``; reference:
    ``pydcop/infrastructure/run.py:run_local_process_dcop``): spawn
    ``nb_agents`` local agent OS processes, run the hostnet orchestrator
    in THIS process, return its result dict.

    Default process count: one per declared AgentDef, capped at the
    machine's CPU count (and at 2 when the problem declares none).
    ``device`` goes to every child as ``--device`` (default there: the
    CUDA device), where only island agents touch it, and to the
    orchestrator's reparation solve after an agent dies (``k_target``).
    """
    import os
    import socket
    import subprocess
    import sys
    import tempfile

    from pydcop_tpu_torch.algorithms import resolve_algo
    from pydcop_tpu_torch.infrastructure.hostnet import (
        AgentFailureError,
        run_host_orchestrator,
    )

    algo_name, params_in = resolve_algo(algo, algo_params)

    if chaos:
        from pydcop_tpu_torch.faults import FaultPlan

        # fail fast on a malformed spec (FaultSpecError is a
        # ValueError), before forking nb_agents interpreters
        FaultPlan.from_spec(chaos, chaos_seed)

    # hostnet takes either a strategy NAME (computed over registered
    # agents at deploy time) or an explicit placement map; normalize
    # Distribution objects / placement files to the latter
    dist_name = None
    placement = None
    if distribution is not None:
        if _is_strategy_name(distribution):
            _validate_strategy_name(distribution)
            dist_name = distribution
        else:
            placement = _resolve_distribution(dcop, distribution).mapping

    if nb_agents is None:
        if placement is not None:
            nb_agents = len(placement)
        else:
            nb_agents = min(len(dcop.agents) or 2, os.cpu_count() or 2)
    if nb_agents < 1:
        raise ValueError(f"nb_agents must be >= 1, got {nb_agents}")

    if placement is not None:
        # explicit placement: the spawned processes must carry exactly
        # its agent names or the orchestrator can never deploy to them
        if nb_agents != len(placement):
            raise ValueError(
                f"nb_agents={nb_agents} conflicts with the "
                f"placement's {len(placement)} agents — omit "
                "nb_agents or make them match"
            )
        names = sorted(placement)
    else:
        # prefer the dcop's own agent names so hosting/capacity data
        # flows into the placement; pad with generated names when it
        # has fewer (skipping declared names the generator collides
        # with)
        names = sorted(dcop.agents)[:nb_agents]
        used = set(names)
        i = 0
        while len(names) < nb_agents:
            candidate = f"agent_{i}"
            i += 1
            if candidate not in used:
                names.append(candidate)
                used.add(candidate)

    unknown = set(accel_agents or ()) - set(names)
    if unknown:
        source = (
            "the placement's agent names"
            if placement is not None
            else "declared AgentDefs first, then generated "
            "agent_<i> padding"
        )
        raise ValueError(
            f"accel_agents {sorted(unknown)} are not among this "
            f"run's agent names {names} ({source})"
        )
    if accel_agents:
        # fail before forking, mirroring the orchestrator-side check
        from pydcop_tpu_torch.algorithms import require_island_support

        require_island_support(load_algorithm_module(algo_name), algo_name)

    # pre-bound control-plane listener: the port must be known before
    # the agents fork, and a probe-then-rebind would race other port
    # users — run_host_orchestrator accepts the live socket instead
    server = socket.create_server(("", 0))
    port = server.getsockname()[1]

    # the children must find THIS package wherever the embedding process
    # imported it from, and a dotted algo name (an external plugin)
    # resolves on the parent's sys.path: forward both through PYTHONPATH
    import pydcop_tpu_torch

    pkg_root = os.path.dirname(os.path.dirname(pydcop_tpu_torch.__file__))
    path_entries = [pkg_root]
    if "." in algo_name:
        import importlib.util

        spec = importlib.util.find_spec(algo_name.split(".")[0])
        if spec and spec.submodule_search_locations:
            # every location: a namespace package may be split across
            # several sys.path entries
            for loc in spec.submodule_search_locations:
                parent = os.path.dirname(loc)
                if parent not in path_entries:
                    path_entries.append(parent)
        elif spec and spec.origin:
            path_entries.append(os.path.dirname(spec.origin))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        path_entries + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else [])
    )
    # children's stderr goes to tempfiles: a crashing agent must be
    # diagnosable from the parent's failure, not vanish and surface only
    # as a registration timeout
    err_files = []
    procs = []
    try:
        for name in names:
            ef = tempfile.NamedTemporaryFile(
                mode="w+", suffix=f".{name}.err", delete=False
            )
            err_files.append(ef)
            procs.append(
                subprocess.Popen(
                    [
                        sys.executable, "-m", "pydcop_tpu_torch", "agent",
                        "--names", name, "--runtime", "host",
                        "--orchestrator", f"127.0.0.1:{port}",
                    ]
                    + (
                        ["--msg_log", f"{msg_log}.{name}"]
                        if msg_log
                        else []
                    )
                    + (["--device", str(device)] if device is not None
                       else []),
                    env=env,
                    stdout=subprocess.DEVNULL,
                    stderr=ef,
                )
            )
        try:
            return run_host_orchestrator(
                dcop, algo_name, params_in, nb_agents=nb_agents,
                port=port, rounds=rounds, timeout=timeout, seed=seed,
                ui_port=ui_port, server=server,
                accel_agents=list(accel_agents or ()),
                distribution=dist_name, placement=placement,
                k_target=k_target, device=device,
                chaos=chaos, chaos_seed=chaos_seed,
                # the caller's timeout also bounds registration, with a
                # floor of 30 s: each child execs a fresh interpreter and
                # imports torch before it can register
                register_timeout=(
                    min(120.0, max(timeout, 30.0))
                    if timeout is not None
                    else 120.0
                ),
            )
        except AgentFailureError as e:
            tails = []
            for name, ef in zip(names, err_files):
                try:
                    with open(ef.name, "rb") as f:
                        f.seek(0, os.SEEK_END)
                        f.seek(max(0, f.tell() - 800))
                        tail = f.read().decode("utf-8", "replace").strip()
                except OSError:
                    tail = ""
                if tail:
                    tails.append(f"--- {name} stderr ---\n{tail}")
            if tails:
                raise AgentFailureError(
                    f"{e}\n" + "\n".join(tails)
                ) from e
            raise
    finally:
        # idempotent: on the success path the orchestrator already closed
        # it; on every failure path this close EOFs lingering children
        try:
            server.close()
        except OSError:
            pass
        for p in procs:  # the orchestrator's stop already reached them;
            # this only reaps stragglers
            if p.poll() is None:
                try:
                    p.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
        for ef in err_files:
            try:
                ef.close()
                os.unlink(ef.name)
            except OSError:
                pass


def _solve(
    dcop, algo, algo_params, *, rounds, timeout, seed, convergence_chunks,
    chunk_size, checkpoint_path, checkpoint_every, resume, mode,
    n_restarts, pad_policy, device, max_util_bytes=None, bnb=None,
    table_dtype=None, table_format=None, chaos=None, chaos_seed=0,
    retry_budget=None, chunk_floor=None, on_numeric_fault=None,
    ui_port=None, nb_agents=None, msg_log=None, accel_agents=None,
    distribution=None, k_target=0,
) -> Dict[str, Any]:
    from pydcop_tpu_torch.algorithms import resolve_algo
    from pydcop_tpu_torch.engine.supervisor import (
        make_supervisor,
        supervision,
    )

    if isinstance(dcop, (str, list, tuple)):
        from pydcop_tpu_torch.dcop.yamldcop import load_dcop_from_file

        dcop = load_dcop_from_file(dcop)
    if mode != "batched":
        _host_mode_checks(
            mode, pad_policy, retry_budget, chunk_floor, on_numeric_fault,
            max_util_bytes, chaos, chaos_seed,
        )
        return _solve_host_mode(
            dcop, algo, algo_params, mode=mode, rounds=rounds,
            timeout=timeout, seed=seed, checkpoint_path=checkpoint_path,
            resume=resume, ui_port=ui_port, n_restarts=n_restarts,
            nb_agents=nb_agents, msg_log=msg_log,
            accel_agents=accel_agents, distribution=distribution,
            k_target=k_target, chaos=chaos, chaos_seed=chaos_seed,
            device=device,
        )
    plan = _device_chaos(chaos, chaos_seed, "solve")
    _batched_mode_checks(k_target, accel_agents, msg_log, nb_agents)
    algo, algo_params = resolve_algo(algo, algo_params)
    # every call runs under a supervisor of its own: the knobs, the
    # device chaos plan and per-call dispatch sequence numbers (what
    # makes the injected schedule replayable)
    sup = make_supervisor(
        retry_budget=retry_budget, chunk_floor=chunk_floor,
        on_numeric_fault=on_numeric_fault, plan=plan,
    )
    with supervision(sup):
        result = _solve_supervised(
            dcop, algo, algo_params, rounds=rounds, timeout=timeout,
            seed=seed, convergence_chunks=convergence_chunks,
            chunk_size=chunk_size, checkpoint_path=checkpoint_path,
            checkpoint_every=checkpoint_every, resume=resume,
            n_restarts=n_restarts, pad_policy=pad_policy, device=device,
            max_util_bytes=max_util_bytes, bnb=bnb,
            table_dtype=table_dtype, table_format=table_format,
            ui_port=ui_port,
        )
    if plan is not None:
        result["chaos"] = plan.to_meta()  # the replay record
    return result


def _solve_supervised(
    dcop, algo, algo_params, *, rounds, timeout, seed, convergence_chunks,
    chunk_size, checkpoint_path, checkpoint_every, resume, n_restarts,
    pad_policy, device, max_util_bytes, bnb, table_dtype, table_format,
    ui_port,
) -> Dict[str, Any]:
    from pydcop_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if isinstance(dcop, (str, list, tuple)):
        from pydcop_tpu_torch.dcop.yamldcop import load_dcop_from_file

        dcop = load_dcop_from_file(dcop)
    module = load_algorithm_module(algo)
    params = prepare_algo_params(
        _contraction_knobs(
            algo, module, algo_params, max_util_bytes, bnb, table_dtype,
            table_format,
        ),
        module.algo_params,
    )

    if hasattr(module, "solve_host"):
        # exact host-path algorithms (DPOP, SyncBB)
        if checkpoint_path is not None or resume:
            raise ValueError(
                f"{algo}: checkpoint/resume is only supported on the "
                "batched engine, not host-path (exact) algorithms"
            )
        if n_restarts != 1:
            raise ValueError(
                f"{algo} is an exact host-path algorithm — n_restarts "
                "(best-of-K for stochastic solvers) does not apply"
            )
        return module.solve_host(
            dcop, params, timeout=timeout, pad_policy=pad_policy,
            device=dev,
        )

    from pydcop_tpu_torch.ops.compile import compile_dcop

    problem = compile_dcop(dcop, pad_policy=pad_policy, device=dev)
    return _run_compiled(
        problem, module, params, rounds=rounds, seed=seed,
        timeout=timeout, chunk_size=chunk_size,
        convergence_chunks=convergence_chunks,
        checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every, resume=resume,
        n_restarts=n_restarts, ui_port=ui_port,
    )


def solve_many(
    dcops: Sequence[Any],
    algo: str,
    algo_params: Union[
        Mapping[str, Any], Sequence[Mapping[str, Any]], None
    ] = None,
    *,
    rounds: int = 200,
    timeout: Optional[float] = None,
    seed: Union[int, Sequence[int]] = 0,
    chunk_size: int = 64,
    convergence_chunks: int = 0,
    n_restarts: int = 1,
    pad_policy: str = "pow2",
    device: DeviceLike = None,
    trace: Optional[str] = None,
    trace_format: str = "jsonl",
    compile_cache: Optional[str] = None,
    chaos: Optional[str] = None,
    chaos_seed: int = 0,
    retry_budget: Optional[int] = None,
    chunk_floor: Optional[int] = None,
    on_numeric_fault: Optional[str] = None,
) -> list:
    """Solve MANY DCOP instances (objects or yaml paths), batching
    same-shaped ones (port of ``pydcop_tpu/api.py:solve_many``).  On the
    batched engine an instance may also be a compiled problem
    (``compile_from_arrays``), already padded as the caller chose.

    Every instance is compiled with ``pad_policy`` (default ``"pow2"``:
    bucketing puts similarly-sized instances on one shape), grouped by
    ``problem_group_key`` and by its static (str/bool) params, and each
    group runs as one :func:`~pydcop_tpu_torch.engine.batched.
    run_many_batched` call.  Numeric params may differ per instance
    inside a group.  ``algo_params`` and ``seed`` are one value shared
    by all instances or one per instance.  A deterministic algorithm
    (Max-Sum, MGM, DBA, GDBA) returns for instance i what
    ``solve(dcops[i], seed=seed_i, pad_policy=pad_policy)`` returns; a
    stochastic one keeps its semantics under the group's draws.
    ``n_restarts`` composes: each instance runs that many restarts.
    DPOP instances merge their UTIL phases into one level-synchronous
    sweep (``algorithms/dpop.py:solve_host_many``), each result equal to
    its sequential solve.

    ``timeout`` bounds the whole call.  Returns one result dict per
    input, in input order, with :func:`solve`'s keys plus
    ``instances_batched`` (the size of the instance's group); ``time``
    is the group's wall time divided by its size.  Every result carries
    the call's one ``telemetry`` block (``trace`` as in :func:`solve`).

    ``compile_cache`` (the JAX package's persistent XLA cache) has no
    counterpart and takes only None.

    The whole call runs under one supervisor (knobs as in
    :func:`solve`): a group that runs out of device memory splits in
    half and each half runs from round 0 (``engine.oom_splits``), and an
    instance whose costs go NaN is quarantined alone
    (``status="degraded"`` with its last finite best) while the others
    finish as they would have.  ``chaos``/``chaos_seed`` take the
    device-layer fault kinds; every result records the plan as
    ``result["chaos"]``.
    """
    from pydcop_tpu_torch.engine.supervisor import (
        make_supervisor,
        supervision,
    )
    from pydcop_tpu_torch.telemetry import session

    _no_compile_cache(compile_cache)
    plan = _device_chaos(chaos, chaos_seed, "solve_many")
    sup = make_supervisor(
        retry_budget=retry_budget, chunk_floor=chunk_floor,
        on_numeric_fault=on_numeric_fault, plan=plan,
    )
    with session(trace, trace_format) as tel, supervision(sup):
        results = _solve_many(
            dcops, algo, algo_params, rounds=rounds, timeout=timeout,
            seed=seed, chunk_size=chunk_size,
            convergence_chunks=convergence_chunks, n_restarts=n_restarts,
            pad_policy=pad_policy, device=device,
        )
        summary = tel.summary()
    for r in results:
        r["telemetry"] = summary
        if plan is not None:
            r["chaos"] = plan.to_meta()
    return results


def _no_compile_cache(compile_cache) -> None:
    if compile_cache is not None:
        raise NotImplementedError(
            "compile_cache= (the JAX package's persistent XLA compilation "
            "cache) has no counterpart in the port, which compiles no "
            "XLA programs; pass None"
        )


def _solve_many(
    dcops, algo, algo_params, *, rounds, timeout, seed, chunk_size,
    convergence_chunks, n_restarts, pad_policy, device,
) -> list:
    import time as _time

    from pydcop_tpu_torch.device import resolve_device
    from pydcop_tpu_torch.ops.padding import as_pad_policy

    dcops = list(dcops)
    n = len(dcops)
    if n == 0:
        return []
    if n_restarts < 1:
        raise ValueError(f"n_restarts must be >= 1, got {n_restarts}")
    as_pad_policy(pad_policy)  # fail fast on a malformed spec
    dev = resolve_device(device)
    module = load_algorithm_module(algo)
    if algo_params is None or isinstance(algo_params, Mapping):
        params_in = [algo_params] * n
    else:
        params_in = list(algo_params)
        if len(params_in) != n:
            raise ValueError(
                f"algo_params: got {len(params_in)} mappings for {n} dcops"
            )
    prepared = [prepare_algo_params(p, module.algo_params) for p in params_in]
    if isinstance(seed, (list, tuple, range)):
        seeds = [int(x) for x in seed]
        if len(seeds) != n:
            raise ValueError(f"seed: got {len(seeds)} seeds for {n} dcops")
    else:
        seeds = [int(seed)] * n

    loaded: Dict[Any, Any] = {}

    def _load(d):  # each yaml path once
        if isinstance(d, (str, list, tuple)):
            from pydcop_tpu_torch.dcop.yamldcop import load_dcop_from_file

            key = d if isinstance(d, str) else tuple(d)
            if key not in loaded:
                loaded[key] = load_dcop_from_file(d)
            return loaded[key]
        return d

    deadline = None if timeout is None else _time.perf_counter() + timeout

    def _remaining():
        if deadline is None:
            return None
        return max(deadline - _time.perf_counter(), 0.01)

    if hasattr(module, "solve_host"):
        if n_restarts != 1:
            raise ValueError(
                f"{algo} is an exact host-path algorithm — n_restarts "
                "(best-of-K for stochastic solvers) does not apply"
            )
        from pydcop_tpu_torch.engine.host_batch import run_many_host

        return run_many_host(
            [_load(d) for d in dcops], module, prepared,
            timeout=_remaining(), pad_policy=pad_policy, device=dev,
        )

    from pydcop_tpu_torch.engine.batched import run_many_batched
    from pydcop_tpu_torch.engine.host_batch import statics_signature
    from pydcop_tpu_torch.ops.compile import (
        CompiledProblem,
        compile_dcop,
        problem_group_key,
        stack_problems,
    )

    compiled: Dict[int, Any] = {}  # each distinct DCOP object once
    problems = []
    for d in dcops:
        obj = _load(d)
        if isinstance(obj, CompiledProblem):
            compiled.setdefault(id(obj), obj)
        elif id(obj) not in compiled:
            compiled[id(obj)] = compile_dcop(
                obj, pad_policy=pad_policy, device=dev
            )
        problems.append(compiled[id(obj)])
    partitions: Dict[Any, list] = {}
    for i, p in enumerate(prepared):
        partitions.setdefault(statics_signature(p), []).append(i)
    results: list = [None] * n
    for part in partitions.values():
        # stack one group at a time and hand it over (a one-element
        # list run_many_batched empties): the call holds the only
        # reference, so an OOM split frees the group's stacked tensors
        # before its halves run
        by_key: Dict[Any, list] = {}
        for i in part:
            by_key.setdefault(problem_group_key(problems[i]), []).append(i)
        for members in by_key.values():
            hand = stack_problems([problems[i] for i in members])
            group = [members[j] for j in hand[0].indices]
            runs = run_many_batched(
                hand, module, [prepared[i] for i in group],
                rounds=rounds, seeds=[seeds[i] for i in group],
                timeout=_remaining(), chunk_size=chunk_size,
                convergence_chunks=convergence_chunks,
                n_restarts=n_restarts,
            )
            for i, rr in zip(group, runs):
                out = _result_dict(rr)
                out["instances_batched"] = len(group)
                out["time"] = rr.time / len(group)
                results[i] = out
    return results


def solve_compiled(
    problem,
    algo: str,
    algo_params: Optional[Mapping[str, Any]] = None,
    rounds: int = 200,
    timeout: Optional[float] = None,
    seed: int = 0,
    convergence_chunks: int = 0,
    chunk_size: int = 64,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 1,
    resume: bool = False,
    ui_port: Optional[int] = None,
    n_restarts: int = 1,
    cost_every: int = 1,
) -> Dict[str, Any]:
    """Solve an already-compiled problem (same result dict as
    :func:`solve`) on the device the problem lives on — the entry point
    for array-built problems
    (:func:`pydcop_tpu_torch.ops.compile.compile_from_arrays`).
    ``ui_port`` serves the live feed of the run."""
    module = load_algorithm_module(algo)
    if hasattr(module, "solve_host"):
        raise ValueError(
            f"{algo} runs on the host path and needs the DCOP model "
            "objects — use solve() instead of solve_compiled()"
        )
    params = prepare_algo_params(algo_params, module.algo_params)
    return _run_compiled(
        problem, module, params, rounds=rounds, seed=seed,
        timeout=timeout, chunk_size=chunk_size,
        convergence_chunks=convergence_chunks,
        checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every, resume=resume,
        ui_port=ui_port, n_restarts=n_restarts, cost_every=cost_every,
    )


def _run_compiled(
    problem, module, params, ui_port=None, **kwargs
) -> Dict[str, Any]:
    """``run_batched`` to the result dict; ``ui_port`` publishes every
    chunk boundary on a :class:`~pydcop_tpu_torch.infrastructure.ui.
    UiServer` and, last, the best assignment."""
    from pydcop_tpu_torch.engine.batched import run_batched

    if ui_port is None:
        return _result_dict(run_batched(problem, module, params, **kwargs))
    from pydcop_tpu_torch.infrastructure.ui import UiServer, chunk_publisher

    ui = UiServer(ui_port)
    try:
        result = run_batched(
            problem, module, params, chunk_callback=chunk_publisher(ui),
            **kwargs,
        )
        ui.publish(  # the final event carries the assignment
            result.cycles, result.cost, result.best_cost,
            values=result.best_assignment, status=result.status,
        )
    finally:
        ui.close()
    return _result_dict(result)


def _result_dict(result) -> Dict[str, Any]:
    """RunResult → the public result-dict schema (the JAX package's
    ``api._result_dict``)."""
    return {
        "assignment": result.best_assignment,
        "cost": result.best_cost,
        "final_assignment": result.assignment,
        "final_cost": result.cost,
        "cycle": result.cycles,
        "msg_count": result.messages,
        "msg_size": result.messages,  # 1 unit per logical message
        "status": result.status,
        "time": result.time,
        "cost_trace": result.cost_trace.tolist(),
        **(
            {"restart_costs": result.restart_costs.tolist()}
            if result.restart_costs is not None
            else {}
        ),
    }


def infer(
    dcop,
    query: str = "marginals",
    *,
    order: str = "pseudo_tree",
    beta: float = 1.0,
    tol: float = 1e-6,
    device: str = "auto",
    device_min_cells: int = 1 << 14,
    timeout: Optional[float] = None,
    pad_policy: str = "none",
    max_table_size: int = 1 << 26,
    trace: Optional[str] = None,
    trace_format: str = "jsonl",
    compile_cache: Optional[str] = None,
    retry_budget: Optional[int] = None,
    max_util_bytes: Optional[int] = None,
    map_vars: Optional[Sequence[str]] = None,
    external_dists: Optional[Mapping[str, Mapping[Any, float]]] = None,
    bnb: str = "auto",
    table_dtype: str = "f32",
    table_format: str = "dense",
    torch_device: DeviceLike = None,
) -> Dict[str, Any]:
    """Exact probabilistic inference over a DCOP's cost model (port of
    ``pydcop_tpu/api.py:infer``, same keywords and defaults).

    The DCOP's total cost is an energy ``E(x)`` defining the Gibbs
    distribution ``p(x) ∝ exp(-beta·E(x))``; ``query`` picks the
    semiring the contraction sweep (``ops/semiring.py``) runs:
    ``"marginals"`` (per-variable distributions plus ``log_z``),
    ``"log_z"``, ``"map"`` (the exact MAP assignment), ``"kbest:<k>"``
    (the k best assignments in cost order: ``solutions``, ``costs``),
    ``"marginal_map"`` (``max`` over ``map_vars`` of the summed weight
    of the rest: ``assignment``, ``value``) and ``"expectation"``
    (``e_cost`` and ``log_z``; ``external_dists={external: {value:
    prob}}`` sums those externals over their distribution).  ``order``
    is ``"pseudo_tree"`` or ``"min_fill"``.

    ``device`` is the JAX package's offload policy: ``"auto"``
    (contractions of at least ``device_min_cells`` cells go to the
    device), ``"never"`` (pure host f64) or ``"always"``.  ``map`` and
    ``kbest`` stay exact on the device (f32 certificate, host f64
    repair); ``log_z``/``marginals``/``expectation`` carry an
    ``error_bound``, and a contraction whose bound would pass ``tol``
    runs on the host instead.  The device contractions run on
    ``torch_device``: the CUDA device unless ``"cpu"`` is passed
    (without a CUDA device the call raises).

    ``table_dtype`` (``f32``/``bf16``/``int8``) and ``table_format``
    (``dense``/``sparse``) pick the storage of the device tables;
    ``max_util_bytes`` runs the sweep memory-bounded
    (``ops/membound.py``; the result carries a ``membound`` block).
    ``bnb`` (``"auto"``: dispatches whose padded row has at least
    ``BNB_AUTO_MIN_CELLS`` cells; ``"on"``; ``"off"``) prunes the device
    contractions by branch and bound: ``map`` and ``kbest`` stay exact,
    the mass queries add the pruned mass to ``error_bound``.
    ``compile_cache`` has no counterpart (None only).  ``retry_budget``
    bounds the transient retries of each device contraction (the call
    runs under a supervisor of its own, ``engine/supervisor.py``).

    Returns the result dict: ``query``, ``semiring``, ``order``,
    ``status``, ``cells``, ``dispatches``, ``device_nodes``,
    ``host_nodes``, ``width``, ``error_bound``, ``instances_batched``,
    ``time``, ``telemetry`` and the query's payload.
    """
    return infer_many(
        [dcop], query, order=order, beta=beta, tol=tol, device=device,
        device_min_cells=device_min_cells, timeout=timeout,
        pad_policy=pad_policy, max_table_size=max_table_size, trace=trace,
        trace_format=trace_format, compile_cache=compile_cache,
        retry_budget=retry_budget, max_util_bytes=max_util_bytes,
        map_vars=map_vars, external_dists=external_dists, bnb=bnb,
        table_dtype=table_dtype, table_format=table_format,
        torch_device=torch_device,
    )[0]


def infer_many(
    dcops: Sequence[Any],
    query: str = "marginals",
    *,
    order: str = "pseudo_tree",
    beta: float = 1.0,
    tol: float = 1e-6,
    device: str = "auto",
    device_min_cells: int = 1 << 14,
    timeout: Optional[float] = None,
    pad_policy: str = "pow2",
    max_table_size: int = 1 << 26,
    trace: Optional[str] = None,
    trace_format: str = "jsonl",
    compile_cache: Optional[str] = None,
    retry_budget: Optional[int] = None,
    max_util_bytes: Optional[int] = None,
    map_vars: Optional[Sequence[str]] = None,
    external_dists: Optional[Mapping[str, Mapping[Any, float]]] = None,
    bnb: str = "auto",
    table_dtype: str = "f32",
    table_format: str = "dense",
    torch_device: DeviceLike = None,
) -> list:
    """Run one inference ``query`` over MANY instances (DCOP objects or
    yaml paths) with their contraction sweeps MERGED: same-bucket
    contractions from different instances ride one stacked device
    dispatch (``pad_policy`` defaults to ``"pow2"`` here so
    similarly-sized instances share buckets), and each result equals
    its sequential :func:`infer` but for ``time``,
    ``instances_batched`` and ``telemetry``.  ``timeout`` bounds the
    whole call, yaml loads included.  Returns one result dict per input,
    in input order; every result carries the call's one ``telemetry``
    block.  Keywords as in :func:`infer`."""
    import time as _time

    from pydcop_tpu_torch.device import resolve_device
    from pydcop_tpu_torch.engine.supervisor import (
        make_supervisor,
        supervision,
    )
    from pydcop_tpu_torch.ops.semiring import run_infer_many
    from pydcop_tpu_torch.telemetry import session

    dcops = list(dcops)
    if not dcops:
        return []
    _no_compile_cache(compile_cache)
    sup = make_supervisor(retry_budget=retry_budget)
    dev = resolve_device(torch_device)
    deadline = None if timeout is None else _time.perf_counter() + timeout
    loaded = []
    for d in dcops:
        if isinstance(d, (str, list, tuple)):
            from pydcop_tpu_torch.dcop.yamldcop import load_dcop_from_file

            d = load_dcop_from_file(d)
        loaded.append(d)
    with session(trace, trace_format) as tel, supervision(sup):
        results = run_infer_many(
            loaded, query, order=order, beta=beta, tol=tol, device=device,
            device_min_cells=device_min_cells, pad_policy=pad_policy,
            max_table_size=max_table_size, max_util_bytes=max_util_bytes,
            map_vars=map_vars, external_dists=external_dists, bnb=bnb,
            table_dtype=table_dtype, table_format=table_format,
            timeout=(
                None if deadline is None
                else max(deadline - _time.perf_counter(), 0.01)
            ),
            torch_device=dev,
        )
        summary = tel.summary()
    for r in results:
        r["telemetry"] = summary
    return results
