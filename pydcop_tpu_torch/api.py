"""Embedding API (port of ``pydcop_tpu/api.py``'s ``solve`` in batched
mode, and its exact host path).

``solve()`` loads a DCOP and takes one of two paths, as the JAX package
does:

- the batched engine (Max-Sum, A-Max-Sum, the local-search family): it
  compiles the DCOP, runs the algorithm and returns the result dict with
  the JAX package's keys ``{assignment, cost, final_assignment,
  final_cost, cycle, msg_count, msg_size, status, time, cost_trace}``,
  plus ``restart_costs`` when ``n_restarts > 1``;
- the exact host path (``dpop``, whose module has ``solve_host``): the
  pseudo-tree walk on the host, the UTIL joins on the device, and the
  JAX package's DPOP result dict (the keys above plus ``util_time``,
  ``util_backend``, ``util_cells``, ``util_device_nodes``,
  ``util_host_nodes`` and ``util_dispatches``).  ``pad_policy`` buckets
  its level dispatches; checkpoints and restarts do not apply.

On the batched engine ``pad_policy`` buckets the compiled problem's
shapes (``ops/padding.py``).

``solve_many()`` solves several DCOPs at once: same-shape instances
(after ``pad_policy`` bucketing) run as one group on the batched engine,
one launch of each kernel per round for the whole group
(``engine/batched.py:run_many_batched``), and DPOP instances merge their
UTIL phases into one sweep (``engine/host_batch.py``).

The run goes to the CUDA device unless ``device="cpu"`` is passed;
without a CUDA device it raises.

Not ported yet: the other execution modes, checkpoints, ``infer`` and
the ``telemetry`` block of the result (ROADMAP.md).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Union

from pydcop_tpu_torch.algorithms import (
    load_algorithm_module,
    prepare_algo_params,
)
from pydcop_tpu_torch.device import DeviceLike, resolve_device


def solve(
    dcop,
    algo: str,
    algo_params: Optional[Mapping[str, Any]] = None,
    rounds: int = 200,
    timeout: Optional[float] = None,
    seed: int = 0,
    convergence_chunks: int = 0,
    chunk_size: int = 64,
    checkpoint_path: Optional[str] = None,
    resume: bool = False,
    mode: str = "batched",
    n_restarts: int = 1,
    pad_policy: str = "none",
    device: DeviceLike = None,
) -> Dict[str, Any]:
    """Solve a DCOP (object or yaml path) and return the result dict.

    >>> result = solve("examples/graph_coloring_3.yaml", "maxsum",
    ...                {"damping": 0.5}, rounds=100, device="cpu")
    >>> result["assignment"], result["cost"]
    """
    if mode != "batched":
        raise NotImplementedError(
            f"mode={mode!r}: only the batched engine is ported"
        )
    dev = resolve_device(device)
    if isinstance(dcop, (str, list, tuple)):
        from pydcop_tpu_torch.dcop.yamldcop import load_dcop_from_file

        dcop = load_dcop_from_file(dcop)
    module = load_algorithm_module(algo)
    params = prepare_algo_params(algo_params, module.algo_params)

    if hasattr(module, "solve_host"):
        # exact host-path algorithms (DPOP)
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
        checkpoint_path=checkpoint_path, resume=resume,
        n_restarts=n_restarts,
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
    is the group's wall time divided by its size.

    Not ported yet (each raises ``NotImplementedError``): ``trace`` and
    ``compile_cache`` (ROADMAP A4), ``chaos`` and the supervisor knobs
    ``retry_budget``, ``chunk_floor``, ``on_numeric_fault`` (A3).
    """
    import time as _time

    for value, name, item in (
        (trace, "trace", "A4"), (compile_cache, "compile_cache", "A4"),
        (chaos, "chaos", "A3"), (retry_budget, "retry_budget", "A3"),
        (chunk_floor, "chunk_floor", "A3"),
        (on_numeric_fault, "on_numeric_fault", "A3"),
    ):
        if value is not None:
            raise NotImplementedError(
                f"solve_many {name}= is not ported yet — see ROADMAP.md, "
                f"{item}"
            )
    del trace_format, chaos_seed  # only read with trace= / chaos=
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
        for stacked in stack_problems([problems[i] for i in part]):
            group = [part[j] for j in stacked.indices]
            runs = run_many_batched(
                stacked, module, [prepared[i] for i in group],
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
    resume: bool = False,
    n_restarts: int = 1,
    cost_every: int = 1,
) -> Dict[str, Any]:
    """Solve an already-compiled problem (same result dict as
    :func:`solve`) on the device the problem lives on — the entry point
    for array-built problems
    (:func:`pydcop_tpu_torch.ops.compile.compile_from_arrays`)."""
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
        checkpoint_path=checkpoint_path, resume=resume,
        n_restarts=n_restarts, cost_every=cost_every,
    )


def _run_compiled(problem, module, params, **kwargs) -> Dict[str, Any]:
    from pydcop_tpu_torch.engine.batched import run_batched

    return _result_dict(run_batched(problem, module, params, **kwargs))


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
