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

The run goes to the CUDA device unless ``device="cpu"`` is passed;
without a CUDA device it raises.

Not ported yet: the other execution modes, restarts for
``maxsum``/``amaxsum``, checkpoints, the batched engine's shape
bucketing (``pad_policy`` other than ``none`` for the compiler),
``solve_many``, ``infer`` and the ``telemetry`` block of the result
(ROADMAP.md).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

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
