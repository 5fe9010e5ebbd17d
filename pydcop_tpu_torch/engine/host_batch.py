"""Several instances of an exact host-path algorithm (port of
``pydcop_tpu/engine/host_batch.py``).

``api.solve_many`` sends the exact host-path algorithms here.  DPOP's
instances partition by :func:`statics_signature` and each partition
runs ONE merged level-synchronous UTIL sweep
(``algorithms/dpop.py:solve_host_many``).  An algorithm without
``solve_host_many`` (SyncBB, a single token walk) solves its instances
one after the other, as the JAX package does.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from pydcop_tpu_torch.device import DeviceLike
from pydcop_tpu_torch.telemetry import get_metrics


def statics_signature(params: Mapping[str, Any]) -> Tuple:
    """Hashable grouping signature of an algorithm-params mapping: the
    str/bool params with their values (they select code paths) and the
    NAMES of the numeric params (whose values may differ per instance
    inside a group).  Instances share a run only when their signatures
    agree."""
    return (
        tuple(sorted(
            (k, v) for k, v in params.items() if isinstance(v, (str, bool))
        )),
        tuple(sorted(
            k for k, v in params.items()
            if not isinstance(v, (str, bool)) and v is not None
        )),
    )


def run_many_host(
    dcops: Sequence[Any],
    algo_module,
    params_list: Sequence[Dict[str, Any]],
    *,
    timeout: Optional[float] = None,
    pad_policy: Any = "none",
    device: DeviceLike = None,
) -> List[Dict[str, Any]]:
    """``solve_many`` for the exact host-path algorithms: one merged
    sweep per :func:`statics_signature` partition.  ``timeout`` bounds
    the whole call; each result carries ``instances_batched`` (its
    sweep's size) and ``time``, an even share of its sweep's wall
    time."""
    t0 = time.perf_counter()
    results: List[Optional[Dict[str, Any]]] = [None] * len(dcops)
    if not hasattr(algo_module, "solve_host_many"):
        for i, d in enumerate(dcops):
            remaining = (
                None if timeout is None
                else max(timeout - (time.perf_counter() - t0), 0.01)
            )
            res = algo_module.solve_host(
                d, params_list[i], timeout=remaining,
                pad_policy=pad_policy, device=device,
            )
            res["instances_batched"] = 1
            results[i] = res
        return results  # type: ignore[return-value]
    partitions: Dict[Tuple, List[int]] = {}
    for i, p in enumerate(params_list):
        partitions.setdefault(statics_signature(p), []).append(i)
    met = get_metrics()
    for group in partitions.values():
        t_group = time.perf_counter()
        remaining = (
            None if timeout is None
            else max(timeout - (t_group - t0), 0.01)
        )
        group_results = algo_module.solve_host_many(
            [dcops[i] for i in group],
            [params_list[i] for i in group],
            timeout=remaining,
            pad_policy=pad_policy,
            device=device,
        )
        share = (time.perf_counter() - t_group) / len(group)
        if met.enabled:
            met.inc("engine.batch_groups")
        for i, res in zip(group, group_results):
            res["instances_batched"] = len(group)
            res["time"] = share
            results[i] = res
    return results  # type: ignore[return-value]
