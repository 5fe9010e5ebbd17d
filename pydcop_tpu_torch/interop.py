"""Build the port's objects from numpy arrays.

This is how a compiled problem or an algorithm state crosses from the
JAX package into the port: the caller turns each array field into numpy
(``np.asarray`` per dataclass field) and hands the leaves here.  The
module itself imports no jax.

Leaf names: the :data:`~pydcop_tpu_torch.ops.compile.ARRAY_FIELDS` of
``CompiledProblem`` as they are, and ``"buckets.<k>.<field>"`` for each
arity bucket's ``tables``, ``tables_t``, ``scopes`` and ``edge_slot``.
``meta`` holds the host-side fields
(:data:`~pydcop_tpu_torch.ops.compile.META_FIELDS`).

bfloat16 numpy arrays (``ml_dtypes.bfloat16``, what ``np.asarray`` of a
jax bf16 array gives) are carried over bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from pydcop_tpu_torch.device import DeviceLike, resolve_device
from pydcop_tpu_torch.ops.compile import (
    ARRAY_FIELDS,
    META_FIELDS,
    ArityBucket,
    CompiledProblem,
)

_BUCKET_FIELDS = tuple(f.name for f in dataclasses.fields(ArityBucket))


def as_tensor(x, device: DeviceLike = "cpu") -> torch.Tensor:
    """numpy array (bfloat16 included) or tensor → tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    a = np.array(x, order="C")  # a writable host copy
    if a.dtype.name == "bfloat16":  # ml_dtypes: reinterpret the bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device
        )
    return torch.from_numpy(a).to(device)


def problem_from_arrays(
    leaves: Mapping[str, np.ndarray],
    meta: Mapping[str, Any],
    device: DeviceLike = None,
) -> CompiledProblem:
    """A :class:`CompiledProblem` on ``device`` from numpy leaves and
    host metadata (names as in the module docstring)."""
    dev = resolve_device(device)
    arrays = {f: as_tensor(leaves[f], dev) for f in ARRAY_FIELDS}
    ks = sorted(
        {int(name.split(".")[1]) for name in leaves
         if name.startswith("buckets.")}
    )
    buckets = {
        k: ArityBucket(
            **{f: as_tensor(leaves[f"buckets.{k}.{f}"], dev)
               for f in _BUCKET_FIELDS}
        )
        for k in ks
    }
    missing = set(META_FIELDS) - set(meta)
    if missing:
        raise ValueError(f"meta lacks {sorted(missing)}")
    return CompiledProblem(
        **arrays,
        buckets=buckets,
        **{f: meta[f] for f in META_FIELDS},
    )


def state_from_arrays(
    state: Mapping[str, np.ndarray], device: DeviceLike = None
) -> Dict[str, torch.Tensor]:
    """An algorithm state dict from numpy arrays, on ``device``, leaf by
    leaf as given: Max-Sum's ``q``, ``r``, ``values``, ``noise``; the
    local-search family's ``values`` (i32, ``[K, n]`` under restarts),
    DBA's ``weights``, GDBA's per-cell ``w{k}``, MGM-2's static pair
    index ``pe_*`` (i32 in the JAX package: the engine's
    ``initial_state`` casts each leaf to the dtype the port's
    ``init_state`` gives it)."""
    dev = resolve_device(device)
    return {k: as_tensor(v, dev) for k, v in state.items()}


def to_numpy(x: torch.Tensor) -> np.ndarray:
    """Tensor → numpy on the host; bfloat16 widens to float32 (exactly)."""
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.numpy()
