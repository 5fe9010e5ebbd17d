"""Run-state checkpoints of the batched engine (port of
``pydcop_tpu/engine/checkpoint.py``).

A checkpoint is one ``.npz`` file in the JAX package's layout: every leaf
of the algorithm's state dict under ``state/<key>`` (nested dicts join
their keys with ``/``), the anytime-best assignment under
``best_values``, and a JSON record under ``__meta__`` (the best cost and
the round counter, plus what the caller adds: algorithm, seed, chunk
size, problem fingerprint, restart count).  The engine adds named
arrays of its own (:func:`save_checkpoint`'s ``arrays``: the rounds'
generator state and the cost trace so far).

Loading rebuilds the state from a freshly initialized template of the
same algorithm and problem: no pickling, no code run on load.  bf16
leaves are written as raw 2-byte records (numpy has no bf16; the JAX
package's ``ml_dtypes`` arrays land in the file the same way) and read
back through the template's dtype, never converted.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Iterator, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

_META_KEY = "__meta__"


def _leaves(state: Mapping[str, Any], prefix: str = "") -> Iterator:
    """``(path, top-level key, leaf)`` of a (nested) state dict."""
    for key, leaf in state.items():
        path = f"{prefix}{key}"
        if isinstance(leaf, Mapping):
            for sub, _, inner in _leaves(leaf, path + "/"):
                yield sub, path.split("/")[0], inner
        else:
            yield path, path.split("/")[0], leaf


def _to_numpy(leaf) -> np.ndarray:
    """A leaf as host numpy; bf16 as raw 2-byte records."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def save_checkpoint(
    path: str,
    state: Mapping[str, Any],
    best_cost,
    best_values,
    rounds_done: int,
    extra_meta: Optional[Dict[str, Any]] = None,
    static_keys: Sequence[str] = (),
    arrays: Optional[Mapping[str, np.ndarray]] = None,
) -> None:
    """Write the run state to ``path`` (.npz) atomically: a temporary file
    in the same directory, then ``os.replace``.

    ``best_cost`` is a scalar, or a ``[K]`` vector for a multi-restart
    run (``best_values`` is then the ``[K, n]`` stack).  Leaves under
    ``static_keys`` (an algorithm's ``STATIC_STATE_KEYS``: index data
    ``init_state`` rebuilds) are skipped; the load backfills them from
    the template.  ``arrays`` are stored under their own names."""
    leaves = {}
    for key, top, leaf in _leaves(state):
        if top in static_keys:
            continue
        leaves[f"state/{key}"] = _to_numpy(leaf)
    leaves["best_values"] = _to_numpy(best_values)
    for name, arr in (arrays or {}).items():
        leaves[name] = np.asarray(arr)
    meta = {
        "best_cost": _to_numpy(best_cost).tolist(),
        "rounds_done": int(rounds_done),
        **(extra_meta or {}),
    }
    leaves[_META_KEY] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **leaves)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def checkpoint_meta(path: str) -> Dict[str, Any]:
    """Only the metadata record: callers check compatibility (algorithm,
    seed, chunk size, problem fingerprint, restarts) before the full
    load, with precise messages."""
    with np.load(path, allow_pickle=False) as data:
        return json.loads(bytes(data[_META_KEY]).decode())


def checkpoint_arrays(path: str, names: Sequence[str]) -> Dict[str, np.ndarray]:
    """The named extra arrays present in the file (``save_checkpoint``'s
    ``arrays``)."""
    with np.load(path, allow_pickle=False) as data:
        return {n: data[n] for n in names if n in data.files}


def _restore(key: str, arr: np.ndarray, tmpl) -> Any:
    """One leaf from the file, checked against its template leaf and put
    in the template's type, dtype and device."""
    is_t = isinstance(tmpl, torch.Tensor)
    shape = tuple(tmpl.shape) if is_t else np.shape(tmpl)
    if arr.shape != shape:
        raise ValueError(
            f"Checkpoint leaf {key!r} has shape {arr.shape}, expected "
            f"{shape} — different problem?"
        )
    tdt = tmpl.dtype if is_t else np.dtype(getattr(tmpl, "dtype", arr.dtype))
    itemsize = tdt.itemsize
    if arr.dtype.kind == "V":
        # raw records (bf16 messages): reinterpret through the template's
        # dtype, never convert numerically
        if itemsize != arr.dtype.itemsize:
            raise ValueError(
                f"Checkpoint leaf {key!r} has an opaque "
                f"{arr.dtype.itemsize}-byte dtype; the state template "
                f"expects {_dtype_name(tdt)} — different msg_dtype "
                "setting?"
            )
        raw = np.ascontiguousarray(arr).view(f"i{itemsize}")
        if not is_t:
            return raw.view(tdt)
        return torch.from_numpy(raw).view(tdt).to(tmpl.device)
    if is_t and tdt == torch.bfloat16:
        want = None  # only raw records stand for bf16
    else:
        want = torch.empty(0, dtype=tdt).numpy().dtype if is_t else tdt
    if arr.dtype != want:
        # both directions fail loudly: an f32 checkpoint resumed under
        # msg_dtype='bf16' would otherwise run the job in f32
        raise ValueError(
            f"Checkpoint leaf {key!r} has dtype {arr.dtype}, the state "
            f"template expects {_dtype_name(tdt)} — different msg_dtype "
            "(or algorithm parameter) setting?"
        )
    return torch.from_numpy(arr.copy()).to(tmpl.device) if is_t else arr


def _rebuild(tmpl: Mapping[str, Any], data, path: str, static_keys,
             prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, leaf in tmpl.items():
        full = f"{prefix}{key}"
        if isinstance(leaf, Mapping):
            out[key] = _rebuild(leaf, data, path, static_keys, full + "/")
            continue
        if full.split("/")[0] in static_keys:
            out[key] = leaf
            continue
        name = f"state/{full}"
        if name not in data.files:
            raise ValueError(
                f"Checkpoint {path} misses state leaf {name!r} — was it "
                "written by a different algorithm?"
            )
        out[key] = _restore(name, data[name], leaf)
    return out


def load_checkpoint(
    path: str, state_template: Mapping[str, Any], static_keys=()
) -> Tuple[Dict[str, Any], Any, np.ndarray, int, Dict[str, Any]]:
    """Restore ``(state, best_cost, best_values, rounds_done, meta)``.

    ``best_cost`` is a float for single runs, or a length-K list for
    multi-restart checkpoints (``best_values`` is then ``[K, n]``).

    ``state_template`` (a freshly initialized state of the same algorithm
    and problem) gives the structure, and each leaf's dtype and device;
    every leaf must be in the file with the template's shape and dtype,
    except leaves whose top-level key is in ``static_keys``: those are
    backfilled from the template."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(bytes(data[_META_KEY]).decode())
        state = _rebuild(state_template, data, path, static_keys)
        best_values = data["best_values"]
    return state, meta["best_cost"], best_values, int(meta["rounds_done"]), meta
