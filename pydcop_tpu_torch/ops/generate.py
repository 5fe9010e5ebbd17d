"""Array-level instance generators (copies of ``pydcop_tpu/ops/generate.py``'s
``coloring_arrays`` and ``ising_arrays``) — the benchmark workloads,
built as the numpy arrays
:func:`~pydcop_tpu_torch.ops.compile.compile_from_arrays` consumes
directly."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def coloring_arrays(
    n_vars: int,
    colors: int = 3,
    degree: int = 3,
    seed: int = 0,
    noise: float = 0.02,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Random soft graph coloring: ``(scopes, table, unary)``.

    Each variable proposes ``degree`` random neighbors (self-loops and
    duplicate edges dropped), every edge pays cost 1 when its endpoints
    pick the same color, and tiny noisy unary preferences (level
    ``noise``) break the symmetry.

    Returns arrays for :func:`compile_from_arrays`: ``scopes i32[m,2]``,
    the shared ``table f32[colors, colors]`` (identity penalty), and
    ``unary f32[n_vars, colors]``.
    """
    rng = np.random.default_rng(seed)
    i = np.repeat(np.arange(n_vars, dtype=np.int64), degree)
    j = rng.integers(0, n_vars, size=n_vars * degree)
    a, b = np.minimum(i, j), np.maximum(i, j)
    keep = a != b
    pairs = np.unique(
        np.stack([a[keep], b[keep]], axis=1), axis=0
    ).astype(np.int32)
    table = np.eye(colors, dtype=np.float32)
    unary = (noise * rng.random((n_vars, colors))).astype(np.float32)
    return pairs, table, unary


def ising_arrays(
    rows: int,
    cols: int,
    seed: int = 0,
    bin_range: float = 1.6,
    un_range: float = 0.05,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Toroidal Ising grid: ``(scopes, tables, unary)``.

    The classic DCOP benchmark family (reference: ``pydcop generate
    ising``): spin variables on a ``rows x cols`` torus, random
    symmetric pairwise couplings in ``[-bin_range, bin_range]`` and
    random unary fields in ``[-un_range, un_range]``.  Tables are
    per-edge here (couplings differ), ``f32[m, 2, 2]``.
    """
    rng = np.random.default_rng(seed)
    n = rows * cols
    idx = np.arange(n, dtype=np.int64).reshape(rows, cols)
    right = np.stack([idx, np.roll(idx, -1, axis=1)], axis=-1)
    down = np.stack([idx, np.roll(idx, -1, axis=0)], axis=-1)
    pairs = np.concatenate(
        [right.reshape(-1, 2), down.reshape(-1, 2)]
    )
    # torus wrap can duplicate an edge when a dimension has size <= 2
    a = pairs.min(axis=1)
    b = pairs.max(axis=1)
    keep = a != b
    pairs = np.unique(np.stack([a[keep], b[keep]], axis=1), axis=0)
    m = len(pairs)
    k = rng.uniform(-bin_range, bin_range, size=m).astype(np.float32)
    # cost(si, sj) = k if si == sj else -k  (spins in {0, 1})
    eye = np.eye(2, dtype=np.float32)
    tables = k[:, None, None] * (2.0 * eye - 1.0)[None]
    unary_r = rng.uniform(-un_range, un_range, size=n).astype(np.float32)
    unary = np.stack([-unary_r, unary_r], axis=1)
    return pairs.astype(np.int32), tables, unary
