"""Array-level instance generators (copy of ``pydcop_tpu/ops/generate.py``'s
``coloring_arrays``) — the main path's benchmark workload, built as the
numpy arrays :func:`~pydcop_tpu_torch.ops.compile.compile_from_arrays`
consumes directly."""

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
