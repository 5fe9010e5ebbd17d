"""Numpy table helpers shared by the DPOP engines (a copy of
``pydcop_tpu/algorithms/_tables.py``).

The device path (``algorithms/dpop.py``) and the message-driven host
path (``algorithms/_host_dpop.py``) perform the same UTIL join; the
alignment primitive lives here ONCE so the two engines cannot drift
(and the host engine stays importable without torch weight).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def align_table(
    table: np.ndarray, dims: Sequence[str], target: Sequence[str]
) -> np.ndarray:
    """Transpose + reshape ``table`` (axes named ``dims``) so it
    broadcasts over ``target`` (a superset of ``dims``) — the UTIL
    join primitive: aligned parts simply add."""
    order = [d for d in target if d in dims]
    t = np.transpose(table, [list(dims).index(d) for d in order])
    shape = [t.shape[order.index(d)] if d in dims else 1 for d in target]
    return t.reshape(shape)
