"""Shared helpers for problem generators (a copy of
``pydcop_tpu/commands/generators/_common.py``)."""

from __future__ import annotations

import random
from typing import List, Tuple


def write_dcop(args, dcop) -> int:
    from pydcop_tpu_torch.dcop.yamldcop import dcop_yaml

    text = dcop_yaml(dcop)
    if getattr(args, "output", None):
        with open(args.output, "w") as f:
            f.write(text)
    else:
        print(text)
    return 0


def random_graph_edges(
    rnd: random.Random, n: int, p: float
) -> List[Tuple[int, int]]:
    """Erdős–Rényi G(n, p), forced connected by chaining any isolated
    vertex to a random earlier one (as the reference generator does to
    keep instances solvable/communicating)."""
    edges = set()
    for i in range(n):
        for j in range(i + 1, n):
            if rnd.random() < p:
                edges.add((i, j))
    if n < 2:
        return sorted(edges)  # a single vertex has no edges to force
    degree = [0] * n
    for i, j in edges:
        degree[i] += 1
        degree[j] += 1
    for i in range(n):
        if degree[i] == 0:
            j = rnd.randrange(n - 1)
            if j >= i:
                j += 1
            edges.add((min(i, j), max(i, j)))
            degree[i] += 1
            degree[j] += 1
    return sorted(edges)


def grid_edges(rows: int, cols: int) -> List[Tuple[int, int]]:
    """4-neighborhood grid; vertex id = r * cols + c."""
    edges = []
    for r in range(rows):
        for c in range(cols):
            v = r * cols + c
            if c + 1 < cols:
                edges.append((v, v + 1))
            if r + 1 < rows:
                edges.append((v, v + cols))
    return edges


def scalefree_edges(
    rnd: random.Random, n: int, m: int
) -> List[Tuple[int, int]]:
    """Barabási–Albert preferential attachment with m edges per new
    vertex."""
    if n <= m:
        raise SystemExit(
            f"scale-free graph needs variables_count > m ({n} <= {m})"
        )
    edges = set()
    targets = list(range(m))
    repeated: List[int] = []
    for v in range(m, n):
        for t in targets:
            edges.add((min(v, t), max(v, t)))
        repeated.extend(targets)
        repeated.extend([v] * m)
        # draw until m DISTINCT targets (networkx _random_subset
        # semantics): sampling positions from the multiset can repeat a
        # vertex, which would silently drop edges after dedup
        chosen: List[int] = []
        while len(chosen) < m:
            t = rnd.choice(repeated)
            if t not in chosen:
                chosen.append(t)
        targets = chosen
    return sorted(edges)
