"""Sharded runs over a shard mesh (port of ``pydcop_tpu/parallel``)."""

from pydcop_tpu_torch.parallel.mesh import (
    SHARD_AXIS,
    Mesh,
    P,
    ShardAxis,
    ShardedProblem,
    make_mesh,
    problem_pspecs,
    shard_problem,
    state_pspecs,
)

__all__ = [
    "SHARD_AXIS",
    "Mesh",
    "P",
    "ShardAxis",
    "ShardedProblem",
    "make_mesh",
    "problem_pspecs",
    "shard_problem",
    "state_pspecs",
]
