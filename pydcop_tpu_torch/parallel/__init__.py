"""Sharded runs over a shard mesh (port of ``pydcop_tpu/parallel``): a
:class:`Mesh` of shards in one process, or a :class:`ProcessMesh`, one
process a shard over ``torch.distributed``."""

from pydcop_tpu_torch.parallel.distributed import (
    CollectiveError,
    ProcessMesh,
    init_process_mesh,
    rank_device,
)
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
    "CollectiveError",
    "Mesh",
    "P",
    "ProcessMesh",
    "ShardAxis",
    "ShardedProblem",
    "init_process_mesh",
    "make_mesh",
    "problem_pspecs",
    "rank_device",
    "shard_problem",
    "state_pspecs",
]
