"""k-resilient computation replication (reference: ``pydcop/replication/``;
a copy of ``pydcop_tpu/replication/``, whose reparation solve runs on the
port's ``api.solve``).

``ucs_hostingcosts`` places k replicas of every active computation on
other agents, minimizing hosting + route costs (the reference's DRPM
distributed-UCS semantics, computed as a host-side control-plane step —
see the module docstring for the equivalence argument).  ``repair``
re-hosts orphaned computations after an agent departure by building a
small *reparation DCOP* and solving it with this framework's own
batched engine.
"""

from pydcop_tpu_torch.replication.ucs_hostingcosts import (  # noqa: F401
    ReplicaDistribution,
    replica_distribution,
)
from pydcop_tpu_torch.replication.repair import repair_placement  # noqa: F401
