"""Host message-driven runtime (port of ``pydcop_tpu/infrastructure``;
reference: ``pydcop/infrastructure/``).

The batched engine (``pydcop_tpu_torch.engine``) is the production solve
path; this package is the reference-shaped *host* runtime that the
asynchronous algorithms' semantics are anchored to:

- ``computations``: ``Message`` / ``MessagePassingComputation`` base
  classes with ``@register`` handler dispatch;
- ``communication``: the in-process communication layer and the
  per-agent ``Messaging`` router with priority classes and message
  metrics;
- ``agents``: the thread-per-agent execution container;
- ``runtime``: ``solve_host()`` — run a DCOP on this runtime, either
  with real agent threads (``mode='thread'``) or on a deterministic
  seeded single-thread event loop (``mode='sim'``), with
  ``accel_agents`` hosting their subgraph as a compiled island on the
  device;
- ``hostnet``: the cross-process runtime (``mode='process'``, the
  ``orchestrator``/``agent --runtime host`` commands) — agents in OS
  processes exchanging messages over TCP, an accel agent's island on
  its own process's device;
- ``ui``: the live observability feed (SSE ``/events`` and ``/state``)
  of a batched or process run;
- ``orchestrator``: the SPMD cross-process runtime (the
  ``orchestrator``/``agent --runtime spmd`` commands) — every process
  a shard of the sharded batched solve over a ``torch.distributed``
  process group, under a TCP control plane;
- ``elastic``: the same, re-forming the process group on the
  survivors when an agent dies (``orchestrator --elastic`` and the
  ``worker`` command).
"""

from pydcop_tpu_torch.infrastructure.computations import (  # noqa: F401
    DcopComputation,
    Message,
    MessagePassingComputation,
    VariableComputation,
    message_type,
    register,
)
from pydcop_tpu_torch.infrastructure.runtime import solve_host  # noqa: F401
