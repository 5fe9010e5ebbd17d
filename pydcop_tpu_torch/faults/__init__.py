"""Deterministic fault plans (port of ``pydcop_tpu/faults``).

:class:`~pydcop_tpu_torch.faults.plan.FaultPlan` is the seeded plan
behind ``--chaos SPEC --chaos_seed N``: every decision is a pure hash
of ``(seed, scope, sequence number, kind)``.  The port injects its
device-layer kinds (``device_oom``, ``device_transient``,
``nan_inject``) at the supervised dispatch
(:mod:`pydcop_tpu_torch.engine.supervisor`).  The message-plane chaos
layer (the JAX package's ``ChaosCommunicationLayer``) belongs to the
host runtime, which the port does not have yet.
"""

from pydcop_tpu_torch.faults.plan import (
    DeviceFaults,
    FaultPlan,
    FaultSpecError,
    FleetFaults,
    LinkFaults,
    Partition,
    WireFaults,
)

__all__ = [
    "DeviceFaults",
    "FaultPlan",
    "FaultSpecError",
    "FleetFaults",
    "LinkFaults",
    "Partition",
    "WireFaults",
]
