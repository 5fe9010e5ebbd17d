"""Deterministic fault plans (port of ``pydcop_tpu/faults``).

:class:`~pydcop_tpu_torch.faults.plan.FaultPlan` is the seeded plan
behind ``--chaos SPEC --chaos_seed N``: every decision is a pure hash
of ``(seed, scope, sequence number, kind)``.  The port injects its
device-layer kinds (``device_oom``, ``device_transient``,
``nan_inject``) at the supervised dispatch
(:mod:`pydcop_tpu_torch.engine.supervisor`).
:class:`~pydcop_tpu_torch.faults.chaos.ChaosCommunicationLayer` applies
the message-plane kinds to every outbound message of a thread-mode agent
(``infrastructure/runtime.py``); it loads on first use.
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
    "ChaosCommunicationLayer",
    "DeviceFaults",
    "FaultPlan",
    "FaultSpecError",
    "FleetFaults",
    "LinkFaults",
    "Partition",
    "WireFaults",
]


def __getattr__(name):
    if name == "ChaosCommunicationLayer":
        from pydcop_tpu_torch.faults.chaos import ChaosCommunicationLayer

        return ChaosCommunicationLayer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
