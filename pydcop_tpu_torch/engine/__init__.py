"""The batched engine, its supervised device dispatch and the solver
service.

The supervisor's and the service's names are re-exported here, as the
JAX package's ``pydcop_tpu/engine/__init__.py`` re-exports them, and
lazily (PEP 562): the supervisor imports torch, and the service's wire
client must import without it."""

_SUPERVISOR_EXPORTS = (
    "UNSUPERVISED",
    "DeviceOOMError",
    "DeviceTransientError",
    "Supervisor",
    "SupervisorConfig",
    "UnrecoverableDeviceError",
    "classify_failure",
    "get_supervisor",
    "make_supervisor",
    "supervision",
)

_SERVICE_EXPORTS = (
    "ServiceClient",
    "ServiceError",
    "ServiceServer",
    "SolverService",
    "TickPolicy",
)

__all__ = list(_SUPERVISOR_EXPORTS + _SERVICE_EXPORTS)


def __getattr__(name):
    if name in _SUPERVISOR_EXPORTS:
        from pydcop_tpu_torch.engine import supervisor

        return getattr(supervisor, name)
    if name in _SERVICE_EXPORTS:
        from pydcop_tpu_torch.engine import service

        return getattr(service, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
