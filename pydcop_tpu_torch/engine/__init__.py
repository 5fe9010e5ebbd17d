"""The batched engine and its supervised device dispatch.

The supervisor's names are re-exported here, as the JAX package's
``pydcop_tpu/engine/__init__.py`` re-exports them."""

from pydcop_tpu_torch.engine.supervisor import (
    UNSUPERVISED,
    DeviceOOMError,
    DeviceTransientError,
    Supervisor,
    SupervisorConfig,
    UnrecoverableDeviceError,
    classify_failure,
    get_supervisor,
    make_supervisor,
    supervision,
)

__all__ = [
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
]
