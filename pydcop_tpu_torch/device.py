"""Device placement for the port's entry points.

The port runs on the CUDA device.  The CPU is used only when the caller
asks for it (``device="cpu"``, ``--device cpu``); an entry point never
carries on quietly on the CPU because no card was found.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


class NoCudaDeviceError(RuntimeError):
    """A CUDA device was needed (the default) and none is available."""


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → the current CUDA device; otherwise ``torch.device(device)``.

    Raises :class:`NoCudaDeviceError` when the result is a CUDA device
    and CUDA is not available.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise NoCudaDeviceError(
                "no CUDA device is available; pass device='cpu' "
                "(--device cpu on the CLI) to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
