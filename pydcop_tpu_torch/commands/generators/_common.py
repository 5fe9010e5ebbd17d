"""Shared helpers for problem generators (the part of
``pydcop_tpu/commands/generators/_common.py`` the copied generators
use)."""

from __future__ import annotations


def write_dcop(args, dcop) -> int:
    from pydcop_tpu_torch.dcop.yamldcop import dcop_yaml

    text = dcop_yaml(dcop)
    if getattr(args, "output", None):
        with open(args.output, "w") as f:
            f.write(text)
    else:
        print(text)
    return 0
