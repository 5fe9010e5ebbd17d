"""``pydcop_tpu_torch generate`` (a copy of
``pydcop_tpu/commands/generate.py``).

Benchmark-problem generators, one sub-subcommand per family:
``graph_coloring``, ``ising``, ``meeting_scheduling``, ``secp`` and
``task_scheduling``.
Each writes a DCOP YAML to stdout or ``--output``; the text equals what
``python -m pydcop_tpu generate`` writes for the same arguments.
"""

from __future__ import annotations

import argparse
import importlib

from pydcop_tpu_torch.commands.generators import GENERATORS


class _WithOutput:
    """Subparsers whose every parser also takes ``--output``."""

    def __init__(self, sub, parent):
        self._sub, self._parent = sub, parent

    def add_parser(self, *args, **kwargs):
        kwargs.setdefault("parents", []).append(self._parent)
        return self._sub.add_parser(*args, **kwargs)


def set_parser(subparsers) -> None:
    p = subparsers.add_parser(
        "generate", help="generate benchmark DCOP instances"
    )
    sub = p.add_subparsers(dest="generator", required=True)
    parent = argparse.ArgumentParser(add_help=False)
    parent.add_argument(
        "--output", type=str, default=None,
        help="write the YAML to this file instead of stdout",
    )
    for name in GENERATORS:
        mod = importlib.import_module(
            f"pydcop_tpu_torch.commands.generators.{name}"
        )
        mod.set_parser(_WithOutput(sub, parent))
