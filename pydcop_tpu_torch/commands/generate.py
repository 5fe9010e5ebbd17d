"""``pydcop_tpu_torch generate`` (a copy of
``pydcop_tpu/commands/generate.py``).

Benchmark-problem generators, one sub-subcommand per family:
``graph_coloring``, ``ising``, ``meeting_scheduling``, ``secp``,
``task_scheduling`` and ``agents``.  Each writes a DCOP (or agents) YAML
to stdout or ``--output``; the text equals what ``python -m pydcop_tpu
generate`` writes for the same arguments.
"""

from __future__ import annotations

import argparse
import importlib

from pydcop_tpu_torch.commands.generators import GENERATORS


def set_parser(subparsers) -> None:
    p = subparsers.add_parser(
        "generate", help="generate benchmark DCOP instances"
    )
    sub = p.add_subparsers(dest="generator", required=True)
    # accept the global flags (--output, -t, ...) after the generator
    # name as well, mirroring the top-level CLI wiring
    from pydcop_tpu_torch.cli import _SubparsersProxy, _add_global_args

    parent = argparse.ArgumentParser(add_help=False)
    _add_global_args(parent, suppress=True)
    proxy = _SubparsersProxy(sub, [parent])
    for name in GENERATORS:
        mod = importlib.import_module(
            f"pydcop_tpu_torch.commands.generators.{name}"
        )
        mod.set_parser(proxy)
