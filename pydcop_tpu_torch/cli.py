"""Command-line interface: ``python -m pydcop_tpu_torch <command> ...``.

The port's subset of ``pydcop_tpu/cli.py``: one module per subcommand
under ``pydcop_tpu_torch/commands/``: ``solve``, ``run``, ``infer``
and ``generate``.
"""

from __future__ import annotations

import argparse
import importlib
import logging
import sys

COMMANDS = ["solve", "run", "infer", "generate"]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="pydcop_tpu_torch",
        description="DCOP solving on an NVIDIA GPU (PyTorch/CUDA port "
        "of pydcop_tpu)",
    )
    parser.add_argument(
        "-v", "--verbosity", type=int, default=0, help="0..3"
    )
    parser.add_argument("--version", action="version", version="0.1.0")
    sub = parser.add_subparsers(dest="command", required=True)
    for name in COMMANDS:
        mod = importlib.import_module(f"pydcop_tpu_torch.commands.{name}")
        mod.set_parser(sub)
    return parser


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    levels = [logging.ERROR, logging.WARNING, logging.INFO, logging.DEBUG]
    logging.basicConfig(
        level=levels[min(args.verbosity, 3)],
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
