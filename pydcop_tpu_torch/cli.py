"""Command-line interface: ``python -m pydcop_tpu_torch <command> ...``.

The port of ``pydcop_tpu/cli.py``, with its 20 commands: one module per
subcommand under ``pydcop_tpu_torch/commands/``: ``solve``, ``infer``,
``run``, ``graph``, ``distribute``, ``generate``, ``batch``,
``consolidate``, ``replica_dist``, ``orchestrator``, ``agent``,
``worker``, ``serve``, ``fleet``, ``top``, ``lint`` (the port's own
contract, ``pydcop_tpu_torch/lint/``), ``trace-summary``,
``flight-dump``, ``bench-history`` and ``bench-compare`` (``lint`` and
the bench commands drive the stdlib tools under ``tools/``, so they run
from a source checkout).  The global options (``-v``, ``--log``,
``-t``/``--timeout``, ``--output``) are accepted before and after the
subcommand, as in the JAX package.  The commands that touch the card
take ``--device`` (``--torch_device`` on ``infer``, whose ``--device``
is the JAX package's offload policy; on ``agent`` it is where an accel
agent's island or the process's shard runs).
"""

from __future__ import annotations

import argparse
import importlib
import logging
import logging.config
import sys

COMMANDS = [
    "solve",
    "infer",
    "run",
    "graph",
    "distribute",
    "generate",
    "batch",
    "consolidate",
    "replica_dist",
    # cross-process runs: the SPMD runtime (default) and --runtime host
    "orchestrator",
    "agent",
    # internal: one elastic-runtime SPMD worker (orchestrator --elastic)
    "worker",
    # resident continuous-batching solver service
    "serve",
    # replicated serving fleet: consistent-hash router + N serve replicas
    "fleet",
    # live terminal view of a serve --metrics_port exporter
    "top",
    # the port's lint contract (pydcop_tpu_torch/lint, tools/graftlint)
    "lint",
    # module trace_summary registers the subcommand as `trace-summary`
    "trace_summary",
    # module flight_dump registers the subcommand as `flight-dump`
    "flight_dump",
    # the bench ledger tooling (tools/benchkeeper) — modules register
    # the subcommands as `bench-history` / `bench-compare`
    "bench_history",
    "bench_compare",
]


def _add_global_args(parser: argparse.ArgumentParser, suppress: bool) -> None:
    """Global options accepted both before and after the subcommand.

    At the sub level defaults are SUPPRESSed so a flag given before the
    subcommand is not clobbered by the subparser's default.
    """

    def d(value):
        return argparse.SUPPRESS if suppress else value

    parser.add_argument(
        "-v", "--verbosity", type=int, default=d(0), help="0..3"
    )
    parser.add_argument(
        "--log", type=str, default=d(None), help="logging config file"
    )
    parser.add_argument(
        "-t", "--timeout", type=float, default=d(None),
        help="wall-clock timeout (seconds)",
    )
    parser.add_argument(
        "--output", type=str, default=d(None),
        help="write the result JSON to this file as well as stdout",
    )


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="pydcop_tpu_torch",
        description="DCOP solving on an NVIDIA GPU (PyTorch/CUDA port "
        "of pydcop_tpu)",
    )
    _add_global_args(parser, suppress=False)
    parser.add_argument("--version", action="version", version="0.1.0")
    global_parent = argparse.ArgumentParser(add_help=False)
    _add_global_args(global_parent, suppress=True)
    sub = parser.add_subparsers(dest="command", required=True)
    for name in COMMANDS:
        mod = importlib.import_module(f"pydcop_tpu_torch.commands.{name}")
        mod.set_parser(_SubparsersProxy(sub, [global_parent]))
    return parser


class _SubparsersProxy:
    """Injects the global-options parent into every add_parser call."""

    def __init__(self, sub, parents):
        self._sub = sub
        self._parents = parents

    def add_parser(self, *args, **kwargs):
        parents = list(kwargs.pop("parents", [])) + self._parents
        return self._sub.add_parser(*args, parents=parents, **kwargs)


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    levels = [logging.ERROR, logging.WARNING, logging.INFO, logging.DEBUG]
    logging.basicConfig(
        level=levels[min(args.verbosity, 3)],
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    if args.log:
        logging.config.fileConfig(args.log, disable_existing_loggers=False)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
