"""Problem generators (copies of ``pydcop_tpu/commands/generators/``).

Each module exports ``set_parser(subparsers)`` registering one
``pydcop_tpu_torch generate <kind>`` sub-subcommand whose handler builds
a :class:`~pydcop_tpu_torch.dcop.dcop.DCOP` (or, for ``agents``, an
agents section) and writes it as YAML to stdout or ``--output``; the
DCOP generators also export ``generate(args)`` that builds the DCOP.
"""

GENERATORS = [
    "graphcoloring",
    "ising",
    "meetingscheduling",
    "secp",
    "taskscheduling",
    "agents",
]
