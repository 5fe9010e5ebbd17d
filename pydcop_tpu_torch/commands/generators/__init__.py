"""Problem generators (copies of ``pydcop_tpu/commands/generators/``).

Each module exports ``set_parser(subparsers)`` registering one
``pydcop_tpu_torch generate <kind>`` sub-subcommand whose handler builds
a :class:`~pydcop_tpu_torch.dcop.dcop.DCOP` and writes it as YAML to
stdout or ``--output``, and ``generate(args)`` that builds the DCOP.
The JAX package's ``agents`` generator is not copied.
"""

GENERATORS = [
    "graphcoloring",
    "ising",
    "meetingscheduling",
    "secp",
    "taskscheduling",
]
