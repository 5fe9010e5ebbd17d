"""The port's subcommands (one module each; see ``cli.py``)."""
