"""Problem generators (copies of ``pydcop_tpu/commands/generators/``).

Only the SECP generator is copied so far (``secp.generate``), for the
DPOP configurations; the ``generate`` command is not ported yet.
"""
