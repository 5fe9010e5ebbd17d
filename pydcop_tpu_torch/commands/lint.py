"""``pydcop_tpu_torch lint`` — check the port against its own contract.

The port's counterpart of ``pydcop_tpu lint``: graftlint's engine
(``tools/graftlint``) with the port's rules and contract
(``pydcop_tpu_torch/lint/``): the port imports no jax and no JAX
package, the torch-free surface stays torch-free, seeded scopes stay
pure, random draws name their generator, chaos kinds are accepted or
rejected at every entry point, emitted metrics are documented, kernels
are built only in ``ops/_build.py``, and nothing adds through CUDA
atomics.  Findings diff against ``pydcop_tpu_torch/lint/baseline.json``;
exit 1 on any new or stale finding, 2 on a usage error.

The engine lives under ``tools/``, so this command needs a source
checkout: the one that holds the ``pydcop_tpu_torch`` package.  A scan
is stdlib ``ast`` only and loads neither torch nor jax.
"""

from __future__ import annotations


def set_parser(subparsers) -> None:
    p = subparsers.add_parser(
        "lint",
        help="run the port's lint: jax-free and torch-free imports, "
        "seeded purity and generators, chaos symmetry, telemetry docs, "
        "kernel build sites, no CUDA atomics",
    )
    p.add_argument(
        "--json", action="store_true", dest="as_json",
        help="machine-readable findings (file, line, rule id, "
        "message) for CI annotation",
    )
    p.add_argument(
        "--update-baseline", action="store_true",
        help="pin the current findings into "
        "pydcop_tpu_torch/lint/baseline.json (existing justifications "
        "kept; new entries marked TODO for review)",
    )
    p.add_argument(
        "--baseline", default=None, metavar="FILE",
        help="baseline file (default: pydcop_tpu_torch/lint/baseline.json)",
    )
    p.add_argument(
        "--root", default=None, metavar="DIR",
        help="project root (default: the checkout containing the "
        "pydcop_tpu_torch package)",
    )
    p.add_argument(
        "--rule", action="append", default=None, metavar="RULE_ID",
        help="run only this rule (repeatable)",
    )
    p.set_defaults(func=run_cmd)


def run_cmd(args) -> int:
    try:
        from pydcop_tpu_torch import lint
    except ImportError as e:
        raise SystemExit(f"lint: {e} (pass --root, or run from the "
                         "repository)") from e
    return lint.run(args)
