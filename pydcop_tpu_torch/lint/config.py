"""The port's lint contract: what ``pydcop_tpu_torch lint`` checks the
port against.

:func:`port_config` is the counterpart of graftlint's
``default_config`` (``tools/graftlint/config.py``), which holds the JAX
package's contract.  The shared rules read the same
:class:`graftlint.LintConfig` fields, pointed at the port's paths; the
port's own rules read the fields :class:`PortLintConfig` adds.

Extending it:

- a module joins the torch-free surface by adding its path to
  ``torch_free_surface`` (the static closure: the module and everything
  it imports at module level must import no torch);
- an audited exception is allowed in place with
  ``# graftlint: allow[rule-id] — reason``, never here;
- a finding that has to stay goes into ``lint/baseline.json`` with a
  reason that names its ROADMAP entry.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Tuple

from graftlint.config import LintConfig

PKG = "pydcop_tpu_torch"

#: the port's baseline, beside this module
BASELINE_RELPATH = f"{PKG}/lint/baseline.json"


@dataclass(frozen=True)
class PortLintConfig(LintConfig):
    """graftlint's config plus the fields of the port's own rules."""

    #: import roots no scanned module may import, at any level
    forbidden_import_roots: Tuple[str, ...] = ("jax", "jaxlib", "pydcop_tpu")
    #: relpath globs of the declared torch-free surface
    torch_free_surface: Tuple[str, ...] = ()
    #: the modules that may build and load kernel libraries
    build_modules: Tuple[str, ...] = (f"{PKG}/ops/_build.py",)


def port_config(root: str):
    """The port's contract, rooted at ``root``."""
    root = str(Path(root).resolve())

    def port(*rels):
        return tuple(f"{PKG}/{r}" for r in rels)

    return PortLintConfig(
        root=root,
        scan_roots=(PKG, "chip_smoke.py", "examples/greedy_plugin_torch.py"),
        exclude=(),
        package=PKG,
        # the torch-free surface's import-level check
        # (torch-import-surface) walks the module-level import graph
        # with this root banned
        banned_import_roots=("torch",),
        jax_free_surface=(),
        # The declared torch-free surface: every module whose
        # module-level import closure loads no torch (measured with the
        # rule's own graph; 103 of the 142 scanned files before this
        # package and the tooling commands joined it).  The CLI, the
        # embedding API and ServiceClient import without torch
        # (tests/test_torch_import.py pins that at run time); a lint
        # run loads neither torch nor jax.
        torch_free_surface=(
            "chip_smoke.py",
            *port(
                "__init__.py",
                "__main__.py",
                "api.py",
                "cli.py",
                "commands/*.py",
                "commands/generators/*.py",
                "dcop/*.py",
                "distribution/*.py",
                "graphs/*.py",
                "infrastructure/*.py",
                "replication/*.py",
                "faults/*.py",
                "telemetry/*.py",
                "utils/*.py",
                "lint/*.py",
                "engine/__init__.py",
                "engine/fleet.py",
                "engine/memo.py",
                "engine/service.py",
                "ops/__init__.py",
                "ops/_build.py",
                "ops/generate.py",
                "ops/padding.py",
                "algorithms/__init__.py",
                "algorithms/_host_dpop.py",
                "algorithms/_host_dsa.py",
                "algorithms/_host_maxsum.py",
                "algorithms/_host_syncbb.py",
                "algorithms/_island_common.py",
                "algorithms/_island_dsa.py",
                "algorithms/_island_maxsum.py",
                "algorithms/_tables.py",
                "algorithms/syncbb.py",
            ),
        ),
        # the seeded scopes of the JAX contract, at their port paths
        seeded_modules=port(
            "faults/*.py",
            "utils/backoff.py",
            "telemetry/context.py",
        ),
        seeded_functions={
            f"{PKG}/engine/supervisor.py": (
                "classify_failure",
                "Supervisor._inject",
                "Supervisor._next_seq",
                "Supervisor._record_fault",
            ),
            f"{PKG}/engine/service.py": (
                "SolverService._shed_reason_locked",
                "ServiceServer._cache_reply",
                "ServiceClient.__init__",
            ),
            f"{PKG}/engine/fleet.py": (
                "HashRing.lookup",
                "HashRing.successors",
                "HashRing.next_alive",
                "FleetRouter._pick_owner",
                "ring_key",
            ),
        },
        chaos_plan_module=f"{PKG}/faults/plan.py",
        chaos_kind_categories={
            "drop": "message",
            "dup": "message",
            "duplicate": "message",
            "reorder": "message",
            "delay": "message",
            "partition": "schedule",
            "crash": "schedule",
            "device_oom": "device",
            "device_oom_bytes": "device",
            "device_transient": "device",
            "nan_inject": "device",
            "conn_drop": "wire",
            "slow_client": "wire",
            "frame_corrupt": "wire",
            "replica_kill": "fleet",
        },
        chaos_entry_points={
            # api.solve / solve_many: every category, per mode
            f"{PKG}/api.py": {},
            # run: crashes and device kinds accepted, the rest rejected
            f"{PKG}/commands/run.py": {},
            # the service: device kinds go to the supervised dispatch
            f"{PKG}/engine/service.py": {
                "device": ("device_faults_configured", "make_supervisor"),
            },
            # agent/orchestrator: message and crash kinds flow into the
            # host runtimes; device, wire and fleet kinds are rejected
            f"{PKG}/commands/agent.py": {
                "message": ("message_faults_configured", "run_host_agent"),
                "schedule": ("crashes", "run_host_agent"),
            },
            f"{PKG}/commands/orchestrator.py": {
                "message": (
                    "message_faults_configured",
                    "run_host_orchestrator",
                ),
                "schedule": ("crashes", "run_host_orchestrator"),
            },
            # fleet: the one entry point that accepts the fleet kinds
            f"{PKG}/commands/fleet.py": {
                "fleet": ("fleet_faults_configured", "decide_replica_kill"),
            },
        },
        metrics_code=(f"{PKG}/*",),
        # the JAX package's registry, unchanged, plus the port's README
        # section (the port-only names: island.*, spmd.*, kernel.*)
        metrics_docs=("docs/observability.md", "docs/serving.md", "README.md"),
        doc_token_ignore=(
            # trace span names, checked by span-undocumented
            "semiring.contract",
            "semiring.downward",
            "service.dispatch",
            "service.queue-wait",
            "service.request",
            "service.drain",
            "client.request",
            "client.attempt",
            "telemetry.jit.profiled_jit",
        ),
        trace_summary_module=f"{PKG}/telemetry/summary.py",
        faults_doc="docs/faults.md",
        clause_token_ignore=(
            "key", "name", "seed", "p", "w", "n",
            "chaos", "chaos_seed", "status", "on_numeric_fault", "kind",
        ),
        # the port has no jit: bare-jit and unhashable-closure have no
        # counterpart (ROADMAP C, "Lint rules without a counterpart")
        sanctioned_jit_modules=(),
        runner_builder_modules=(),
    )
