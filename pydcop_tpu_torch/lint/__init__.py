"""The port's lint: graftlint's engine run against the port's contract.

``python -m pydcop_tpu_torch lint`` checks ``pydcop_tpu_torch/``,
``chip_smoke.py`` and ``examples/greedy_plugin_torch.py`` against
:func:`~pydcop_tpu_torch.lint.config.port_config`, with the rules of
:data:`~pydcop_tpu_torch.lint.rules.RULES`, and diffs the findings
against ``pydcop_tpu_torch/lint/baseline.json``.

The engine is graftlint's (``tools/graftlint``: module loading, the
``graftlint: allow[...]`` marker, the AST helpers, the baseline), found
in the checkout that holds this package; it is stdlib-only and imports
nothing of the JAX package, so a scan loads neither torch nor jax.  The
port keeps its own registry and its own :func:`scan`, so that its rules
never enter graftlint's.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

#: the checkout holding this package, and graftlint in it
CHECKOUT = Path(__file__).resolve().parent.parent.parent
TOOLS = CHECKOUT / "tools"

if not (TOOLS / "graftlint" / "__init__.py").is_file():
    raise ImportError(
        f"{TOOLS}/graftlint not found — the port's lint drives graftlint "
        "and runs from a source checkout"
    )
if str(TOOLS) not in sys.path:
    sys.path.insert(0, str(TOOLS))

from graftlint.baseline import (  # noqa: E402
    diff_baseline,
    load_baseline,
    save_baseline,
)
from graftlint.core import Context, Finding, Module, load_modules  # noqa: E402

from pydcop_tpu_torch.lint.config import (  # noqa: E402
    BASELINE_RELPATH,
    port_config,
)
from pydcop_tpu_torch.lint.rules import RULES  # noqa: E402

#: the README section that documents the port's own names
README = "README.md"
README_SECTION = "## PyTorch/CUDA port"


def readme_section(root) -> Optional[str]:
    """README.md with every line outside the port's section blanked (so
    findings keep the file's line numbers), or None without one."""
    path = Path(root) / README
    if not path.is_file():
        return None
    out, inside = [], False
    for line in path.read_text(encoding="utf-8").splitlines():
        if line.startswith("## "):
            inside = line.strip() == README_SECTION
        out.append(line if inside else "")
    return "\n".join(out)


def scan(
    config,
    modules: Optional[Dict[str, Module]] = None,
    docs: Optional[Dict[str, str]] = None,
    rules: Optional[Iterable[str]] = None,
) -> List[Finding]:
    """Run the port's (selected) rules; graftlint's ``scan`` with the
    port's registry.  ``modules``/``docs`` override disk loading (the
    seam the seeded-violation tests use)."""
    if modules is None:
        modules = load_modules(config)
    docs = dict(docs or {})
    if README in config.metrics_docs and README not in docs:
        docs[README] = readme_section(config.root)
    ctx = Context(config, modules, docs)
    findings: List[Finding] = []
    for rel, mod in sorted(modules.items()):
        err = getattr(mod.tree, "_graftlint_syntax_error", None)
        if err is not None:
            findings.append(Finding(
                rule="parse-error", path=rel, line=err.lineno or 1,
                message=f"syntax error: {err.msg}", detail="syntax",
            ))
    selected = sorted(set(rules)) if rules is not None else sorted(RULES)
    for rule_id in selected:
        for f in RULES[rule_id].check(ctx):
            mod = modules.get(f.path)
            if mod is not None and ctx.allowed(mod, f.line, f.rule):
                continue
            findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.detail))
    return findings


def run(args) -> int:
    """The ``lint`` command: graftlint's CLI contract (exit 0 clean, 1 a
    new or stale finding, 2 usage; the same text line and JSON keys)."""
    root = Path(args.root).resolve() if args.root else CHECKOUT
    if not root.is_dir():
        print(f"graftlint: root {root} is not a directory", file=sys.stderr)
        return 2
    config = port_config(str(root))
    baseline_path = (
        Path(args.baseline) if args.baseline else root / BASELINE_RELPATH
    )
    rules = args.rule
    if rules is not None:
        unknown = sorted(set(rules) - set(RULES))
        if unknown:
            print(
                f"graftlint: unknown rule(s) {', '.join(unknown)}; "
                f"known: {', '.join(sorted(RULES))}",
                file=sys.stderr,
            )
            return 2
    t0 = time.perf_counter()
    findings = scan(config, rules=rules)
    elapsed = time.perf_counter() - t0
    try:
        baseline = load_baseline(baseline_path)
    except ValueError as e:
        print(f"graftlint: {e}", file=sys.stderr)
        return 2
    if rules is not None:
        baseline = {
            k: v for k, v in baseline.items()
            if k.split("::", 1)[0] in set(rules)
        }
    d = diff_baseline(findings, baseline)

    if args.update_baseline:
        if rules is not None:
            print(
                "graftlint: --update-baseline with --rule would drop "
                "the other rules' entries; run it unfiltered",
                file=sys.stderr,
            )
            return 2
        save_baseline(baseline_path, findings, baseline)
        print(
            f"graftlint: baseline updated — {len(findings)} pinned "
            f"finding(s) in {baseline_path}"
        )
        return 0

    if args.as_json:
        print(json.dumps({
            "ok": d.clean,
            "findings": [f.to_dict() for f in d.new],
            "baselined": len(d.baselined),
            "baselined_keys": sorted(f.key for f in d.baselined),
            "stale": d.stale,
            "rules": sorted(RULES) if rules is None else sorted(rules),
            "scan_seconds": round(elapsed, 3),
        }, indent=2))
    else:
        for f in d.new:
            print(f"{f.path}:{f.line}: [{f.rule}] {f.message}")
        for key in d.stale:
            print(
                f"baseline: [{key}] no longer found — remove the entry "
                "(pydcop_tpu_torch lint --update-baseline)"
            )
        status = "clean" if d.clean else "FAILED"
        print(
            f"graftlint: {status} — {len(d.new)} new, "
            f"{len(d.baselined)} baselined, {len(d.stale)} stale "
            f"({elapsed:.2f}s)"
        )
    return 0 if d.clean else 1
