"""The port's lint (``python -m pydcop_tpu_torch lint``,
``pydcop_tpu_torch/lint/``).

- The full scan of the port is clean against its baseline, fast, and
  loads neither torch nor jax (in a subprocess).
- One seeded violation per rule of the port's contract is caught, seeded
  in memory through the ``scan(modules=…)`` seam against the real tree
  (as ``tests/test_lint_guard.py`` does for the JAX package), and the
  legal spellings next to them are not.
- graftlint's shared rules give the JAX engine's findings on the rule
  fixtures (``tests/fixtures/lint/``) through the port's ``scan``.
- The command's flags, exit codes and JSON keys are the JAX command's;
  a baseline round trip works; the port's rules stay out of graftlint's
  registry.
"""

import argparse
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from pydcop_tpu_torch import lint as port_lint
from pydcop_tpu_torch.lint import rules as port_rules

pytestmark = pytest.mark.lint

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures" / "lint"

from graftlint import LintConfig, Module, core  # noqa: E402
from graftlint import scan as jax_scan  # noqa: E402

#: the port's scan, measured at 2.8-3.0 s on the CPU box; the budget
#: catches a rule gone quadratic, not scheduler noise
SCAN_BUDGET_SECONDS = 10.0

_PROBE = r"""
import json, sys, time
from pydcop_tpu_torch.cli import main
t0 = time.perf_counter()
rc = main(["lint", "--json"])
print(json.dumps({"rc": rc, "seconds": time.perf_counter() - t0,
                  "torch": "torch" in sys.modules,
                  "jax": "jax" in sys.modules}))
"""


def test_full_scan_is_clean_fast_and_loads_no_library():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], capture_output=True, text=True,
        cwd=REPO, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    text = proc.stdout
    last = json.loads(text.strip().splitlines()[-1])
    report = json.loads(text[: text.rindex("\n{")])
    assert last == {**last, "rc": 0, "torch": False, "jax": False}
    assert report["ok"] is True, report["findings"]
    assert report["findings"] == [] and report["stale"] == []
    assert report["rules"] == sorted(port_rules.RULES)
    assert last["seconds"] < SCAN_BUDGET_SECONDS


def test_the_baseline_entries_name_their_reason():
    baseline = port_lint.load_baseline(REPO / port_lint.BASELINE_RELPATH)
    assert baseline
    for key, why in baseline.items():
        assert not why.startswith("TODO") and "ROADMAP" in why, key


def test_port_rules_stay_out_of_graftlints_registry():
    jax_rules = {
        "jax-import-surface", "lazy-init-eager-import", "impure-call",
        "set-iteration", "chaos-symmetry", "chaos-inert-field",
        "metric-undocumented", "metric-stale-doc", "chaos-clause-doc",
        "span-undocumented", "bare-jit", "unhashable-closure",
    }
    assert set(core.RULES) == jax_rules
    assert set(port_rules.RULES) == set(port_rules.SHARED) | {
        "jax-import", "torch-import-surface", "unseeded-random",
        "kernel-build-site", "cuda-atomics",
    }
    # the shared rules are graftlint's own objects
    for rid in port_rules.SHARED:
        assert port_rules.RULES[rid] is core.RULES[rid]


# -- seeded violations -------------------------------------------------------


@pytest.fixture(scope="module")
def tree():
    config = port_lint.port_config(str(REPO))
    return config, port_lint.load_modules(config)


def _append(text):
    return lambda t: t + "\n\n" + text


#: (case, relpath, transform, rule, expected detail)
SEEDS = [
    ("jax-import", "pydcop_tpu_torch/engine/batched.py",
     _append("def _seeded():\n    import jax\n    return jax\n"),
     "jax-import", "import:jax"),
    ("jax-package-import", "chip_smoke.py",
     _append("def _seeded():\n    from pydcop_tpu.ops import costs\n"
             "    return costs\n"),
     "jax-import", "import:pydcop_tpu.ops"),
    ("jax-import-module", "pydcop_tpu_torch/ops/costs.py",
     _append("def _seeded():\n    import importlib\n"
             "    return importlib.import_module('jaxlib.xla_client')\n"),
     "jax-import", "import:jaxlib.xla_client"),
    ("torch-on-surface", "pydcop_tpu_torch/api.py",
     lambda t: "import torch\n" + t,
     "torch-import-surface", "direct:torch"),
    ("torch-reaches-surface", "pydcop_tpu_torch/telemetry/context.py",
     lambda t: "import pydcop_tpu_torch.device\n" + t,
     "torch-import-surface", "reaches:pydcop_tpu_torch/device.py"),
    ("unseeded-draw", "pydcop_tpu_torch/algorithms/dsa.py",
     _append("def _seeded(n):\n    return torch.rand(n)\n"),
     "unseeded-random", "torch.rand@_seeded"),
    ("tensor-draw", "pydcop_tpu_torch/algorithms/mgm2.py",
     _append("def _seeded(x):\n    return x.uniform_(0, 1)\n"),
     "unseeded-random", ".uniform_@_seeded"),
    ("global-seed", "pydcop_tpu_torch/engine/batched.py",
     _append("def _seeded():\n    torch.manual_seed(0)\n"),
     "unseeded-random", "torch.manual_seed@_seeded"),
    ("cuda-seed", "chip_smoke.py",
     _append("def _seeded(torch):\n    torch.cuda.manual_seed_all(0)\n"),
     "unseeded-random", "torch.cuda.manual_seed_all@_seeded"),
    ("numpy-global", "pydcop_tpu_torch/ops/generate.py",
     _append("def _seeded(n):\n    return np.random.rand(n)\n"),
     "unseeded-random", "numpy.random.rand@_seeded"),
    ("numpy-entropy", "pydcop_tpu_torch/ops/generate.py",
     _append("def _seeded():\n    return np.random.default_rng()\n"),
     "unseeded-random", "numpy.random.default_rng@_seeded"),
    ("impure-plan", "pydcop_tpu_torch/faults/plan.py",
     _append("import time\n\n\ndef _seeded_clock():\n"
             "    return time.time()\n"),
     "impure-call", "time.time@_seeded_clock"),
    ("chaos-dropped", "pydcop_tpu_torch/commands/run.py",
     lambda t: t.replace("device_faults_configured",
                         "device_faults_elsewhere"),
     "chaos-symmetry", "category:device"),
    ("undocumented-counter", "pydcop_tpu_torch/engine/batched.py",
     _append("def _seeded(met):\n"
             "    met.inc('engine.seeded_undocumented')\n"),
     "metric-undocumented", "engine.seeded_undocumented"),
    ("cdll", "pydcop_tpu_torch/ops/maxsum_kernels.py",
     _append("def _seeded(path):\n    import ctypes\n"
             "    return ctypes.CDLL(path)\n"),
     "kernel-build-site", "ctypes.CDLL@_seeded"),
    ("nvcc", "chip_smoke.py",
     _append("def _seeded():\n    subprocess.run(['nvcc', '-o', 'k.so', "
             "'k.cu'])\n"),
     "kernel-build-site", "subprocess.run@_seeded"),
    ("index-add", "pydcop_tpu_torch/ops/costs.py",
     _append("def _seeded(x, i, v):\n    return x.index_add_(0, i, v)\n"),
     "cuda-atomics", "index_add_@_seeded"),
    ("index-put-accumulate", "pydcop_tpu_torch/ops/semiring.py",
     _append("def _seeded(x, i, v):\n"
             "    return x.index_put_((i,), v, accumulate=True)\n"),
     "cuda-atomics", "index_put_@_seeded"),
]


def _mutate(modules, relpath, transform):
    mod = modules[relpath]
    text = transform(mod.text)
    modules[relpath] = Module(relpath=relpath, path=mod.path, text=text,
                              tree=ast.parse(text))


@pytest.mark.parametrize("case,relpath,transform,rule_id,detail", SEEDS,
                         ids=[s[0] for s in SEEDS])
def test_seeded_violation_is_caught(case, relpath, transform, rule_id,
                                    detail, tree):
    config, loaded = tree
    modules = dict(loaded)
    _mutate(modules, relpath, transform)
    found = port_lint.scan(config, modules=modules, rules=[rule_id])
    assert (relpath, detail) in {(f.path, f.detail) for f in found}, found


def test_legal_spellings_are_not_flagged(tree):
    config, loaded = tree
    modules = dict(loaded)
    rel = "pydcop_tpu_torch/algorithms/dsa.py"
    _mutate(modules, rel, _append(
        "def _legal(n, g, x, i, v):\n"
        "    a = torch.rand(\n        n,\n        generator=g,\n    )\n"
        "    g.manual_seed(3)\n"
        "    r = np.random.default_rng(3)\n"
        "    s = np.random.SeedSequence(3)\n"
        "    x.normal_(0, 1, generator=g)\n"
        "    x.index_put_((i,), v)\n"
        "    x.index_put_((i,), v, accumulate=False)\n"
        "    return a, r, s\n"
    ))
    rules = ["unseeded-random", "cuda-atomics", "kernel-build-site"]
    assert not [f for f in port_lint.scan(config, modules=modules,
                                          rules=rules) if f.path == rel]


def test_the_build_module_may_build(tree):
    """ops/_build.py runs nvcc and ctypes.CDLL: the one sanctioned site;
    the same code anywhere else is flagged."""
    config, loaded = tree
    build = loaded["pydcop_tpu_torch/ops/_build.py"]
    rel = "pydcop_tpu_torch/ops/_build2.py"
    moved = Module(relpath=rel, path=None, text=build.text, tree=build.tree)
    found = port_lint.scan(config, modules={**loaded, rel: moved},
                           rules=["kernel-build-site"])
    assert {f.path for f in found} == {rel}
    assert {f.detail.split("@")[0] for f in found} == {
        "ctypes.CDLL", "subprocess.run"}


# -- the shared rules on graftlint's fixtures --------------------------------

_FAMILIES = {
    "import": (("lazy-init-eager-import",), {}),
    "purity": (("impure-call", "set-iteration"),
               {"seeded_modules": ("pkg/seeded.py",)}),
    "chaos": (("chaos-symmetry", "chaos-inert-field"), {}),
    "telemetry": (("metric-undocumented", "metric-stale-doc",
                   "chaos-clause-doc", "span-undocumented"), {}),
}


def _fixture_config(name, **overrides):
    base = dict(
        root=str(FIXTURES / name), scan_roots=("pkg",), package="pkg",
        jax_free_surface=(), seeded_modules=(),
        chaos_plan_module="pkg/plan.py", chaos_kind_categories={},
        chaos_entry_points={}, metrics_code=(), metrics_docs=(),
        faults_doc="docs/faults.md", sanctioned_jit_modules=(),
        runner_builder_modules=(),
    )
    base.update(overrides)
    return LintConfig(**base)


_CHAOS_KW = dict(
    chaos_kind_categories={"drop": "message", "device_oom": "device"},
    chaos_entry_points={"pkg/entry.py": {}},
)
_TELEMETRY_KW = dict(
    metrics_code=("pkg/*",), metrics_docs=("docs/metrics.md",),
    trace_summary_module="pkg/summary.py",
)


@pytest.mark.parametrize("fixture", sorted(
    f"{fam}_{sign}" for fam in _FAMILIES for sign in ("pos", "neg")))
def test_shared_rules_give_the_jax_engines_findings(fixture):
    family = fixture.rsplit("_", 1)[0]
    rules, kw = _FAMILIES[family]
    kw = {**kw, **{"chaos": _CHAOS_KW, "telemetry": _TELEMETRY_KW}.get(
        family, {})}
    config = _fixture_config(fixture, **kw)
    want = jax_scan(config, rules=rules)
    got = port_lint.scan(config, rules=rules)
    assert got == want
    if fixture.endswith("_pos"):
        assert want  # the fixture fires: the comparison is not empty


# -- the command ---------------------------------------------------------------


def _args(**over):
    base = dict(as_json=False, update_baseline=False, baseline=None,
                root=None, rule=None)
    base.update(over)
    return argparse.Namespace(**base)


def _lint_parsers():
    from pydcop_tpu import cli as jax_cli
    from pydcop_tpu_torch import cli as port_cli

    def sub(parser):
        return next(a for a in parser._actions
                    if hasattr(a, "choices") and a.choices
                    and "lint" in a.choices).choices["lint"]

    return sub(jax_cli.build_parser()), sub(port_cli.build_parser())


def test_lint_takes_the_jax_commands_flags():
    jp, pp = _lint_parsers()

    def options(p):
        return sorted((tuple(a.option_strings), a.dest, repr(a.default),
                       type(a).__name__) for a in p._actions)

    assert options(pp) == options(jp)


def _tiny_tree(root, clean):
    """A checkout of one module per package: a violation of one rule of
    each contract (a bare jit; a jax import in the port), or none."""
    for pkg, head, body in (
        ("pydcop_tpu", "import jax", "    return jax.jit(f)\n"),
        ("pydcop_tpu_torch", "import os", "    import jax\n"),
    ):
        (root / pkg).mkdir(parents=True, exist_ok=True)
        text = f"{head}\n\n\ndef seeded(f):\n" + (
            "    return f\n" if clean else body)
        (root / pkg / "x.py").write_text(text)
    return str(root)


def test_exit_codes_and_json_keys_equal_the_jax_commands(tmp_path, capsys):
    from graftlint.cli import run as jax_run

    dirty = _tiny_tree(tmp_path / "dirty", clean=False)
    clean = _tiny_tree(tmp_path / "clean", clean=True)
    for run, rule in ((jax_run, "bare-jit"), (port_lint.run, "jax-import")):
        # unknown rule: usage error
        assert run(_args(root=dirty, rule=["no-such-rule"])) == 2
        # --update-baseline with --rule: refused
        assert run(_args(root=dirty, rule=[rule],
                         update_baseline=True)) == 2
        # a finding no baseline pins: exit 1, the FAILED line
        assert run(_args(root=dirty, rule=[rule])) == 1
        out = capsys.readouterr().out
        assert f"/x.py:5: [{rule}]" in out
        assert "graftlint: FAILED — 1 new, 0 baselined, 0 stale" in out
    keys = []
    for run, rule in ((jax_run, "bare-jit"), (port_lint.run, "jax-import")):
        assert run(_args(root=clean, rule=[rule], as_json=True)) == 0
        doc = json.loads(capsys.readouterr().out)
        assert doc["ok"] is True and doc["findings"] == []
        keys.append(sorted(doc))
    assert keys[0] == keys[1] == sorted(
        ["ok", "findings", "baselined", "baselined_keys", "stale", "rules",
         "scan_seconds"])


def test_baseline_round_trip(tmp_path, capsys):
    root = _tiny_tree(tmp_path, clean=False)
    (tmp_path / "pydcop_tpu_torch" / "y.py").write_text(
        "def seeded(x, i, v):\n    return x.index_add_(0, i, v)\n")
    baseline = tmp_path / "baseline.json"
    kept = "jax-import::pydcop_tpu_torch/x.py::import:jax"
    baseline.write_text(json.dumps(
        {"version": 1, "findings": {kept: "kept: the seeded import"}}))
    args = dict(root=root, baseline=str(baseline))
    assert port_lint.run(_args(**args)) == 1  # index_add_ is new
    assert port_lint.run(_args(update_baseline=True, **args)) == 0
    capsys.readouterr()
    pinned = json.loads(baseline.read_text())["findings"]
    assert pinned.pop(kept) == "kept: the seeded import"
    assert "cuda-atomics::pydcop_tpu_torch/y.py::index_add_@seeded" in pinned
    # the rest: the contract's scopes and entry points this tiny tree
    # lacks, pinned for review
    assert all(v.startswith("TODO") for v in pinned.values())
    assert port_lint.run(_args(**args)) == 0
    out = capsys.readouterr().out
    assert out.startswith("graftlint: clean — 0 new, ") and " 0 stale" in out
    # a fixed violation leaves a stale entry, which fails the run
    (tmp_path / "pydcop_tpu_torch" / "y.py").write_text("")
    assert port_lint.run(_args(**args)) == 1
    assert "no longer found" in capsys.readouterr().out
