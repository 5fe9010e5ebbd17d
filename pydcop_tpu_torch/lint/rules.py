"""The port's lint rules: graftlint's shared rules plus the port's own.

:data:`RULES` is the port's registry.  It holds graftlint's rule objects
for the contracts both packages share (import laziness, determinism
purity, chaos symmetry, telemetry drift), taken from
``graftlint.core.RULES`` as they are, and the port's own rules below.
Nothing here registers into ``graftlint.core.RULES``: graftlint's
``scan()`` runs every rule registered there, so a port rule in it would
run inside the JAX package's own lint.

The port's own rules:

- ``jax-import`` — no scanned module imports ``jax``, ``jaxlib`` or the
  JAX package, at any level (inside functions too, and through
  ``importlib.import_module``/``__import__`` with a literal name);
- ``torch-import-surface`` — the declared torch-free surface imports no
  ``torch`` at module level, directly or through the module-level
  imports of other port modules (graftlint's import graph, with
  ``torch`` as the banned root);
- ``unseeded-random`` — every random draw names its ``generator=``
  (explicit generators are the port's counterpart of jax keys); no
  global seeding (``torch.manual_seed``, ``torch.seed``,
  ``torch.cuda.manual_seed*``); no draw from numpy's global stream
  (``np.random.default_rng(seed)``/``SeedSequence(seed)`` stay legal);
- ``kernel-build-site`` — kernel libraries are built and loaded only in
  ``ops/_build.py``: no ``ctypes.CDLL``/``ctypes.cdll``, no
  ``cpp_extension.load``, no ``nvcc`` subprocess anywhere else;
- ``cuda-atomics`` — no ``index_add_``, ``scatter_add_``,
  ``scatter_reduce_`` or ``index_put_(…, accumulate=True)``: CUDA adds
  them in arrival order, and the card would no longer equal the CPU
  bit for bit.
"""

from __future__ import annotations

import ast
import fnmatch
import re
from typing import Dict, Iterator, List, Optional, Tuple

import graftlint.rules  # noqa: F401 — registers graftlint's own rules
from graftlint import core
from graftlint.core import (
    Finding,
    Module,
    Rule,
    enclosing_qualnames,
    imported_names,
    resolve_call,
    resolve_name,
)
from graftlint.rules.imports import _ImportGraph, _import_entries

#: graftlint's rules that hold for the port as they are
SHARED = (
    "lazy-init-eager-import",
    "impure-call",
    "set-iteration",
    "chaos-symmetry",
    "chaos-inert-field",
    "chaos-clause-doc",
    "metric-undocumented",
    "metric-stale-doc",
    "span-undocumented",
)

#: the port's registry: rule id -> graftlint Rule
RULES: Dict[str, Rule] = {rid: core.RULES[rid] for rid in SHARED}


def rule(rule_id: str, summary: str):
    """Register a port rule in :data:`RULES` (not graftlint's)."""

    def deco(fn):
        if rule_id in RULES:
            raise ValueError(f"duplicate rule id {rule_id!r}")
        RULES[rule_id] = Rule(rule_id, summary, fn)
        return fn

    return deco


class _Index:
    """One walk of a module: its calls, its import statements, and the
    names its imports bind (what the port's rules look at)."""

    def __init__(self, mod: Module):
        self.calls: List[ast.Call] = []
        self.import_nodes: List[ast.stmt] = []
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call):
                self.calls.append(node)
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                self.import_nodes.append(node)
        self.imports = imported_names(
            ast.Module(body=self.import_nodes, type_ignores=[])
        )
        self._tree = mod.tree
        self._qmap = None

    def qualname(self, lineno: int) -> str:
        if self._qmap is None:  # built on the first finding only
            self._qmap = enclosing_qualnames(self._tree)
        return self._qmap[lineno]


def _indexed(ctx) -> Iterator[Tuple[str, Module, _Index]]:
    """Every scanned module with its :class:`_Index`, built once a
    module (kept on the parsed module) and shared by the rules."""
    for rel, mod in sorted(ctx.modules.items()):
        ix = mod.__dict__.get("_port_index")
        if ix is None:
            ix = mod.__dict__["_port_index"] = _Index(mod)
        yield rel, mod, ix


def _literal_import(node: ast.Call, imports) -> Optional[str]:
    """The module named by ``importlib.import_module("x")`` or
    ``__import__("x")``, when the name is a literal."""
    target = resolve_call(node, imports)
    if target not in ("importlib.import_module", "__import__"):
        return None
    if node.args and isinstance(node.args[0], ast.Constant):
        value = node.args[0].value
        if isinstance(value, str) and not value.startswith("."):
            return value
    return None


# -- imports --------------------------------------------------------------


@rule(
    "jax-import",
    "no port module imports jax, jaxlib or the JAX package, at any level",
)
def check_jax_import(ctx):
    banned = set(ctx.config.forbidden_import_roots)
    for rel, mod, ix in _indexed(ctx):
        names: List[Tuple[str, int]] = []
        for node in ix.import_nodes:
            names += [(m, ln) for m, ln, _ in _import_entries(mod, node)]
        for node in ix.calls:
            lit = _literal_import(node, ix.imports)
            if lit is not None:
                names.append((lit, node.lineno))
        for name, line in names:
            if name.split(".")[0] in banned:
                yield Finding(
                    rule="jax-import",
                    path=rel,
                    line=line,
                    message=(
                        f"imports `{name}` — the port stands alone: it "
                        "imports neither jax nor the JAX package (keep a "
                        "copy of what it needs in the port)"
                    ),
                    detail=f"import:{name}",
                )


@rule(
    "torch-import-surface",
    "declared torch-free modules must not import torch at module level, "
    "directly or transitively",
)
def check_torch_free_surface(ctx):
    graph = _ImportGraph(ctx)  # banned roots: the config's ("torch",)
    for mod in ctx.match(ctx.config.torch_free_surface):
        rel = mod.relpath
        if rel in graph.direct:
            modname, line = graph.direct[rel]
            yield Finding(
                rule="torch-import-surface",
                path=rel,
                line=line,
                message=(
                    f"module-level `import {modname}` on the declared "
                    "torch-free surface — move it into the function that "
                    "needs it"
                ),
                detail=f"direct:{modname.split('.')[0]}",
            )
            continue
        path = graph.jax_path(rel)
        if path is not None and len(path) > 1:
            culprit = path[-1]
            modname, line = graph.direct[culprit]
            hop_line = next(
                (ln for t, ln, _mn in graph.edges[rel] if t == path[1]), 1
            )
            yield Finding(
                rule="torch-import-surface",
                path=rel,
                line=hop_line,
                message=(
                    "torch reaches this torch-free module through "
                    f"module-level imports: {' -> '.join(path)} (which "
                    f"does `import {modname}` at line {line}) — defer "
                    "the first hop into a function"
                ),
                detail=f"reaches:{culprit}",
            )


# -- random streams ---------------------------------------------------------

_TORCH_DRAWS = {
    f"torch.{n}"
    for n in (
        "rand", "randn", "randint", "randperm", "bernoulli",
        "multinomial", "normal", "poisson",
    )
}
#: in-place and method draws on a tensor
_TENSOR_DRAWS = {
    "uniform_", "normal_", "random_", "bernoulli_", "exponential_",
    "geometric_", "log_normal_", "cauchy_",
}
_GLOBAL_SEEDS = {
    "torch.manual_seed", "torch.seed", "torch.random.manual_seed",
    "torch.random.seed", "torch.cuda.seed", "torch.cuda.seed_all",
}
#: numpy's explicit streams: legal when given a seed
_NUMPY_SEEDED = {
    "default_rng", "SeedSequence", "Generator", "RandomState",
    "PCG64", "PCG64DXSM", "Philox", "SFC64", "MT19937",
}


def _has_generator(node: ast.Call) -> bool:
    for kw in node.keywords:
        if kw.arg == "generator":
            return not (
                isinstance(kw.value, ast.Constant) and kw.value.value is None
            )
    return False


def _random_violation(node: ast.Call, imports) -> Optional[Tuple[str, str]]:
    """(target, why) when the call draws or seeds outside an explicit
    generator."""
    target = resolve_call(node, imports)
    if target in _GLOBAL_SEEDS or (
        target or ""
    ).startswith("torch.cuda.manual_seed"):
        return target, "seeds a global stream"
    if target in _TORCH_DRAWS:
        if _has_generator(node):
            return None
        return target, "draws without `generator=`"
    if target and target.startswith("numpy.random."):
        name = target.split(".")[2]
        if name in _NUMPY_SEEDED:
            if node.args or node.keywords or name == "Generator":
                return None
            return target, "draws its seed from the OS"
        return target, "draws from numpy's global stream"
    if (
        isinstance(node.func, ast.Attribute)
        and node.func.attr in _TENSOR_DRAWS
        and not _has_generator(node)
    ):
        return f".{node.func.attr}", "draws without `generator=`"
    return None


@rule(
    "unseeded-random",
    "random draws name their generator; no global seeding, no numpy "
    "global stream",
)
def check_unseeded_random(ctx):
    for rel, _mod, ix in _indexed(ctx):
        for node in ix.calls:
            hit = _random_violation(node, ix.imports)
            if hit is None:
                continue
            target, why = hit
            qual = ix.qualname(node.lineno)
            yield Finding(
                rule="unseeded-random",
                path=rel,
                line=node.lineno,
                message=(
                    f"`{target}` in `{qual}` {why} — the port draws from "
                    "an explicit torch.Generator (or a seeded numpy "
                    "Generator), so that a seed replays on the card and "
                    "the CPU alike"
                ),
                detail=f"{target}@{qual}",
            )


# -- kernel builds ------------------------------------------------------------

_LOADERS = {
    "ctypes.CDLL", "ctypes.PyDLL", "ctypes.LibraryLoader",
    "torch.utils.cpp_extension.load",
    "torch.utils.cpp_extension.load_inline",
}
_LOADER_PREFIXES = ("ctypes.cdll.", "ctypes.pydll.")
_SUBPROCESS = {
    "subprocess.run", "subprocess.Popen", "subprocess.call",
    "subprocess.check_call", "subprocess.check_output", "os.system",
    "os.popen",
}
_NVCC_RE = re.compile(r"(^|[/\s])nvcc(\s|$)")


def _mentions_nvcc(node: ast.Call) -> bool:
    """A literal ``nvcc`` command, or a name such as ``_nvcc()`` that
    stands for one, among the call's arguments."""
    for sub in ast.walk(node):
        if sub is node.func:
            continue
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            if _NVCC_RE.search(sub.value):
                return True
        elif isinstance(sub, ast.Name) and "nvcc" in sub.id.lower():
            return True
        elif isinstance(sub, ast.Attribute) and "nvcc" in sub.attr.lower():
            return True
    return False


@rule(
    "kernel-build-site",
    "kernel libraries are built and loaded only in ops/_build.py",
)
def check_kernel_build_site(ctx):
    allowed = ctx.config.build_modules
    for rel, _mod, ix in _indexed(ctx):
        if any(fnmatch.fnmatch(rel, pat) for pat in allowed):
            continue
        for node in ix.calls:
            target = resolve_call(node, ix.imports) or ""
            if target in _LOADERS or target.startswith(_LOADER_PREFIXES):
                what = f"`{target}`"
            elif target in _SUBPROCESS and _mentions_nvcc(node):
                what = "an nvcc subprocess"
            else:
                continue
            qual = ix.qualname(node.lineno)
            yield Finding(
                rule="kernel-build-site",
                path=rel,
                line=node.lineno,
                message=(
                    f"{what} in `{qual}` — kernels are built and loaded "
                    "only in ops/_build.py (one hash-named library per "
                    "source, built once a process); call "
                    "`ops._build.load` instead"
                ),
                detail=f"{target or 'call'}@{qual}",
            )


# -- CUDA atomics ---------------------------------------------------------------

_ATOMIC_METHODS = {
    "index_add_", "index_add", "scatter_add_", "scatter_add",
    "scatter_reduce_", "scatter_reduce",
}
_ACCUMULATE_METHODS = {"index_put_", "index_put", "put_", "put"}


def _accumulates(node: ast.Call) -> bool:
    for kw in node.keywords:
        if kw.arg == "accumulate":
            return not (
                isinstance(kw.value, ast.Constant) and not kw.value.value
            )
    # index_put_(indices, values, accumulate) positionally
    return len(node.args) >= 3 and not (
        isinstance(node.args[2], ast.Constant) and not node.args[2].value
    )


@rule(
    "cuda-atomics",
    "no index_add_/scatter_add_/scatter_reduce_/index_put_(accumulate="
    "True): the card must equal the CPU bit for bit",
)
def check_cuda_atomics(ctx):
    for rel, _mod, ix in _indexed(ctx):
        for node in ix.calls:
            if not isinstance(node.func, ast.Attribute):
                continue
            attr = node.func.attr
            if attr in _ACCUMULATE_METHODS:
                if not _accumulates(node):
                    continue
            elif attr not in _ATOMIC_METHODS:
                continue
            target = resolve_name(node.func, ix.imports) or ""
            if target.startswith("numpy."):
                continue  # np.put and the like: host arrays
            qual = ix.qualname(node.lineno)
            yield Finding(
                rule="cuda-atomics",
                path=rel,
                line=node.lineno,
                message=(
                    f"`{attr}` in `{qual}` adds through CUDA atomics, in "
                    "arrival order: the card's sums would stop equalling "
                    "the CPU's bit for bit — sum in a fixed order "
                    "(ops/costs.py: slot gathers, fixed_order_sum)"
                ),
                detail=f"{attr}@{qual}",
            )
