"""The port's surface against the JAX package's: modules, public names,
commands, and the algorithm contract's ``values_from_state``.

- Every module of ``pydcop_tpu/`` has a counterpart at the same path in
  ``pydcop_tpu_torch/``, except the two listed in :data:`NO_COUNTERPART`.
- The public top-level names (functions, classes, assigned names) a JAX
  module defines and its counterpart lacks are exactly
  :data:`JAX_ONLY`, each with its reason.
- ``pydcop_tpu_torch.cli.COMMANDS`` is the JAX package's 20 commands.
- ``values_from_state`` of the nine batched algorithms gives the JAX
  function's values on the same state.
"""

import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from pydcop_tpu import cli as jax_cli  # noqa: E402
from pydcop_tpu.algorithms import load_algorithm_module as jax_algo  # noqa: E402
from pydcop_tpu.algorithms import prepare_algo_params as jax_params  # noqa: E402
from pydcop_tpu.ops import compile as jcompile  # noqa: E402

from pydcop_tpu_torch import cli as port_cli  # noqa: E402
from pydcop_tpu_torch.algorithms import load_algorithm_module  # noqa: E402
from pydcop_tpu_torch.algorithms import prepare_algo_params  # noqa: E402
from pydcop_tpu_torch.ops import compile as tcompile  # noqa: E402
from pydcop_tpu_torch.ops.generate import coloring_arrays  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
JAX_PKG = REPO / "pydcop_tpu"
PORT_PKG = REPO / "pydcop_tpu_torch"

#: JAX modules without a module of the same path in the port
NO_COUNTERPART = {
    # wraps jax.jit: ROADMAP C, "Telemetry without a counterpart"
    "telemetry/jit.py": None,
    # the Pallas kernels: ported as CUDA kernels
    "ops/pallas_maxsum.py": "ops/maxsum_kernels.py",
}

#: (JAX module, public name) the port lacks, and why
JAX_ONLY = {
    ("ops/costs.py", "CPU_SEGMENT_MIN_EDGES"):
        "the JAX CPU lowering (ROADMAP C, 'Belief summation')",
    ("ops/costs.py", "use_cpu_segment_path"):
        "the JAX CPU lowering (ROADMAP C, 'Belief summation')",
    ("ops/compile.py", "enable_persistent_compilation_cache"):
        "an XLA compilation cache; the port compiles no XLA programs",
    ("engine/batched.py", "set_runner_cache_limit"):
        "the jit runner cache (ROADMAP C, 'Telemetry without a "
        "counterpart')",
    ("parallel/mesh.py", "shard_map"):
        "jax's shard_map; the port's Mesh steps one thread a shard",
    ("ops/sparse.py", "np_table_format_dtype"):
        "ported under another name (ops/sparse.py:storage_dtype: numpy "
        "has no bf16, so the port packs bf16 through torch)",
}

ALGOS = ("maxsum", "amaxsum", "dsa", "adsa", "dsatuto", "mgm", "mgm2",
         "dba", "gdba")


def _modules(pkg):
    return {p.relative_to(pkg).as_posix() for p in pkg.rglob("*.py")
            if "_build" not in p.parts}


def public_names(path):
    """Top-level functions, classes and assigned names not starting
    with ``_`` (imports are not counted: they are not a module's own)."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out |= {n.id for t in node.targets for n in ast.walk(t)
                    if isinstance(n, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            out.add(node.target.id)
    return {n for n in out if not n.startswith("_")}


def test_every_jax_module_has_a_port_counterpart():
    jax_mods, port_mods = _modules(JAX_PKG), _modules(PORT_PKG)
    assert jax_mods - port_mods == set(NO_COUNTERPART)
    for rel, counterpart in NO_COUNTERPART.items():
        assert rel in jax_mods
        assert counterpart is None or counterpart in port_mods


def test_the_names_only_the_jax_package_has():
    missing = set()
    for rel in sorted(_modules(JAX_PKG) - set(NO_COUNTERPART)):
        lacks = public_names(JAX_PKG / rel) - public_names(PORT_PKG / rel)
        missing |= {(rel, name) for name in lacks}
    assert missing == set(JAX_ONLY)
    assert all(JAX_ONLY.values())
    # the renamed helper is there under its port name
    assert "storage_dtype" in public_names(PORT_PKG / "ops/sparse.py")


def test_the_cli_has_the_jax_packages_20_commands():
    assert port_cli.COMMANDS == jax_cli.COMMANDS
    assert len(port_cli.COMMANDS) == 20

    def subcommands(parser):
        return next(a for a in parser._actions if hasattr(a, "choices")
                    and a.choices and "solve" in a.choices).choices.keys()

    assert list(subcommands(port_cli.build_parser())) == list(
        subcommands(jax_cli.build_parser()))


@pytest.fixture(scope="module")
def problems():
    s, t, u = coloring_arrays(40, seed=1)
    return (jcompile.compile_from_arrays(s, t, 3, unary=u),
            tcompile.compile_from_arrays(s, t, 3, unary=u, device="cpu"))


@pytest.mark.parametrize("algo", ALGOS)
def test_values_from_state_equals_the_jax_function(algo, problems):
    ref, port = problems
    jmod, tmod = jax_algo(algo), load_algorithm_module(algo)
    values = np.random.default_rng(5).integers(
        0, 3, size=ref.n_vars).astype(np.int32)
    js = jmod.init_state(ref, jax.random.PRNGKey(0),
                         jax_params({}, jmod.algo_params))
    ts = tmod.init_state(port, 0, prepare_algo_params({}, tmod.algo_params))
    js = {**js, "values": jnp.asarray(values)}
    ts = {**ts, "values": torch.from_numpy(values)}
    got, want = tmod.values_from_state(ts), jmod.values_from_state(js)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if algo == "amaxsum":  # an alias of Max-Sum's, as in the JAX package
        assert tmod.values_from_state is load_algorithm_module(
            "maxsum").values_from_state
