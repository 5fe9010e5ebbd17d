"""The port's exact DPOP against the JAX package's.

The same instances, built from numpy seeds once with each package's model
objects, go through ``pydcop_tpu.api.solve(…, "dpop")`` (both
packages at the same ``bnb``, ``'auto'`` unless a test sets it) and
``pydcop_tpu_torch.api.solve(…, "dpop", device="cpu")``.  The
assignment, the cost and every non-time statistic must be equal: DPOP is
exact and the device path is certificate-guarded, so level batching,
pow-2 padding and the device (the port's contraction in eager PyTorch,
the JAX package's in XLA) change no decided value.  Also here: the
port's pseudo-tree against the JAX one, the options (``bnb='on'``
included) and the CLI.
"""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import pydcop_tpu.dcop as jdcop  # noqa: E402
from pydcop_tpu.api import solve as jax_solve  # noqa: E402
from pydcop_tpu.graphs import pseudotree as jpt  # noqa: E402

import pydcop_tpu_torch.dcop as tdcop  # noqa: E402
from pydcop_tpu_torch.api import solve as port_solve  # noqa: E402
from pydcop_tpu_torch.graphs import pseudotree as tpt  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RING = os.path.join(REPO, "examples", "graph_coloring_3.yaml")
STATS = (
    "assignment", "cost", "final_cost", "cycle", "msg_count", "msg_size",
    "status", "util_backend", "util_cells", "util_device_nodes",
    "util_host_nodes", "util_dispatches",
)
ALWAYS = {"util_device": "always"}


# -- instances, built with either package's model objects (``m``) ------


def random_tree(m, n, d, seed, extra_edges=0):
    """Random tree plus back edges (``tests/test_dpop_level.py``)."""
    rng = np.random.RandomState(seed)
    dom = m.Domain("dom", "", list(range(d)))
    dcop = m.DCOP(f"tree{seed}")
    vs = [m.Variable(f"v{i}", dom) for i in range(n)]
    for v in vs:
        dcop.add_variable(v)
    for i in range(1, n):
        j = rng.randint(0, i)
        t = rng.uniform(0, 10, (d, d)).round(3)
        dcop.add_constraint(
            m.NAryMatrixRelation([vs[j], vs[i]], t, name=f"t{j}_{i}")
        )
    for k in range(extra_edges):
        i, j = rng.choice(n, size=2, replace=False)
        t = rng.uniform(0, 5, (d, d)).round(3)
        dcop.add_constraint(
            m.NAryMatrixRelation(
                [vs[min(i, j)], vs[max(i, j)]], t, name=f"x{k}"
            )
        )
    return dcop


def mixed_arity(m, seed=0):
    """Unary, binary and ternary constraints over mixed domain sizes."""
    rng = np.random.RandomState(seed)
    doms = [m.Domain(f"d{k}", "", list(range(k))) for k in (2, 3, 4)]
    dcop = m.DCOP(f"mixed{seed}")
    vs = [
        m.Variable(name, doms[k])
        for name, k in zip("abcefg", (1, 0, 2, 1, 0, 1))
    ]
    for v in vs:
        dcop.add_variable(v)
    for name, idx in (
        ("u0", [0]), ("p0", [0, 1]), ("p1", [1, 2]), ("p2", [3, 4]),
        ("t0", [0, 1, 2]), ("t1", [3, 4, 5]), ("p3", [0, 3]),
    ):
        scope = [vs[i] for i in idx]
        shape = tuple(len(v.domain) for v in scope)
        dcop.add_constraint(
            m.NAryMatrixRelation(
                scope, rng.uniform(0, 8, shape).round(3), name=name
            )
        )
    return dcop


def random_binary(m, n, d, p, seed, objective="min", hard=False):
    """Random binary DCOP (``tests/test_algo_dpop.py``); ``hard`` puts
    a forbidden pair in each table: +inf under min, -inf under max."""
    rng = np.random.RandomState(seed)
    dom = m.Domain("d", "", list(range(d)))
    dcop = m.DCOP(f"rnd{seed}", objective=objective)
    vs = [m.Variable(f"v{i}", dom) for i in range(n)]
    for v in vs:
        dcop.add_variable(v)
    for i in range(n):
        for j in range(i + 1, n):
            if rng.rand() < p:
                t = rng.uniform(0, 10, (d, d)).round(2)
                if hard:
                    t[rng.randint(d), rng.randint(d)] = (
                        np.inf if objective == "min" else -np.inf
                    )
                dcop.add_constraint(
                    m.NAryMatrixRelation([vs[i], vs[j]], t, name=f"c{i}_{j}")
                )
    return dcop


def costs_and_external(m):
    """Variable value costs and a constraint on an external variable."""
    dom = m.Domain("d", "", [0, 1, 2])
    dcop = m.DCOP("costs")
    v0 = m.VariableWithCostFunc("v0", dom, lambda x: x * 0.5)
    v1 = m.VariableWithCostFunc("v1", dom, lambda x: 2 - x)
    dcop.add_variable(v0)
    dcop.add_variable(v1)
    ext = m.ExternalVariable("e", dom, value=2)
    dcop.add_variable(ext)
    dcop.add_constraint(
        m.constraint_from_str("c", "(v0 + v1 - e) ** 2", [v0, v1, ext])
    )
    return dcop


def forest(m):
    """Two independent pairs and a variable with no constraint."""
    dom = m.Domain("d", "", [0, 1])
    dcop = m.DCOP("forest")
    vs = [m.Variable(f"v{i}", dom) for i in range(5)]
    for v in vs:
        dcop.add_variable(v)
    dcop.add_constraint(
        m.NAryMatrixRelation(
            [vs[0], vs[1]], np.array([[0.0, 5.0], [5.0, 1.0]]), name="a"
        )
    )
    dcop.add_constraint(
        m.NAryMatrixRelation(
            [vs[2], vs[3]], np.array([[3.0, 0.0], [2.0, 9.0]]), name="b"
        )
    )
    return dcop


def symmetric_chain(m):
    """Every row constant: margin 0 everywhere, so every device join is
    tie-heavy and redone on the host (``tests/test_dpop_level.py``)."""
    dom = m.Domain("d", "", [0, 1, 2])
    dcop = m.DCOP("sym")
    vs = [m.Variable(f"v{i}", dom) for i in range(6)]
    for v in vs:
        dcop.add_variable(v)
    for i in range(5):
        dcop.add_constraint(
            m.NAryMatrixRelation([vs[i], vs[i + 1]], np.ones((3, 3)),
                                 name=f"c{i}")
        )
    return dcop


def _both(build, *args, **kw):
    return build(jdcop, *args, **kw), build(tdcop, *args, **kw)


def assert_same_result(want, got):
    for k in STATS:
        assert got[k] == want[k], (k, want[k], got[k])
    assert set(got) == set(want)


def run_both(jd, td, params, pad="none", **kw):
    want = jax_solve(jd, "dpop", params,
                     pad_policy=pad, **kw)
    got = port_solve(td, "dpop", params, pad_policy=pad, device="cpu", **kw)
    assert_same_result(want, got)
    return got


# -- the whole solve ----------------------------------------------------


@pytest.mark.parametrize("pad", ["none", "pow2"])
@pytest.mark.parametrize("util_batch", ["level", "node"])
@pytest.mark.parametrize(
    "util_device", ["always", "never", "auto"]
)
@pytest.mark.parametrize("seed", [0, 3])
def test_random_trees_equal_jax(seed, util_device, util_batch, pad):
    jd, td = _both(random_tree, 12, 3, seed, extra_edges=2)
    params = {"util_device": util_device, "util_batch": util_batch}
    if util_device == "auto":
        # a threshold this instance straddles: 3-axis joins (27 cells)
        # on the device, smaller ones on the host
        params["device_min_cells"] = 27
    got = run_both(jd, td, params, pad)
    if util_device == "never":
        assert got["util_device_nodes"] == got["util_dispatches"] == 0
    else:
        assert got["util_device_nodes"] > 0


@pytest.mark.parametrize(
    "case,params,pad",
    [
        ("n-ary", ALWAYS, "pow2"),
        ("n-ary-node", dict(ALWAYS, util_batch="node"), "pow2:4"),
        ("max", ALWAYS, "none"),
        ("hard-min", ALWAYS, "pow2"),
        ("hard-max", dict(ALWAYS, util_batch="node"), "none"),
        ("costs-external", ALWAYS, "none"),
        ("forest", ALWAYS, "pow2"),
        ("forest-node", dict(ALWAYS, util_batch="node"), "none"),
        ("symmetric", ALWAYS, "pow2"),
        ("memory-bound", dict(ALWAYS, memory_bound=9), "none"),
    ],
)
def test_instances_equal_jax(case, params, pad):
    build = {
        "n-ary": (mixed_arity,),
        "max": (random_binary, 6, 3, 0.5, 11, "max"),
        "hard-min": (random_binary, 7, 3, 0.45, 2, "min", True),
        "hard-max": (random_binary, 7, 3, 0.45, 4, "max", True),
        "costs-external": (costs_and_external,),
        "forest": (forest,),
        "symmetric": (symmetric_chain,),
        "memory-bound": (random_tree, 10, 3, 5, 3),
    }[case.replace("-node", "")]
    jd, td = _both(*build)
    got = run_both(jd, td, params, pad)
    if case == "symmetric":
        assert got["util_host_nodes"] > 0  # tie-heavy joins fell back
        assert got["util_device_nodes"] > 0  # the root's did not
    if case == "memory-bound":
        want = jax_solve(jd, "dpop", params)
        assert got["conditioned_vars"] == want["conditioned_vars"]
        assert got["conditioning_passes"] == want["conditioning_passes"] > 1


def test_forest_level_batches_constraint_free_variables():
    """Two variables with no constraint share one level dispatch (the
    port contracts a zero part for each): the JAX package raises there
    under ``util_batch='level'`` without padding (ROADMAP queue C); its
    per-node result is the reference."""
    jd, td = _both(forest)  # v4 has no constraint; w neither
    td.add_variable(tdcop.Variable("w", tdcop.Domain("d", "", [0, 1])))
    jd.add_variable(jdcop.Variable("w", jdcop.Domain("d", "", [0, 1])))
    got = port_solve(td, "dpop", ALWAYS, device="cpu")
    want = jax_solve(jd, "dpop", dict(ALWAYS, util_batch="node"))
    for k in ("assignment", "cost", "util_device_nodes", "util_host_nodes"):
        assert got[k] == want[k]
    assert got["util_dispatches"] < want["util_dispatches"]


# -- the pseudo-tree ----------------------------------------------------


@pytest.mark.parametrize(
    "build", [(random_tree, 14, 3, 1, 3), (random_tree, 12, 2, 4, 5),
              (mixed_arity,), (forest,)],
)
def test_pseudotree_equals_jax(build):
    jd, td = _both(*build)
    jg, tg = jpt.build_computation_graph(jd), tpt.build_computation_graph(td)
    assert tg.roots == jg.roots
    for root in jg.roots:
        assert tg.depth_first_order(root) == jg.depth_first_order(root)
    for jn in jg.nodes:
        tn = tg.node(jn.name)
        assert (tn.parent, tn.children, tn.pseudo_parents,
                tn.pseudo_children) == (jn.parent, jn.children,
                                        jn.pseudo_parents, jn.pseudo_children)
        assert tg.separator(jn.name) == jg.separator(jn.name)


# -- options: the A10 knobs and bnb='on' run and equal the JAX package --


@pytest.mark.parametrize(
    "params,item",
    [
        ({"max_util_bytes": 1 << 20}, None),
        ({"table_format": "sparse"}, None),
        ({"table_dtype": "bf16"}, None),
        ({"table_dtype": "int8"}, None),
        ({"bnb": "on"}, None),
    ],
)
def test_unported_options_raise(params, item):
    """Every option is ported now: the memory-bounded sweep, sparse
    tables, the bf16/int8 packs (ROADMAP A10) and the pruned contraction
    (``bnb='on'``, A5) run and equal the JAX package's result."""
    td = tdcop.load_dcop_from_file(RING)
    if item is not None:
        with pytest.raises(NotImplementedError, match=item):
            port_solve(td, "dpop", params, device="cpu")
        return
    jd = jdcop.load_dcop_from_file(RING)
    got = run_both(jd, td, dict(params, util_device="always"))
    assert got["cost"] == 0.0
    assert ("membound" in got) == (
        "max_util_bytes" in params or "table_format" in params)


def test_entry_point_checks():
    from pydcop_tpu_torch.api import solve_compiled
    from pydcop_tpu_torch.device import NoCudaDeviceError

    with pytest.raises(ValueError, match="n_restarts"):
        port_solve(RING, "dpop", n_restarts=2, device="cpu")
    with pytest.raises(ValueError, match="checkpoint"):
        port_solve(RING, "dpop", resume=True, device="cpu")
    with pytest.raises(ValueError, match="solve_compiled"):
        solve_compiled(SimpleNamespace(), "dpop")
    # the batched engine's compile takes pad_policy too: a padded
    # Max-Sum solve returns the JAX package's assignment and cost
    ms = {"noise": 0.0}
    want = jax_solve(RING, "maxsum", ms, rounds=8, pad_policy="pow2")
    got = port_solve(RING, "maxsum", ms, rounds=8, pad_policy="pow2",
                     device="cpu")
    assert got["assignment"] == want["assignment"]
    assert got["cost"] == pytest.approx(want["cost"], rel=1e-6)
    if not torch.cuda.is_available():
        with pytest.raises(NoCudaDeviceError):
            port_solve(RING, "dpop")


def test_cli_matches_jax_solve():
    """``python -m pydcop_tpu_torch solve -a dpop --device cpu`` prints
    what ``pydcop_tpu.api.solve`` returns, minus the time fields' values
    and the JAX package's ``cost_trace``."""
    want = jax_solve(RING, "dpop", {"util_device": "always"},
                     pad_policy="pow2")
    proc = subprocess.run(
        [sys.executable, "-m", "pydcop_tpu_torch", "solve", "-a", "dpop",
         "-p", "util_device:always", "--pad_policy", "pow2", "--device",
         "cpu", RING],
        capture_output=True, text=True, cwd=REPO, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout)
    for k in STATS:
        assert got[k] == want[k], k
    assert set(got) == set(want) - {"cost_trace"}
