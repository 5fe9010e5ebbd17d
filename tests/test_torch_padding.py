"""The port's shape bucketing (``pad_policy``) against the JAX package's.

Under ``pow2`` and ``pow2:16`` the port's compiler must build every
array leaf the JAX compiler builds (ghost variables, zero-table ghost
constraints, quantized adjacency widths, slot counts and flat-table
length, the shared table materialized where ghosts are appended), bit
for bit, on coloring, ternary and SECP instances.  Grouping
(``problem_group_key``) and stacking (``stack_problems``) must partition
a list of problems as the JAX package does, and a stacked leaf must be
the instances' leaves stacked.
"""

import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import pydcop_tpu.dcop as jdcop  # noqa: E402
from pydcop_tpu.commands.generators import secp as jsecp  # noqa: E402
from pydcop_tpu.dcop.yamldcop import load_dcop_from_file as jax_load  # noqa: E402
from pydcop_tpu.ops import compile as jcompile  # noqa: E402

import pydcop_tpu_torch.dcop as tdcop  # noqa: E402
from pydcop_tpu_torch.commands.generators import secp as tsecp  # noqa: E402
from pydcop_tpu_torch.dcop.yamldcop import load_dcop_from_file  # noqa: E402
from pydcop_tpu_torch.ops import compile as tcompile  # noqa: E402
from pydcop_tpu_torch.ops.generate import coloring_arrays  # noqa: E402
from test_torch_compile import (  # noqa: E402
    _port_leaves,
    assert_same_problem,
)

EXAMPLES = os.path.join(os.path.dirname(__file__), os.pardir, "examples")
POLICIES = ("pow2", "pow2:16")


def _arrays(kind):
    """(scopes, tables, d, unary) for compile_from_arrays."""
    scopes, table, unary = coloring_arrays(45, seed=2)
    rng = np.random.default_rng(3)
    if kind == "shared":  # 67 constraints: ghosts materialize the table
        return scopes, table, 3, unary
    if kind == "shared-on-boundary":  # 64: the table stays shared
        return scopes[:64], table, 3, unary
    if kind == "per-factor":
        return scopes, rng.random((len(scopes), 3, 3), dtype=np.float32), 3, unary
    if kind == "ternary":  # binary and ternary buckets
        s3 = np.stack([rng.choice(45, 3, replace=False) for _ in range(11)])
        t3 = rng.random((11, 3, 3, 3), dtype=np.float32)
        return [scopes, s3], [table, t3], 3, unary
    raise ValueError(kind)


@pytest.mark.parametrize("pad", POLICIES)
@pytest.mark.parametrize(
    "kind", ["shared", "shared-on-boundary", "per-factor", "ternary"]
)
def test_arrays_compile_leaves_equal_jax(kind, pad):
    scopes, tables, d, unary = _arrays(kind)
    ref = jcompile.compile_from_arrays(scopes, tables, d, unary=unary,
                                       pad_policy=pad)
    port = tcompile.compile_from_arrays(scopes, tables, d, unary=unary,
                                        pad_policy=pad, device="cpu")
    assert_same_problem(port, ref)
    assert port.n_pad_vars == ref.n_pad_vars > 0
    assert port.slot_sentinels  # the quantized prefixes hold sentinels


def _secp(m):
    return m.generate(types.SimpleNamespace(
        nb_lights=20, nb_models=14, nb_rules=6, light_levels=3,
        model_arity=3, zone_size=5, zone_layout="tiled",
        efficiency_weight=0.1, capacity=100.0, seed=4,
    ))


@pytest.mark.parametrize("pad", POLICIES)
@pytest.mark.parametrize("case", ["graph_coloring_3.yaml",
                                  "meeting_preferences.yaml", "secp"])
def test_dcop_compile_leaves_equal_jax(case, pad):
    if case == "secp":
        jd, td = _secp(jsecp), _secp(tsecp)
    else:
        path = os.path.join(EXAMPLES, case)
        jd, td = jax_load(path), load_dcop_from_file(path)
    ref = jcompile.compile_dcop(jd, pad_policy=pad)
    port = tcompile.compile_dcop(td, pad_policy=pad, device="cpu")
    assert_same_problem(port, ref)
    assert port.n_pad_vars == ref.n_pad_vars


def _ring(m, n, maximize=False):
    dom = m.Domain("d", "", [0, 1, 2])
    dcop = m.DCOP(f"ring{n}", objective="max" if maximize else "min")
    vs = [m.Variable(f"v{i}", dom) for i in range(n)]
    for v in vs:
        dcop.add_variable(v)
    for i in range(n):
        j = (i + 1) % n
        dcop.add_constraint(m.constraint_from_str(
            f"c{i}_{j}", f"1 if v{i} == v{j} else 0", vs
        ))
    return dcop


def test_grouping_and_stacking_equal_jax():
    """Rings of 5..48 variables, one a max problem, under pow2:16: the
    same groups in the same order with the same indices, and each
    stacked leaf the group's leaves stacked."""
    sizes = (5, 40, 6, 48, 7, 5)
    maxi = (False, False, False, False, False, True)
    jp = [jcompile.compile_dcop(_ring(jdcop, n, x), pad_policy="pow2:16")
          for n, x in zip(sizes, maxi)]
    tp = [tcompile.compile_dcop(_ring(tdcop, n, x), pad_policy="pow2:16",
                                device="cpu")
          for n, x in zip(sizes, maxi)]
    jg, tg = jcompile.stack_problems(jp), tcompile.stack_problems(tp)
    assert [g.indices for g in tg] == [g.indices for g in jg]
    assert [g.indices for g in tg] == [[0, 2, 4], [1, 3], [5]]
    keys = [tcompile.problem_group_key(p) for p in tp]
    assert keys[0] == keys[2] == keys[4] != keys[1] == keys[3] != keys[5]
    for g in tg:
        assert g.n_instances == len(g.indices)
        assert g.problem.unary.shape == (g.n_instances,) + g.template.unary.shape
        assert g.host_problems[0].var_names == tp[g.indices[0]].var_names
        for name, leaf in _port_leaves(g.problem).items():
            want = torch.stack(
                [_port_leaves(tp[i])[name] for i in g.indices]
            )
            assert torch.equal(leaf, want), name
