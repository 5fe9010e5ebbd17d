"""The port's compiler against the JAX package's: every array leaf equal.

Both compilers build the same numpy arrays; the port hands them to
torch, the JAX package to jax.  Every leaf of ``CompiledProblem`` (and of
each arity bucket), its dtype, and the host metadata that the round loop
reads (``n_real_edges``, ``var_slot_counts``) must agree exactly.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from pydcop_tpu.dcop.yamldcop import load_dcop_from_file as jax_load  # noqa: E402
from pydcop_tpu.ops import compile as jcompile  # noqa: E402
from pydcop_tpu.ops.generate import coloring_arrays as jax_coloring  # noqa: E402

from pydcop_tpu_torch import interop  # noqa: E402
from pydcop_tpu_torch.dcop.yamldcop import load_dcop_from_file  # noqa: E402
from pydcop_tpu_torch.ops import compile as tcompile  # noqa: E402
from pydcop_tpu_torch.ops.generate import coloring_arrays  # noqa: E402

EXAMPLES = os.path.join(os.path.dirname(__file__), os.pardir, "examples")

_BUCKET_FIELDS = ("tables", "tables_t", "scopes", "edge_slot")


def _jax_leaves(p):
    """numpy leaves of a JAX CompiledProblem, in the interop naming."""
    leaves = {f: np.asarray(getattr(p, f)) for f in tcompile.ARRAY_FIELDS}
    for k, b in p.buckets.items():
        for f in _BUCKET_FIELDS:
            leaves[f"buckets.{k}.{f}"] = np.asarray(getattr(b, f))
    return leaves


def _jax_meta(p):
    return {f: getattr(p, f) for f in tcompile.META_FIELDS}


def _port_leaves(p):
    leaves = {f: getattr(p, f) for f in tcompile.ARRAY_FIELDS}
    for k, b in p.buckets.items():
        for f in _BUCKET_FIELDS:
            leaves[f"buckets.{k}.{f}"] = getattr(b, f)
    return leaves


_DTYPE_NAMES = {
    torch.float32: "float32", torch.bfloat16: "bfloat16",
    torch.int32: "int32", torch.bool: "bool",
}


def assert_same_problem(port, ref):
    """Every leaf equal (values and dtype), same metadata."""
    pl, rl = _port_leaves(port), _jax_leaves(ref)
    assert sorted(pl) == sorted(rl)
    for name in rl:
        t, a = pl[name], rl[name]
        assert t.device.type == "cpu"
        assert _DTYPE_NAMES[t.dtype] == a.dtype.name, name
        want = a.astype(np.float32) if a.dtype.name == "bfloat16" else a
        got = interop.to_numpy(t)
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert port.n_real_edges == ref.n_real_edges
    assert tuple(port.var_slot_counts) == tuple(ref.var_slot_counts)
    assert list(port.var_names) == list(ref.var_names)
    assert [tuple(x) for x in port.domain_labels] == [
        tuple(x) for x in ref.domain_labels
    ]
    assert list(port.con_names) == list(ref.con_names)
    assert port.maximize == ref.maximize
    assert port.n_shards == ref.n_shards
    assert set(port.buckets) == set(ref.buckets)
    for k in ref.buckets:
        assert port.buckets[k].shared_table == ref.buckets[k].shared_table


@pytest.mark.parametrize(
    "fname", ["graph_coloring_3.yaml", "meeting_preferences.yaml"]
)
def test_compile_dcop_yaml_leaves_equal(fname):
    path = os.path.join(EXAMPLES, fname)
    ref = jcompile.compile_dcop(jax_load(path))
    port = tcompile.compile_dcop(load_dcop_from_file(path), device="cpu")
    assert_same_problem(port, ref)


def _coloring(shared: bool, n: int = 300):
    scopes, table, unary = coloring_arrays(n, seed=1)
    if not shared:
        rng = np.random.default_rng(5)
        table = rng.random((len(scopes), 3, 3)).astype(np.float32)
    return scopes, table, unary


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_table"])
@pytest.mark.parametrize("table_dtype", [None, "bf16"])
def test_compile_from_arrays_leaves_equal(shared, table_dtype):
    scopes, table, unary = _coloring(shared)
    ref = jcompile.compile_from_arrays(
        scopes, table, 3, unary=unary, table_dtype=table_dtype
    )
    port = tcompile.compile_from_arrays(
        scopes, table, 3, unary=unary, table_dtype=table_dtype,
        device="cpu",
    )
    assert port.buckets[2].shared_table is shared
    assert_same_problem(port, ref)


def test_coloring_generator_is_a_copy():
    for got, want in zip(coloring_arrays(300, seed=1), jax_coloring(300, seed=1)):
        np.testing.assert_array_equal(got, want)


def test_mixed_arity_and_maximize_leaves_equal():
    rng = np.random.default_rng(2)
    n = 40
    s2 = rng.integers(0, n, size=(60, 2)).astype(np.int32)
    s2 = s2[s2[:, 0] != s2[:, 1]]
    s3 = np.stack([rng.choice(n, 3, replace=False) for _ in range(25)])
    t2 = rng.random((len(s2), 4, 4)).astype(np.float32)
    t3 = rng.random((4, 4, 4)).astype(np.float32)
    init = rng.integers(0, 4, size=n).astype(np.int32)
    kw = dict(n_vars=n, init_idx=init, maximize=True)
    ref = jcompile.compile_from_arrays([s2, s3], [t2, t3], 4, **kw)
    port = tcompile.compile_from_arrays(
        [s2, s3], [t2, t3], 4, device="cpu", **kw
    )
    assert_same_problem(port, ref)


def test_interop_round_trip():
    """JAX problem → numpy leaves → interop.problem_from_arrays equals
    the port's own compile of the same arrays."""
    scopes, table, unary = _coloring(shared=False)
    ref = jcompile.compile_from_arrays(scopes, table, 3, unary=unary)
    port = interop.problem_from_arrays(
        _jax_leaves(ref), _jax_meta(ref), device="cpu"
    )
    assert_same_problem(port, ref)
    own = tcompile.compile_from_arrays(
        scopes, table, 3, unary=unary, device="cpu"
    )
    for name, t in _port_leaves(own).items():
        assert torch.equal(t, _port_leaves(port)[name]), name


def test_unported_layouts_raise():
    """Nothing is left unported here: the sharded layout (``n_shards=2``)
    and ``pad_policy`` compile the JAX package's problems, leaf for
    leaf; a shard count below 1 is refused."""
    scopes, table, unary = _coloring(shared=True, n=50)
    assert_same_problem(
        tcompile.compile_from_arrays(
            scopes, table, 3, unary=unary, n_shards=2, device="cpu"
        ),
        jcompile.compile_from_arrays(scopes, table, 3, unary=unary,
                                     n_shards=2),
    )
    with pytest.raises(ValueError, match="n_shards"):
        tcompile.compile_from_arrays(
            scopes, table, 3, n_shards=0, device="cpu"
        )
    assert_same_problem(
        tcompile.compile_from_arrays(
            scopes, table, 3, unary=unary, pad_policy="pow2", device="cpu"
        ),
        jcompile.compile_from_arrays(
            scopes, table, 3, unary=unary, pad_policy="pow2"
        ),
    )


def test_encode_decode_assignment_round_trip():
    path = os.path.join(EXAMPLES, "meeting_preferences.yaml")
    port = tcompile.compile_dcop(load_dcop_from_file(path), device="cpu")
    ref = jcompile.compile_dcop(jax_load(path))
    values = np.arange(port.n_vars) % np.asarray(port.domain_sizes)
    a = tcompile.decode_assignment(port, torch.as_tensor(values))
    assert a == jcompile.decode_assignment(ref, values)
    np.testing.assert_array_equal(
        tcompile.encode_assignment(port, a).numpy(),
        np.asarray(jcompile.encode_assignment(ref, a)),
    )
