"""The port's cost kernels (``pydcop_tpu_torch/ops/costs.py``) against the
JAX package's, on the same compiled arrays and assignments.

Integer results (gathers, index arithmetic) must be equal; f32 sums are
taken in another order by each package (the JAX CPU path uses
``segment_sum``, the port adds slot by slot), so they agree to 1e-6
relative.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from pydcop_tpu.ops import compile as jcompile  # noqa: E402
from pydcop_tpu.ops import costs as jcosts  # noqa: E402

from pydcop_tpu_torch.ops import compile as tcompile  # noqa: E402
from pydcop_tpu_torch.ops import costs as tcosts  # noqa: E402


@pytest.fixture(scope="module")
def problems():
    """A mixed binary/ternary instance with per-constraint tables."""
    rng = np.random.default_rng(9)
    n = 120
    s2 = rng.integers(0, n, size=(300, 2)).astype(np.int32)
    s2 = s2[s2[:, 0] != s2[:, 1]]
    s3 = np.stack([rng.choice(n, 3, replace=False) for _ in range(60)])
    t2 = rng.random((len(s2), 4, 4)).astype(np.float32)
    t3 = rng.random((len(s3), 4, 4, 4)).astype(np.float32)
    unary = rng.random((n, 4)).astype(np.float32)
    args = ([s2, s3], [t2, t3], 4)
    ref = jcompile.compile_from_arrays(*args, unary=unary)
    port = tcompile.compile_from_arrays(*args, unary=unary, device="cpu")
    values = rng.integers(0, 4, size=n).astype(np.int32)
    return ref, port, values


def test_total_cost_matches_jax(problems):
    ref, port, values = problems
    want = float(jcosts.total_cost(ref, jnp.asarray(values)))
    got = tcosts.total_cost(port, torch.from_numpy(values))
    assert got.dim() == 0
    assert float(got) == pytest.approx(want, rel=1e-6)


def test_local_cost_sweep_matches_jax(problems):
    ref, port, values = problems
    want = np.asarray(jcosts.local_cost_sweep(ref, jnp.asarray(values)))
    got = tcosts.local_cost_sweep(port, torch.from_numpy(values)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # the sweep's own-value column is each variable's local cost: its
    # minimum over the domain never exceeds the current value's entry
    own = got[np.arange(len(values)), values]
    assert np.all(got.min(axis=1) <= own)


def test_segment_sum_edges_matches_jax(problems):
    ref, port, _ = problems
    rng = np.random.default_rng(1)
    per_edge = rng.random((ref.n_edges, 4)).astype(np.float32)
    want = np.asarray(jcosts.segment_sum_edges(ref, jnp.asarray(per_edge)))
    got = tcosts.segment_sum_edges(port, torch.from_numpy(per_edge)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_neighbor_gather_matches_jax(problems):
    ref, port, values = problems
    want = np.asarray(jcosts.neighbor_gather(ref, jnp.asarray(values), -1))
    got = tcosts.neighbor_gather(port, torch.from_numpy(values), -1).numpy()
    np.testing.assert_array_equal(got, want)


def test_restart_axis_equals_row_by_row(problems):
    """``[K, n]`` values give the rows each ``[n]`` row gives, bit for
    bit: the sweep, and the total cost (its sum order depends only on
    the row's length)."""
    _, port, values = problems
    rng = np.random.default_rng(2)
    stack = np.stack([values] + [
        rng.integers(0, 4, size=len(values)).astype(np.int32)
        for _ in range(2)
    ])
    vk = torch.from_numpy(stack)
    sweep = tcosts.local_cost_sweep(port, vk)
    cost = tcosts.total_cost(port, vk)
    nbr = tcosts.neighbor_gather(port, vk, -1, dim=-1)
    assert sweep.shape == (3, len(values), 4) and cost.shape == (3,)
    for k in range(3):
        assert torch.equal(sweep[k], tcosts.local_cost_sweep(port, vk[k]))
        assert torch.equal(cost[k], tcosts.total_cost(port, vk[k]))
        assert torch.equal(nbr[k], tcosts.neighbor_gather(port, vk[k], -1))


@pytest.mark.parametrize("n", [1, 5, 8, 37, 1000])
def test_fixed_order_sum_is_pairwise_halving(n):
    """The documented order, checked against numpy f32 adds, and each row
    of a batch summed to the bits it gets alone."""
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((3, 4, n)) * 10.0 ** rng.integers(
        -6, 6, (3, 4, n))).astype(np.float32)
    size = 1 << max(n - 1, 0).bit_length()
    want = np.zeros((3, 4, size), np.float32)
    want[..., :n] = x
    while want.shape[-1] > 1:
        h = want.shape[-1] // 2
        want = want[..., :h] + want[..., h:]
    got = tcosts.fixed_order_sum(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want[..., 0])
    for i in range(3):
        for j in range(4):
            assert torch.equal(
                got[i, j], tcosts.fixed_order_sum(torch.from_numpy(x[i, j]))
            )


def test_instance_costs_equal_each_total_cost():
    """A stacked group of three rings (one pow2 bucket) gives each
    instance's own ``total_cost`` (restart axis included), bit for bit,
    on float tables whose sum depends on the order."""
    rng = np.random.default_rng(4)
    probs, vals = [], []
    for n in (11, 13, 16):
        s2 = np.stack([np.arange(n), (np.arange(n) + 1) % n], axis=1)
        t2 = (rng.random((n, 3, 3)) * 1e3).astype(np.float32)
        u = rng.random((n, 3)).astype(np.float32) * 1e-3
        probs.append(tcompile.compile_from_arrays(
            [s2], [t2], 3, n_vars=n, unary=u, pad_policy="pow2:16",
            device="cpu"))
    [stacked] = tcompile.stack_problems(probs)
    for p in probs:
        vals.append(rng.integers(0, 3, (2, p.n_vars)).astype(np.int32))
    v = torch.from_numpy(np.stack(vals))
    got = tcosts.instance_costs(stacked, v)
    assert got.shape == (3, 2)
    for i, p in enumerate(probs):
        assert torch.equal(got[i], tcosts.total_cost(p, v[i]))
