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
    """``[K, n]`` values give the rows each ``[n]`` row gives: the sweep
    bit for bit, the total cost to rounding (one sum per row)."""
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
        assert float(cost[k]) == pytest.approx(
            float(tcosts.total_cost(port, vk[k])), rel=1e-6
        )
        assert torch.equal(nbr[k], tcosts.neighbor_gather(port, vk[k], -1))
