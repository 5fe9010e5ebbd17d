"""The plain versions of the port's Max-Sum kernels against the Pallas
kernels they replace, run in interpret mode on the CPU.

``ops/maxsum_kernels.py`` keeps beside each CUDA kernel a plain PyTorch
version of the same function; the wrappers take it for CPU tensors.
Here each plain version meets its Pallas kernel
(``pydcop_tpu/ops/pallas_maxsum.py``, ``interpret=True``) on the same
numpy inputs, at the shapes and dtypes of ``tests/test_pallas_maxsum.py``:
factor outputs bit-equal, ``q_update`` within 1e-6 in f32 (the reference
test's own tolerance: XLA may contract the damping into an FMA) and
bit-equal in bf16.  With bf16 tables the factor phase computes in bf16:
bit-equal with bf16 messages; with f32 messages XLA on the CPU keeps
excess f32 precision across the kernel body's last bf16 roundings, so
there the two agree to one bf16 rounding step (half an ulp at the
magnitude of the joint S).  The CUDA kernels themselves are held
against the plain versions on the card by ``chip_smoke.py``.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from pydcop_tpu.ops import pallas_maxsum  # noqa: E402

from pydcop_tpu_torch import interop  # noqa: E402
from pydcop_tpu_torch.ops import maxsum_kernels as mk  # noqa: E402
from pydcop_tpu_torch.ops import semiring  # noqa: E402


def _pair(a: np.ndarray, bf16: bool = False):
    """The same numpy input as a jax array and a CPU tensor."""
    j = jnp.asarray(a)
    t = torch.from_numpy(np.array(a))
    if bf16:
        j = j.astype(jnp.bfloat16)
        t = t.to(torch.bfloat16)
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return interop.to_numpy(x)
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _inputs(seed, d, m, per_factor, bf16=False, nan=False, tab_bf16=False):
    rng = np.random.RandomState(seed)
    shape = (d, d, m) if per_factor else (d, d)
    tab = rng.rand(*shape).astype(np.float32) * 10
    q0 = rng.rand(d, m).astype(np.float32)
    q1 = rng.rand(d, m).astype(np.float32)
    if nan:
        q0[1, 7] = np.nan
        q1[0, m - 1] = np.nan
    return _pair(tab, tab_bf16), _pair(q0, bf16), _pair(q1, bf16)


def _factor_both(per_factor, tj, q0j, q1j, tt, q0t, q1t):
    """(Pallas interpret, plain version) outputs on the same inputs."""
    if per_factor:
        ref = pallas_maxsum.factor_round_binary(tj, q0j, q1j, interpret=True)
        got = mk.factor_round_binary_plain(tt, q0t, q1t)
    else:
        ref = pallas_maxsum.factor_round_binary_shared(
            tj, q0j, q1j, interpret=True
        )
        got = mk.factor_round_binary_shared_plain(tt, q0t, q1t)
    return ref, got


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("d,m", [(3, 257), (2, 64), (5, 1000)])
@pytest.mark.parametrize("per_factor", [False, True], ids=["shared", "per_factor"])
def test_factor_plain_matches_pallas(per_factor, d, m, bf16):
    (tj, tt), (q0j, q0t), (q1j, q1t) = _inputs(d * m, d, m, per_factor, bf16)
    ref, got = _factor_both(per_factor, tj, q0j, q1j, tt, q0t, q1t)
    for g, r in zip(got, ref):
        assert g.dtype == q0t.dtype
        np.testing.assert_array_equal(_np(g), _np(r))


@pytest.mark.parametrize("per_factor", [False, True], ids=["shared", "per_factor"])
def test_factor_plain_propagates_nan_like_pallas(per_factor):
    d, m = 3, 257
    (tj, tt), (q0j, q0t), (q1j, q1t) = _inputs(
        1, d, m, per_factor, nan=True
    )
    ref, got = _factor_both(per_factor, tj, q0j, q1j, tt, q0t, q1t)
    for g, r in zip(got, ref):
        assert np.isnan(_np(r)).any()
        np.testing.assert_array_equal(_np(g), _np(r))  # NaN where NaN


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("d,m", [(3, 257), (5, 1000)])
@pytest.mark.parametrize("per_factor", [False, True], ids=["shared", "per_factor"])
def test_factor_plain_bf16_table_matches_pallas(per_factor, d, m, bf16):
    (tj, tt), (q0j, q0t), (q1j, q1t) = _inputs(
        d + m, d, m, per_factor, bf16, tab_bf16=True
    )
    ref, got = _factor_both(per_factor, tj, q0j, q1j, tt, q0t, q1t)
    for g, r in zip(got, ref):
        assert g.dtype == q0t.dtype
        if bf16:
            np.testing.assert_array_equal(_np(g), _np(r))
        else:  # one bf16 rounding step at |S| < 16: half an ulp, 2**-5
            np.testing.assert_allclose(_np(g), _np(r), rtol=0, atol=2.0**-5)


# the lane-tile instance's domain sizes (any d outside UNROLLED_D): one
# kernel and message dtype per d, since interpret mode costs seconds at
# d = 16 (its body unrolls d*d lane-vector adds)
_RUNTIME_D = [(False, 7, False), (True, 10, True), (False, 16, False)]
_RUNTIME_D_BF16_TABLE = [(True, 7, False), (False, 10, True), (False, 16, False)]


@pytest.mark.parametrize("per_factor,d,bf16", _RUNTIME_D)
def test_factor_plain_matches_pallas_runtime_d(per_factor, d, bf16):
    """:func:`test_factor_plain_matches_pallas` at domain sizes the
    lane-tile instance takes."""
    test_factor_plain_matches_pallas(per_factor, d, 300, bf16)


@pytest.mark.parametrize("per_factor,d,bf16", _RUNTIME_D_BF16_TABLE)
def test_factor_plain_bf16_table_matches_pallas_runtime_d(per_factor, d, bf16):
    """:func:`test_factor_plain_bf16_table_matches_pallas` at domain
    sizes the lane-tile instance takes (|S| < 16 still holds)."""
    test_factor_plain_bf16_table_matches_pallas(per_factor, d, 300, bf16)


@pytest.mark.parametrize("d", [3, 5, 10])
@pytest.mark.parametrize("per_factor", [False, True], ids=["shared", "per_factor"])
def test_factor_plain_bf16_table_equals_jax_cpu_path(per_factor, d):
    """bf16 tables with f32 messages: the plain versions equal the JAX
    package's own CPU computation of the factor phase
    (``pydcop_tpu.ops.semiring.bp_factor_messages`` at min-sum, run op by
    op) bit for bit.  The half-ulp gap to the Pallas kernel in interpret
    mode (:func:`test_factor_plain_bf16_table_matches_pallas`) is XLA
    keeping excess f32 precision across the bf16 roundings of one fused
    computation, not a difference between the two packages' functions."""
    from pydcop_tpu.ops import semiring as jsemiring

    m = 300
    (tj, tt), (q0j, q0t), (q1j, q1t) = _inputs(
        11 * d, d, m, per_factor, tab_bf16=True
    )
    tab_j = tj if per_factor else tj[..., None]
    factor = jax.jit(
        lambda t, a, b: jsemiring.bp_factor_messages(
            jsemiring.MIN_SUM, t, [a, b], jnp.float32
        )
    )
    if per_factor:
        got = mk.factor_round_binary_plain(tt, q0t, q1t)
    else:
        got = mk.factor_round_binary_shared_plain(tt, q0t, q1t)
    want = jsemiring.bp_factor_messages(
        jsemiring.MIN_SUM, tab_j, [q0j, q1j], jnp.float32
    )
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(_np(g), _np(w))


@pytest.mark.parametrize("tab_bf16", [False, True], ids=["f32_table", "bf16_table"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("per_factor", [False, True], ids=["shared", "per_factor"])
def test_factor_plain_equals_generic_path(per_factor, bf16, tab_bf16):
    """The factor kernels' plain versions equal ``bp_factor_messages`` (the
    path a CPU run takes) bit for bit, so a card run through the kernels
    and a CPU run of the port agree bit for bit."""
    d, m = 4, 300
    (_, tab), (_, q0), (_, q1) = _inputs(
        5, d, m, per_factor, bf16, tab_bf16=tab_bf16
    )
    if per_factor:
        got = mk.factor_round_binary_plain(tab, q0, q1)
        want = semiring.bp_factor_messages(
            semiring.MIN_SUM, tab, [q0, q1], q0.dtype
        )
    else:
        got = mk.factor_round_binary_shared_plain(tab, q0, q1)
        want = semiring.bp_factor_messages(
            semiring.MIN_SUM, tab[..., None], [q0, q1], q0.dtype
        )
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == q0.dtype
        assert torch.equal(g, w)


def _q_inputs(seed, d, e, bf16=False, nan=False):
    rng = np.random.RandomState(seed)
    be = rng.rand(d, e).astype(np.float32) * 5
    r = rng.rand(d, e).astype(np.float32)
    q = rng.rand(d, e).astype(np.float32)
    if nan:
        be[d - 1, 11] = np.nan
    return _pair(be, bf16), _pair(r, bf16), _pair(q, bf16)


@pytest.mark.parametrize("nan", [False, True], ids=["finite", "nan"])
@pytest.mark.parametrize("d,e", [(3, 500), (4, 4096), (2, 130)])
def test_q_update_plain_matches_pallas_f32(d, e, nan):
    (bj, bt), (rj, rt), (qj, qt) = _q_inputs(d + e, d, e, nan=nan)
    ref = pallas_maxsum.q_update(bj, rj, qj, jnp.asarray(0.5), interpret=True)
    got = mk.q_update_plain(bt, rt, qt, 0.5)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("damping", [0.5, 0.3])
def test_q_update_plain_matches_pallas_bf16(damping):
    (bj, bt), (rj, rt), (qj, qt) = _q_inputs(7, 3, 500, bf16=True)
    ref = pallas_maxsum.q_update(
        bj, rj, qj, jnp.asarray(damping), interpret=True
    )
    got = mk.q_update_plain(bt, rt, qt, damping)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(ref))


@functools.partial(jax.jit, static_argnums=3)
def _jax_q_update_xla(be, r, q, damping):
    """The JAX Max-Sum step's q update outside its Pallas gate
    (``pydcop_tpu/algorithms/maxsum.py``), in the belief's dtype, with
    ``damping`` a Python float as the step's params hold it."""
    qn = be - r
    qn = qn - jnp.min(qn, axis=0, keepdims=True)
    return (damping * q + (1.0 - damping) * qn).astype(q.dtype)


@pytest.mark.parametrize("damping", [0.3, 0.5, 0.7])
@pytest.mark.parametrize("d,e", [(3, 500), (70, 300)])
def test_q_update_plain_per_op_matches_jax_bf16_form(d, e, damping):
    """``per_op``: every operation rounded to bf16, as the JAX package's
    XLA q update computes a bf16 belief outside the kernel gate."""
    (bj, bt), (rj, rt), (qj, qt) = _q_inputs(d * e, d, e, bf16=True)
    ref = _jax_q_update_xla(bj, rj, qj, damping)
    got = mk.q_update_plain(bt, rt, qt, damping, per_op=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(ref))
    assert torch.equal(mk.q_update(bt, None, rt, qt, damping, per_op=True), got)
    # it is another function than the f32 update the kernel gate takes
    assert not torch.equal(got, mk.q_update_plain(bt, rt, qt, damping))


def test_q_update_per_op_needs_bf16_messages():
    (_, be), (_, r), (_, q) = _q_inputs(5, 3, 100)
    with pytest.raises(ValueError, match="per_op"):
        mk.q_update(be, None, r, q, 0.5, per_op=True)


def test_wrappers_take_the_plain_version_on_cpu_without_counting():
    """On CPU tensors a wrapper is its plain version: same bits, no
    kernel launch counted; ``out=`` writes into row views of a wider
    array (how ``maxsum.step`` hands it column blocks of r)."""
    mk.reset_launches()
    d, m = 3, 257
    (_, tab), (_, q0), (_, q1) = _inputs(3, d, m, per_factor=False)
    want = mk.factor_round_binary_shared_plain(tab, q0, q1)
    wide = torch.zeros(d, 2 * m + 5)
    out = (wide[:, 5 : 5 + m], wide[:, 5 + m :])
    got = mk.factor_round_binary_shared(tab, q0, q1, out=out)
    assert got[0].data_ptr() == out[0].data_ptr()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(wide[:, :5], torch.zeros(d, 5))

    (_, tabf), _, _ = _inputs(3, d, m, per_factor=True)
    for g, w in zip(
        mk.factor_round_binary(tabf, q0, q1),
        mk.factor_round_binary_plain(tabf, q0, q1),
    ):
        assert torch.equal(g, w)
    (_, be), (_, r), (_, q) = _q_inputs(4, d, 500)
    assert torch.equal(
        mk.q_update(be, None, r, q, 0.5), mk.q_update_plain(be, r, q, 0.5)
    )
    assert mk.launches == {k: 0 for k in mk.launches}


def test_q_update_wrapper_takes_any_domain_size():
    """The q update has no domain cap (its generic CUDA instance keeps a
    lane's rows in registers up to d = 128 and in shared memory past
    it): on the CPU, d = 70 gives the plain version."""
    (_, be), (_, r), (_, q) = _q_inputs(9, 70, 300)
    got = mk.q_update(be, None, r, q, 0.3)
    assert torch.equal(got, mk.q_update_plain(be, r, q, 0.3))
    assert got.shape == (70, 300)


def _gather_inputs(seed, d, bf16=False, belief_bf16=False):
    """A [d, n] belief, the position-major edge index of a 100-variable
    coloring (each variable on several edges; E ragged), and [d, E]
    r and q, as jax arrays and CPU tensors."""
    from pydcop_tpu_torch.ops.generate import coloring_arrays

    scopes, _, _ = coloring_arrays(100, colors=d, degree=3, seed=seed)
    ev = np.concatenate([scopes[:, 0], scopes[:, 1]]).astype(np.int32)
    rng = np.random.RandomState(seed)
    belief = rng.rand(d, 100).astype(np.float32) * 5
    r = rng.rand(d, len(ev)).astype(np.float32)
    q = rng.rand(d, len(ev)).astype(np.float32)
    return (_pair(belief, belief_bf16), _pair(ev), _pair(r, bf16),
            _pair(q, bf16))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [3, 10, 65])
def test_q_update_gathered_matches_pallas(d, bf16):
    """The gathered form (``edge_idx``: the belief read per edge inside
    the q update) equals the JAX step's broadcast-back gather
    ``belief_src[:, edge_var]`` in the message dtype followed by the
    Pallas ``q_update`` (interpret mode): f32 within 1e-6 (as
    :func:`test_q_update_plain_matches_pallas_f32`), bf16 messages with
    an f32 belief bit-equal."""
    (bj, bt), (ej, et), (rj, rt), (qj, qt) = _gather_inputs(d, d, bf16)
    ev = _np(et)
    assert len(np.unique(ev)) < len(ev) and len(ev) % 128  # repeats, ragged
    be = bj.astype(qj.dtype)[:, ej]
    ref = pallas_maxsum.q_update(be, rj, qj, jnp.asarray(0.5), interpret=True)
    got = mk.q_update(bt, et, rt, qt, 0.5)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    if bf16:
        np.testing.assert_array_equal(_np(got), _np(ref))
    else:
        np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-6, atol=1e-6)
    plain = mk.q_update_plain(bt, rt, qt, 0.5, edge_idx=et)
    assert torch.equal(got, plain)


@pytest.mark.parametrize("d", [3, 65])
def test_q_update_gathered_per_op_matches_jax_bf16_form(d):
    """``per_op`` with the gathered form: a bf16 belief read per edge,
    then every operation rounded to bf16, equals the JAX step's XLA q
    update on ``belief[:, edge_var]`` bit for bit."""
    (bj, bt), (ej, et), (rj, rt), (qj, qt) = _gather_inputs(
        d + 1, d, bf16=True, belief_bf16=True
    )
    ref = _jax_q_update_xla(bj[:, ej], rj, qj, 0.3)
    got = mk.q_update(bt, et, rt, qt, 0.3, per_op=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(ref))


@pytest.mark.parametrize(
    "bad,err",
    [("dtype", TypeError), ("length", ValueError), ("device", ValueError),
     ("belief_dtype", TypeError)],
)
def test_q_update_rejects_a_wrong_edge_index(bad, err):
    """The wrapper checks the edge index's dtype (int32), length (E) and
    device (q's), and the belief's dtype (q's or f32), on every device."""
    (_, bt), (_, et), (_, rt), (_, qt) = _gather_inputs(5, 3)
    if bad == "dtype":
        et = et.long()
    elif bad == "length":
        et = et[:-1]
    elif bad == "device":
        et = torch.empty(et.shape, dtype=torch.int32, device="meta")
    else:
        bt = bt.to(torch.bfloat16)
    with pytest.raises(err, match="belief" if bad == "belief_dtype" else "edge_idx"):
        mk.q_update(bt, et, rt, qt, 0.5)


# -- the batch axis: the plain versions against the vmapped Pallas kernels


@pytest.mark.parametrize("tables", ["one", "stacked"])
@pytest.mark.parametrize("d", [3, 10])
@pytest.mark.parametrize("per_factor", [False, True], ids=["shared", "per_factor"])
def test_batched_factor_plain_matches_vmapped_pallas(per_factor, d, tables):
    """B = 3 batches in one call: with one table for every batch (an
    operand without the batch axis: ``vmap`` ``in_axes=None``) or one
    table per instance (``[I, ...]``, I = 3), against the Pallas kernel
    under ``jax.vmap`` in interpret mode (the batching rule adds a grid
    axis): bit-equal, and each batch bit-equal to an unbatched call."""
    B, m = 3, 130
    rng = np.random.RandomState(d + m)
    shape = (d, d, m) if per_factor else (d, d)
    lead = (B,) if tables == "stacked" else ()
    (tj, tt) = _pair(rng.rand(*lead, *shape).astype(np.float32) * 10)
    (q0j, q0t) = _pair(rng.rand(B, d, m).astype(np.float32))
    (q1j, q1t) = _pair(rng.rand(B, d, m).astype(np.float32))
    kernel = (pallas_maxsum.factor_round_binary if per_factor
              else pallas_maxsum.factor_round_binary_shared)
    ref = jax.vmap(
        functools.partial(kernel, interpret=True),
        in_axes=(0 if tables == "stacked" else None, 0, 0),
    )(tj, q0j, q1j)
    plain = (mk.factor_round_binary_plain if per_factor
             else mk.factor_round_binary_shared_plain)
    got = plain(tt, q0t, q1t)
    for g, r in zip(got, ref):
        assert g.shape == (B, d, m)
        np.testing.assert_array_equal(_np(g), _np(r))
    for b in range(B):
        one = plain(tt[b] if tables == "stacked" else tt, q0t[b], q1t[b])
        for g, o in zip(got, one):
            assert torch.equal(g[b], o)


@pytest.mark.parametrize("index", ["shared", "per_instance"])
@pytest.mark.parametrize("d", [3, 10])
def test_batched_q_update_plain_matches_vmapped_pallas(d, index):
    """The gathered q update with B = 3 batches, per-instance damping
    (0.3, 0.5, 0.8) and the edge index shared or one row per instance,
    against the Pallas ``q_update`` under ``jax.vmap`` (interpret mode)
    on the gathered beliefs: within 1e-6 (the Pallas kernel's own f32
    tolerance), and each batch bit-equal to an unbatched call."""
    B, n, e = 3, 40, 150
    rng = np.random.RandomState(d)
    belief = rng.rand(B, d, n).astype(np.float32) * 5
    idx = rng.randint(0, n, (B, e)).astype(np.int32)
    if index == "shared":
        idx[:] = idx[0]
    r = rng.rand(B, d, e).astype(np.float32)
    q = rng.rand(B, d, e).astype(np.float32)
    damp = np.array([0.3, 0.5, 0.8], np.float32)
    be = np.stack([belief[b][:, idx[b]] for b in range(B)])
    ref = jax.vmap(
        functools.partial(pallas_maxsum.q_update, interpret=True)
    )(jnp.asarray(be), jnp.asarray(r), jnp.asarray(q), jnp.asarray(damp))
    idx_t = torch.from_numpy(idx if index == "per_instance" else idx[0])
    got = mk.q_update(torch.from_numpy(belief), idx_t, torch.from_numpy(r),
                      torch.from_numpy(q), torch.from_numpy(damp))
    np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-6, atol=1e-6)
    for b in range(B):
        one = mk.q_update(
            torch.from_numpy(belief[b]), torch.from_numpy(idx[b]),
            torch.from_numpy(r[b]), torch.from_numpy(q[b]), float(damp[b]),
        )
        assert torch.equal(got[b], one)


def test_batched_wrappers_reject_bad_instance_axes():
    q = torch.zeros(4, 3, 10)
    with pytest.raises(ValueError, match="instance"):
        mk.q_update(torch.zeros(4, 3, 5), torch.zeros(3, 10, dtype=torch.int32),
                    q, q, 0.5)
    with pytest.raises(ValueError, match="batch"):
        mk.q_update(torch.zeros(3, 10), None, q[0], q[0], torch.ones(2))
