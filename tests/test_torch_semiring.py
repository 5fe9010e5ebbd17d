"""The port's min-sum contraction and DPOP level-pack helpers against the
JAX package's.

``pydcop_tpu_torch.ops.semiring.contraction_kernel(MIN_SUM, …)`` must
return the ``(amin, margins)`` of ``pydcop_tpu.ops.semiring.
contraction_kernel(MIN_SUM, …)`` (jitted XLA on the CPU) bit for bit,
unbatched and batched: random f32 parts, exact ties, ``-0.0`` cells,
``+inf`` rows, mixed ±inf parts (NaN cells, compared by position: NaN
payloads carry no meaning) and a one-value own axis.  ``amin`` is
compared as int64 (``jnp.argmin`` gives int32, ``torch.argmin`` int64).
The level-pack helpers of ``ops/padding.py`` must equal the JAX ones.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pydcop_tpu.ops import padding as jpad  # noqa: E402
from pydcop_tpu.ops import semiring as jsr  # noqa: E402

from pydcop_tpu_torch.ops import padding as tpad  # noqa: E402
from pydcop_tpu_torch.ops import semiring as tsr  # noqa: E402

F32 = np.float32
# (joined shape, aligned part shapes): a DPOP leaf under three hubs, a
# node with a child message and an owned part, a root, a one-value own
# axis
SHAPES = [
    ((4, 3, 5), ((4, 1, 5), (1, 3, 5), (4, 3, 1))),
    ((6, 7), ((6, 7), (1, 7))),
    ((9,), ((9,), (9,))),
    ((5, 1), ((5, 1), (1, 1))),
]


def _parts(case, shapes, lead, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i, ps in enumerate(shapes):
        full = lead + ps
        if case == "random":
            p = rng.random(full, dtype=F32) * 10
        elif case == "ties":  # small integers: many exact ties
            p = rng.integers(0, 3, full).astype(F32)
        elif case == "negzero":  # -0.0 cells, as a max objective's zeros
            p = -rng.integers(0, 2, full).astype(F32)
        elif case == "inf_rows":
            p = rng.random(full, dtype=F32)
            if i == 0:  # whole own-axis rows at +inf
                p[(Ellipsis, 0) if p.ndim > 1 else Ellipsis] = np.inf
        else:  # mixed ±inf: +inf + -inf gives NaN cells
            p = rng.random(full, dtype=F32)
            flat = p.reshape(-1)
            k = max(1, flat.size // 5)
            pick = rng.choice(flat.size, size=k, replace=False)
            flat[pick] = np.inf if i % 2 == 0 else -np.inf
        out.append(p)
    return out


def _same(a, b):
    nan = np.isnan(a)
    return (
        a.dtype == b.dtype and a.shape == b.shape
        and np.array_equal(nan, np.isnan(b))
        and np.array_equal(a.view(np.int32)[~nan], b.view(np.int32)[~nan])
    )


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize(
    "case", ["random", "ties", "negzero", "inf_rows", "mixed_inf"]
)
@pytest.mark.parametrize("shape,part_shapes", SHAPES)
def test_contraction_kernel_equals_jax(shape, part_shapes, case, batched):
    lead = (3,) if batched else ()
    parts = _parts(case, part_shapes, lead, seed=len(shape) + len(case))
    want_a, want_m = (
        np.asarray(x)
        for x in jsr.contraction_kernel(
            jsr.MIN_SUM, shape, part_shapes, batched=batched
        )(*parts)
    )
    got_a, got_m = tsr.contraction_kernel(
        tsr.MIN_SUM, shape, part_shapes, batched=batched
    )(*(torch.from_numpy(p) for p in parts))
    assert got_a.dtype == torch.int64
    np.testing.assert_array_equal(got_a.numpy(), want_a.astype(np.int64))
    assert _same(got_m.numpy(), want_m)
    if shape[-1] == 1:
        assert np.all(got_m.numpy() == np.inf)
    if case == "mixed_inf" and not batched and len(shape) == 3:
        assert np.isnan(want_m).any()  # the case reaches NaN cells


def test_contraction_kernel_rejects_other_semirings_and_bad_parts():
    """Unknown and malformed semirings raise with the JAX package's
    messages; the pruned kernel takes its budget first and masks a row
    below it (``tests/test_torch_bnb.py`` holds it against JAX); parts
    must be of the bucket's shapes and storage type (a bf16 pack takes
    bf16 parts, ``tests/test_torch_precision.py`` holds it against
    JAX)."""
    with pytest.raises(ValueError, match="did you mean 'max_sum'"):
        tsr.get_semiring("max_summ")
    with pytest.raises(ValueError, match="2 <= k"):
        tsr.get_semiring("kbest:1")
    with pytest.raises(ValueError):
        tsr.get_semiring("min_plus")
    pruned = tsr.contraction_kernel("max_sum", (3,), ((3,),), bnb=True)
    with pytest.raises(ValueError):
        pruned(torch.zeros(3))  # the budget comes first
    arg, margins, keep = pruned(torch.tensor(4.0), torch.tensor([1., 3., 2.]))
    assert (arg.item(), keep.item(), margins.item()) == (1, False, np.inf)
    bf16 = tsr.contraction_kernel("min_sum", (3,), ((3,),),
                                  table_dtype="bf16")
    with pytest.raises(ValueError):
        bf16(torch.zeros(3))  # an f32 part at a bf16 bucket
    assert bf16(torch.tensor([2.0, 1.0, 3.0]).bfloat16())[0].item() == 1
    fn = tsr.contraction_kernel("min_sum", (3, 2), ((3, 2),))
    with pytest.raises(ValueError):
        fn(torch.zeros(3, 2, dtype=torch.float64))
    assert tsr.as_bnb(None) == jsr.as_bnb(None) == "auto"
    assert tsr.as_bnb(False) == jsr.as_bnb(False) == "off"


@pytest.mark.parametrize("policy", ["none", "pow2", "pow2:4"])
@pytest.mark.parametrize(
    "shape,part_shapes",
    [
        ((5, 3, 6), ((5, 1, 6), (1, 3, 6), (5, 3, 1))),
        ((24, 24, 24, 24), ((1, 24, 24, 24), (24, 1, 1, 24))),
        ((1, 7), ((1, 7),)),
        ((3,), ((3,),)),
    ],
)
def test_level_pack_helpers_equal_jax(shape, part_shapes, policy):
    jp, tp = jpad.as_pad_policy(policy), tpad.as_pad_policy(policy)
    assert (jp.kind, jp.floor) == (tp.kind, tp.floor)
    assert tpad.bucket_util_shape(shape, tp) == jpad.bucket_util_shape(
        shape, jp
    )
    key = tpad.util_level_key(shape, part_shapes, tp)
    assert key == jpad.util_level_key(shape, part_shapes, jp)
    if tp.enabled:  # the sweep pads only under an enabled policy
        rng = np.random.default_rng(1)
        aligned = [rng.random(ps) * 9 for ps in part_shapes]
        got = tpad.pad_util_parts(aligned, shape, key[0])
        want = jpad.pad_util_parts(aligned, shape, key[0])
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == F32
            np.testing.assert_array_equal(g, w)
    for n in (1, 2, 3, 17, 32, 33, 100):
        assert tpad.stack_bucket(n) == jpad.stack_bucket(n)
    assert tpad.table_dtype_eps("f32") == jpad.table_dtype_eps("f32")
