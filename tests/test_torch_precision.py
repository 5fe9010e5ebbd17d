"""The port's bf16/int8 UTIL table packs against the JAX package's.

The same numpy-made inputs go through both packages on the CPU: the
int8 pack and unpack (bit-equal), the contraction kernel at bf16 and
int8 (bit-equal arg and margins for min/max, rtol 1e-6 for logsumexp,
NaN cells by position), and whole DPOP and inference runs at each
``table_dtype`` (cost, assignment, UTIL counts and the ``semiring.*``
counters equal; log Z within the reported ``error_bound``).
"""

import os
import sys
from argparse import Namespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
ml_dtypes = pytest.importorskip("ml_dtypes")

import pydcop_tpu.api as japi  # noqa: E402
import pydcop_tpu.dcop as jdcop  # noqa: E402
from pydcop_tpu.commands.generators import secp as jsecp  # noqa: E402
from pydcop_tpu.ops import padding as jpad  # noqa: E402
from pydcop_tpu.ops import semiring as jsr  # noqa: E402

import pydcop_tpu_torch.api as tapi  # noqa: E402
import pydcop_tpu_torch.dcop as tdcop  # noqa: E402
from pydcop_tpu_torch.commands.generators import secp as tsecp  # noqa: E402
from pydcop_tpu_torch.ops import padding as tpad  # noqa: E402
from pydcop_tpu_torch.ops import semiring as tsr  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_dpop import random_binary  # noqa: E402

CPU = "cpu"
DTYPES = ("f32", "bf16", "int8")
SECP_16 = dict(  # bench.py's precision stage cut to 16 lights
    nb_lights=16, nb_models=16, nb_rules=4, light_levels=6,
    model_arity=3, zone_size=8, zone_layout="tiled",
    efficiency_weight=0.1, capacity=100.0, seed=7,
)


def counters(result):
    return {
        k: v for k, v in result["telemetry"]["counters"].items()
        if k.startswith(("semiring.", "dpop.", "membound.", "engine.oom"))
    }


# -- the int8 pack ------------------------------------------------------


@pytest.mark.parametrize("mag,infs", [
    (1.0, False), (1e-3, True), (1e6, True), (3e38, False),
])
def test_int8_pack_and_unpack_bit_equal(mag, infs):
    rng = np.random.default_rng(int(mag > 1) + 2 * infs)
    a = rng.uniform(-mag, mag, (5, 7))
    if infs:
        a[0, 0], a[1, 3], a[4, 6] = np.inf, -np.inf, np.inf
    jq, js, jo = jpad.quantize_table_int8(a)
    tq, ts, to = tpad.quantize_table_int8(a)
    assert tq.dtype == np.int8 and np.array_equal(tq, jq)
    assert ts.tobytes() == js.tobytes() and to.tobytes() == jo.tobytes()
    want = jpad.dequantize_table_int8(jq, js, jo)
    got = tpad.dequantize_table_int8(tq, ts, to)
    assert want.tobytes() == got.tobytes()
    # the device form (separate multiply and add) gives the same bits
    dev = tsr.dequantize_int8(
        torch.from_numpy(tq), torch.tensor(ts), torch.tensor(to)
    ).numpy()
    assert dev.tobytes() == want.tobytes()
    assert tpad.int8_quant_bound(mag) == jpad.int8_quant_bound(mag)


def test_dtype_vocabulary_equals_jax():
    for spec in ("f32", "fp32", "bfloat16", "bf16", "i8", "int8", None):
        dt = tpad.as_table_dtype(spec)
        assert dt == jpad.as_table_dtype(spec)
        assert tpad.table_dtype_bytes(dt) == jpad.table_dtype_bytes(dt)
        assert tpad.table_dtype_eps(dt) == jpad.table_dtype_eps(dt)
    with pytest.raises(ValueError, match="did you mean 'bf16'"):
        tpad.as_table_dtype("bf61")


# -- the contraction kernel at bf16 / int8 ------------------------------

CASES = {
    # name: (joined shape, aligned part shapes)
    "three-parts": ((4, 3, 5), ((4, 1, 5), (1, 3, 5), (4, 3, 1))),
    "own-1": ((6, 1), ((6, 1), (1, 1))),
}


def _parts(shapes, lead, seed):
    """f32 parts, a fifth of each part's cells ±inf and a few exact
    ties (the same value twice in a row)."""
    rng = np.random.default_rng(seed)
    out = []
    for i, ps in enumerate(shapes):
        p = (rng.integers(0, 40, lead + ps) * 0.25).astype(np.float32)
        flat = p.reshape(-1)
        pick = rng.choice(flat.size, size=max(1, flat.size // 5),
                          replace=False)
        flat[pick] = np.inf if i % 2 == 0 else -np.inf
        out.append(p)
    return out


def _args(parts, dt, batched):
    """The kernel arguments of both packages at storage dtype ``dt``."""
    if dt == "bf16":
        return (
            [p.astype(ml_dtypes.bfloat16) for p in parts],
            [torch.from_numpy(p).to(torch.bfloat16) for p in parts],
        )
    if dt == "f32":
        return parts, [torch.from_numpy(p) for p in parts]
    if batched:
        packed = tsr._quantize_rows(
            [p.astype(np.float64) for p in parts], parts[0].shape[0],
            tsr_met(),
        )
    else:
        packed = tsr._pack_parts(parts, "int8")
    return packed, [torch.from_numpy(np.asarray(p)) for p in packed]


def tsr_met():
    from pydcop_tpu_torch.telemetry import get_metrics

    return get_metrics()


def _same_or_nan(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and bool(
        np.all((a == b) | (np.isnan(a) & np.isnan(b)))
    )


def _dequantized(jargs, batched):
    """The f32 parts the int8 pack stands for, by the JAX package's
    numpy reference ``dequantize_table_int8`` (one pair per row when
    stacked)."""
    scales, offsets, *qs = jargs
    out = []
    for i, q in enumerate(qs):
        if batched:
            out.append(np.stack([
                jpad.dequantize_table_int8(q[r], scales[r, i],
                                           offsets[r, i])
                for r in range(q.shape[0])
            ]))
        else:
            out.append(jpad.dequantize_table_int8(q, scales[i], offsets[i]))
    return out


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dt", ["bf16", "int8"])
@pytest.mark.parametrize("sr", ["min_sum", "max_sum", "log_sum_exp"])
def test_contraction_kernel_matches_jax(sr, dt, case, batched):
    """bf16: bit-equal to the JAX kernel (min/max), rtol 1e-6
    (logsumexp).  int8: bit-equal to the JAX kernel on the parts its
    numpy reference dequantizes; XLA on the CPU fuses the in-trace
    ``q * scale + offset`` into one multiply-add (one rounding, where
    the port and the reference round twice), so against the JAX int8
    kernel itself margins agree to a few f32 roundings (ROADMAP C)."""
    shape, part_shapes = CASES[case]
    lead = (3,) if batched else ()
    parts = _parts(part_shapes, lead, seed=len(case) + 7 * batched)
    jargs, targs = _args(parts, dt, batched)
    got = [x.numpy() for x in tsr.contraction_kernel(
        sr, shape, part_shapes, batched=batched, table_dtype=dt)(*targs)]
    jax_own = [np.asarray(x) for x in jsr.contraction_kernel(
        sr, shape, part_shapes, batched=batched, table_dtype=dt)(*jargs)]
    if dt == "int8":
        want = [np.asarray(x) for x in jsr.contraction_kernel(
            sr, shape, part_shapes, batched=batched)(
                *_dequantized(jargs, batched))]
    else:
        want = jax_own
    assert len(got) == len(want) == len(jax_own)
    if tsr.get_semiring(sr).idempotent:
        for g, w in zip(got, want):  # arg, margins
            assert _same_or_nan(g, w.astype(g.dtype))
        scale = sum(
            float(np.abs(p[np.isfinite(p)]).max(initial=0.0)) for p in parts
        )
        g, w = got[1], jax_own[1]
        assert np.array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=8 * np.finfo(np.float32).eps * scale)
    else:
        for w in (want, jax_own):
            g, w = got[0], w[0]
            assert np.array_equal(np.isnan(g), np.isnan(w))
            np.testing.assert_allclose(g, w, rtol=1e-6)


def test_kernel_rejects_parts_of_another_storage_type():
    fn = tsr.contraction_kernel("min_sum", (3,), ((3,),), table_dtype="bf16")
    with pytest.raises(ValueError, match="bfloat16"):
        fn(torch.zeros(3))
    fn = tsr.contraction_kernel("min_sum", (3,), ((3,),), table_dtype="int8")
    got = fn(torch.ones(1), torch.zeros(1),
             torch.tensor([127, -5, 3], dtype=torch.int8))
    assert got[0].item() == 1  # +inf code, -5, 3: the minimum is -5


# -- whole runs ----------------------------------------------------------


def _secp(package):
    gen = jsecp if package == "jax" else tsecp
    return gen.generate(Namespace(**SECP_16))


@pytest.mark.parametrize("util_batch", ["level", "node"])
@pytest.mark.parametrize("dt", DTYPES)
def test_dpop_secp_at_every_dtype_equals_jax(dt, util_batch):
    params = {"util_device": "always", "util_batch": util_batch,
              "table_dtype": dt}
    want = japi.solve(_secp("jax"), "dpop", params,
                      pad_policy="pow2")
    got = tapi.solve(_secp("port"), "dpop", params, pad_policy="pow2",
                     device=CPU)
    for k in ("assignment", "cost", "util_cells", "util_dispatches",
              "util_device_nodes", "util_host_nodes", "msg_size"):
        assert got[k] == want[k], k
    assert counters(got) == counters(want)
    oracle = tapi.solve(_secp("port"), "dpop", {"util_device": "never"},
                        device=CPU)
    assert got["cost"] == oracle["cost"]


@pytest.mark.parametrize("dt", ["bf16", "int8"])
def test_dpop_hard_constraints_at_low_precision_equal_jax(dt):
    """Hard +inf pairs ride the reserved int8 codes and bf16's inf."""
    jd = random_binary(jdcop, 9, 3, 0.5, 4, hard=True)
    td = random_binary(tdcop, 9, 3, 0.5, 4, hard=True)
    params = {"util_device": "always", "table_dtype": dt}
    want = japi.solve(jd, "dpop", params)
    got = tapi.solve(td, "dpop", params, device=CPU)
    assert (got["assignment"], got["cost"]) == (
        want["assignment"], want["cost"])
    assert counters(got) == counters(want)


@pytest.mark.parametrize("dt", ["bf16", "int8"])
def test_infer_at_low_precision(dt):
    """map bit-identical to JAX and to f32; log Z within the reported
    bound of host f64 (and of the JAX value); the precision counters
    equal JAX's."""
    kw = dict(device="always", device_min_cells=256, pad_policy="pow2",
              table_dtype=dt)
    jm = japi.infer(_secp("jax"), "map", **kw)
    tm = tapi.infer(_secp("port"), "map", torch_device=CPU, **kw)
    t32 = tapi.infer(_secp("port"), "map", torch_device=CPU,
                     **dict(kw, table_dtype="f32"))
    assert (tm["assignment"], tm["cost"]) == (jm["assignment"], jm["cost"])
    assert tm["assignment"] == t32["assignment"]
    assert counters(tm) == counters(jm)
    kw["tol"] = float("inf")  # keep every logsumexp node on the device
    jz = japi.infer(_secp("jax"), "log_z", **kw)
    tz = tapi.infer(_secp("port"), "log_z", torch_device=CPU, **kw)
    host = tapi.infer(_secp("port"), "log_z", device="never",
                      torch_device=CPU)
    assert tz["device_nodes"] == jz["device_nodes"] > 0
    assert abs(tz["log_z"] - host["log_z"]) <= tz["error_bound"] + 1e-9
    assert abs(tz["log_z"] - jz["log_z"]) <= (
        tz["error_bound"] + jz["error_bound"])
    assert counters(tz) == counters(jz)


def test_default_tol_demotes_mass_nodes_like_jax():
    """At the default tol a bf16 logsumexp node whose widened bound
    would pass it demotes to f32 (``semiring.precision_repairs``)."""
    kw = dict(device="always", device_min_cells=256, table_dtype="bf16")
    jz = japi.infer(_secp("jax"), "log_z", **kw)
    tz = tapi.infer(_secp("port"), "log_z", torch_device=CPU, **kw)
    assert counters(tz) == counters(jz)
    assert counters(tz).get("semiring.precision_repairs", 0) > 0
    assert abs(tz["log_z"] - jz["log_z"]) <= (
        tz["error_bound"] + jz["error_bound"])
