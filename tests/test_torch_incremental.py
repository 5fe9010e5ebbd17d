"""The port's incremental compiler (``engine/incremental.py``) against the
JAX package's ``IncrementalCompiler`` and against a fresh compile.

The same sensor DCOP (built with each package's objects) goes through
both compilers under the same sequence of external-variable changes:
after every ``compile()`` the port's leaves equal the JAX package's and
a fresh ``compile_dcop`` of the active problem, bit for bit (bf16
tables included; a bf16 ``unary`` row patched by adding deltas, as the
JAX package adds them, is within bf16 rounding of the fresh one), the
fingerprints are equal, and so are the ``compile.*`` counters.  The fixture folds two tracked sensors into one
variable's unary row (duplicate unary slots), slices ternary "pair"
constraints to per-factor binary rows (so the binary bucket has no
shared table and updates are incremental), and has a fully-external
constraint (a change there is a reuse and keeps the fingerprint).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import pydcop_tpu.dcop as jdcop  # noqa: E402
from pydcop_tpu.engine.incremental import (  # noqa: E402
    IncrementalCompiler as JCompiler,
)
from pydcop_tpu.telemetry import session as jsession  # noqa: E402

import pydcop_tpu_torch.dcop as tdcop  # noqa: E402
from pydcop_tpu_torch import interop  # noqa: E402
from pydcop_tpu_torch.engine.incremental import IncrementalCompiler  # noqa: E402
from pydcop_tpu_torch.ops.compile import compile_dcop  # noqa: E402
from pydcop_tpu_torch.telemetry import session  # noqa: E402

from test_torch_compile import (  # noqa: E402
    _jax_leaves,
    _port_leaves,
    assert_same_problem,
)

CPU = "cpu"
COUNTERS = ("compile.full", "compile.incremental", "compile.reused")


def sensor_dcop(m, n=12, n_sensors=6, colors=3, seed=3, n_agents=6,
                capacity=150.0,
                shared_only=False):
    """A coloring ring with chords over ``n`` variables, ``n_sensors``
    external sensors and constraints of three kinds reading them:
    ``track_k`` (``v`` equals sensor ``k``: slices to a unary row; two
    tracks land on ``v0``), ``pair_k`` (a ternary on an edge's endpoints
    and a sensor: slices to a per-factor binary row) and ``mirror``
    (sensor ``s0`` and the extra sensor ``m``, read by nothing else: the
    compiler drops it).  ``shared_only`` leaves out the pairs, so every
    binary table is the same."""
    rng = np.random.default_rng(seed)
    d = m.Domain("colors", "", list(range(colors)))
    dcop = m.DCOP("sensors", objective="min")
    vs = [m.Variable(f"v{i}", d) for i in range(n)]
    for v in vs:
        dcop.add_variable(v)
    ss = [m.ExternalVariable(f"s{k}", d, value=0) for k in range(n_sensors)]
    ss.append(m.ExternalVariable("m", d, value=0))
    for s in ss:
        dcop.add_variable(s)
    edges = [(i, (i + 1) % n) for i in range(n)]
    edges += [(i, (i + n // 2) % n) for i in range(0, n // 2, 3)]
    for i, j in edges:
        dcop.add_constraint(m.constraint_from_str(
            f"c{i}_{j}", f"1 if v{i} == v{j} else 0", vs))
    half = n_sensors // 2
    tracked = ([0, 0] + [int(x) for x in rng.choice(
        np.arange(1, n), max(half - 2, 0), replace=False)])[:half]
    for k in range(half):
        dcop.add_constraint(m.constraint_from_str(
            f"track_{k}",
            f"0 if v{tracked[k]} == s{k} else {0.1 * k + 0.713:.3f}",
            vs + ss))
    if not shared_only:
        for k in range(half, n_sensors):
            i, j = edges[(3 * k) % len(edges)]
            dcop.add_constraint(m.constraint_from_str(
                f"pair_{k}",
                f"(1 if v{i} == v{j} else 0) + (0.5 if v{i} == s{k} else 0)",
                vs + ss))
    dcop.add_constraint(m.constraint_from_str(
        "mirror", "1 if s0 == m else 0", ss))
    dcop.add_agents([m.AgentDef(f"a{i}", capacity=capacity)
                     for i in range(n_agents)])
    return dcop


def _compilers(pad_policy="none", bf16=False, **kw):
    jd, td = sensor_dcop(jdcop, **kw), sensor_dcop(tdcop, **kw)
    jc = JCompiler(jd, pad_policy=pad_policy,
                   dtype=jnp.bfloat16 if bf16 else jnp.float32)
    tc = IncrementalCompiler(td, pad_policy=pad_policy,
                             dtype=torch.bfloat16 if bf16 else torch.float32,
                             device=CPU)
    return jc, tc


def _snapshot(problem):
    return {k: interop.to_numpy(v).copy()
            for k, v in _port_leaves(problem).items()}


def _counters(summary):
    c = summary["counters"]
    return {k: c.get(k, 0) for k in COUNTERS}


# frozen, ext_overrides: set two tracks on v0 at once (duplicate unary
# slots), then a pair, a no-op, the fully-external sensor, a freeze, a
# revert
STEPS = [
    ({}, {}),
    ({}, {}),
    ({}, {"s0": 2, "s1": 1}),
    ({}, {"s0": 2, "s1": 1, "s4": 2}),
    ({}, {"s0": 2, "s1": 1, "s4": 2}),
    ({}, {"s0": 2, "s1": 1, "s4": 2, "m": 1}),
    ({}, {"s0": 1, "s1": 1, "s4": 2, "s5": 1}),
    ({"v3": 1}, {"s0": 1, "s1": 1, "s4": 2, "s5": 1}),
    ({"v3": 1}, {"s0": 0, "s1": 2, "s4": 0, "s5": 1}),
    ({}, {}),
]


def _share(problem):
    """``problem`` with its binary bucket in the shared-table form (one
    ``[1, d, d]`` table for all its constraints, as ``compile_from_arrays``
    packs a coloring).  Every binary table of ``shared_only`` fixtures is
    the same, so the problem is unchanged in content; the DCOP compiler
    never packs a shared table itself."""
    import dataclasses

    b = problem.buckets[2]
    return dataclasses.replace(problem, buckets={
        **problem.buckets,
        2: dataclasses.replace(b, tables=b.tables[:1],
                               tables_t=b.tables_t[..., :1]),
    })


@pytest.fixture
def shared_compile(monkeypatch):
    """Both packages' incremental compilers compile to the shared-table
    form."""
    import pydcop_tpu.engine.incremental as jinc

    import pydcop_tpu_torch.engine.incremental as tinc

    for mod in (jinc, tinc):
        real = mod.compile_dcop
        monkeypatch.setattr(mod, "compile_dcop",
                            lambda *a, _real=real, **kw: _share(
                                _real(*a, **kw)))


@pytest.mark.parametrize(
    "pad_policy,bf16,shared_only",
    [("none", False, False), ("none", True, False),
     ("pow2:16", False, False), ("none", False, True)],
    ids=["f32", "bf16", "pow2-16", "shared-table"],
)
def test_incremental_equals_jax_and_fresh_compile(pad_policy, bf16,
                                                  shared_only, request):
    if shared_only:
        request.getfixturevalue("shared_compile")
    jc, tc = _compilers(pad_policy, bf16, shared_only=shared_only)
    with jsession() as jtel, session() as ttel:
        for frozen, ext in STEPS:
            jp, jfp = jc.compile(frozen, ext)
            tp, tfp = tc.compile(frozen, ext)
            assert tfp == jfp
            if bf16:
                _same_but_unary(tp, jp, STEPS.index((frozen, ext)) + 1)
            else:
                assert_same_problem(tp, jp)
            fresh = compile_dcop(
                tc._active_dcop(frozen, {
                    n: ext.get(n, ev.value)
                    for n, ev in tc.dcop.external_variables.items()}),
                pad_policy=pad_policy,
                table_dtype="bf16" if bf16 else None, device=CPU,
            )
            if shared_only:
                assert tp.buckets[2].shared_table
                fresh = _share(fresh)
            for name, arr in _snapshot(fresh).items():
                np.testing.assert_array_equal(
                    interop.to_numpy(_port_leaves(tp)[name]), arr,
                    err_msg=name)
        want, got = _counters(jtel.summary()), _counters(ttel.summary())
    assert got == want
    if shared_only:
        # a shared table turns incremental updates off: every value
        # change recompiles in full
        assert got["compile.incremental"] == 0
        assert got["compile.full"] >= 5
    else:
        assert got["compile.incremental"] >= 3
        assert got["compile.full"] == 3
        assert got["compile.reused"] >= 2


def _same_but_unary(tp, jp, n_updates):
    """Every leaf bit-equal to the JAX package's but ``unary``: the JAX
    package adds each update's delta to a bf16 row (one rounding per
    update, each at most 2^-8 of a row value below 2) where the port
    folds the row again and rounds once, as a fresh compile does
    (ROADMAP.md, C, 'Incremental unary rows')."""
    pl, jl = _port_leaves(tp), _jax_leaves(jp)
    assert sorted(pl) == sorted(jl)
    for name, want in jl.items():
        got = interop.to_numpy(pl[name])
        want = want.astype(np.float32) if want.dtype.name == "bfloat16" \
            else want
        if name == "unary":
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=n_updates * 2 * 2**-8)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)


def test_noisy_unary_rows_equal_a_fresh_compile():
    """``v0`` carries noisy value costs and two fractional tracks: after
    each update its row equals a fresh compile bit for bit (the JAX
    package's delta adds agree with it within f32 rounding)."""
    from pydcop_tpu.utils.expressionfunction import ExpressionFunction as JE

    from pydcop_tpu_torch.utils.expressionfunction import (
        ExpressionFunction as TE,
    )

    dcops = []
    for m, expr in ((jdcop, JE), (tdcop, TE)):
        dcop = sensor_dcop(m)
        d = dcop.variables["v1"].domain
        w = m.VariableNoisyCostFunc("w", d, expr("w * 0.37"),
                                    noise_level=0.3)
        dcop.add_variable(w)
        for k in (0, 1):
            dcop.add_constraint(m.constraint_from_str(
                f"wtrack_{k}", f"0 if w == s{k} else 0.{k + 3}17",
                [w, dcop.external_variables[f"s{k}"]]))
        dcop.add_constraint(m.constraint_from_str(
            "wlink", "1 if w == v1 else 0", [w, dcop.variables["v1"]]))
        dcops.append(dcop)
    jc = JCompiler(dcops[0])
    tc = IncrementalCompiler(dcops[1], device=CPU)
    for ext in ({}, {"s0": 2}, {"s0": 1, "s1": 2}, {"s0": 2, "s1": 1},
                {"s1": 0}):
        jp, _ = jc.compile({}, ext)
        tp, _ = tc.compile({}, ext)
        fresh = compile_dcop(tc._active_dcop({}, {
            n: ext.get(n, ev.value)
            for n, ev in tc.dcop.external_variables.items()}), device=CPU)
        np.testing.assert_array_equal(interop.to_numpy(tp.unary),
                                      interop.to_numpy(fresh.unary))
        np.testing.assert_allclose(interop.to_numpy(tp.unary),
                                   np.asarray(jp.unary), rtol=0, atol=1e-6)


def test_duplicate_unary_slots_fold_once():
    """Two tracked sensors on v0 change in one compile: v0's row is
    folded again once, equal to the JAX package's (exact costs here)."""
    jc, tc = _compilers()
    jc.compile({}, {})
    tc.compile({}, {})
    jp, _ = jc.compile({}, {"s0": 2, "s1": 1})
    tp, _ = tc.compile({}, {"s0": 2, "s1": 1})
    slots = [tc._plan[f"track_{k}"]["slot"] for k in (0, 1)]
    assert slots[0] == slots[1]  # both fold into v0
    np.testing.assert_array_equal(
        interop.to_numpy(tp.unary), np.asarray(jp.unary))
    assert tc.last_update["constraints"] == 2


def test_updates_are_functional():
    """An update returns a new problem: the one handed out before keeps
    its arrays (checked against a host snapshot taken before the
    update), and reverting restores them and the fingerprint."""
    _, tc = _compilers()
    p0, fp0 = tc.compile({}, {})
    snap0 = _snapshot(p0)
    p1, fp1 = tc.compile({}, {"s0": 2, "s4": 1})
    assert fp1 != fp0 and p1 is not p0
    changed = [k for k, v in _snapshot(p1).items()
               if not np.array_equal(v, snap0[k])]
    assert "unary" in changed and "tables_flat" in changed
    for name, arr in _snapshot(p0).items():  # p0 untouched
        np.testing.assert_array_equal(arr, snap0[name], err_msg=name)
    p2, fp2 = tc.compile({}, {"s0": 0, "s4": 0})
    assert fp2 == fp0
    for name, arr in _snapshot(p2).items():
        np.testing.assert_array_equal(arr, snap0[name], err_msg=name)
    assert p1.var_names is p0.var_names
    assert tc.last_update["written_bytes"] > 0
    assert tc.last_update["copied_bytes"] >= tc.last_update["written_bytes"]


def test_fully_external_change_is_a_reuse():
    """``m`` is read by ``mirror`` alone, which the compiler drops: a
    change there reuses the problem and keeps the fingerprint (and so
    the engine's state carry), as in the JAX package."""
    jc, tc = _compilers()
    with jsession() as jtel, session() as ttel:
        _, jfa = jc.compile({}, {})
        pa, tfa = tc.compile({}, {})
        _, jfb = jc.compile({}, {"m": 2})
        pb, tfb = tc.compile({}, {"m": 2})
        assert tfa == tfb == jfa == jfb
        assert pb is pa
        got = _counters(ttel.summary())
        assert got == _counters(jtel.summary())
        assert got == {"compile.full": 1, "compile.incremental": 0,
                       "compile.reused": 1}


def test_everything_frozen_compiles_to_none():
    _, tc = _compilers(n=4, n_sensors=2)
    frozen = {f"v{i}": 0 for i in range(4)}
    assert tc.compile(frozen, {}) == (None, None)


def test_cuda_default_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from pydcop_tpu_torch.device import NoCudaDeviceError

    with pytest.raises(NoCudaDeviceError):
        IncrementalCompiler(sensor_dcop(tdcop))
