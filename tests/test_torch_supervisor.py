"""The port's supervised device dispatch (``engine/supervisor.py``) against
the JAX package's, case by case as ``tests/test_supervisor.py`` runs them
(CPU).

The fault plans, the keyed backoff and the classification are the JAX
package's bit for bit: every ``decide_*`` agrees for every ``(seed,
scope, seq)`` tried.  An engine run under a chaos spec fires the same
injected faults on the same dispatches, so its recovery counters
(``engine.retries``, ``engine.oom_splits``, ``engine.oom_chunk_halvings``,
``engine.quarantined_instances``, ``engine.numeric_faults``,
``fault.*``) equal the JAX run's under the same spec and seed.  The
packages draw different random numbers (ROADMAP.md, C), so results are
held against the port's own fault-free run, bit for bit; DPOP, which
draws nothing, also against the JAX package's.  Lowering notes pinned
here (ROADMAP.md, C): a halved or retried chunk continues the same
generator stream, and a split half of a stochastic group equals that
half run alone.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import pydcop_tpu.dcop as jdcop  # noqa: E402
from pydcop_tpu.api import solve as jsolve  # noqa: E402
from pydcop_tpu.api import solve_many as jsolve_many  # noqa: E402
from pydcop_tpu.engine import supervisor as jsup  # noqa: E402
from pydcop_tpu.faults.plan import FaultPlan as JPlan  # noqa: E402
from pydcop_tpu.utils.backoff import backoff_delays as jdelays  # noqa: E402

import pydcop_tpu_torch.dcop as tdcop  # noqa: E402
from pydcop_tpu_torch.algorithms import load_algorithm_module  # noqa: E402
from pydcop_tpu_torch.algorithms import prepare_algo_params  # noqa: E402
from pydcop_tpu_torch.api import solve, solve_many  # noqa: E402
from pydcop_tpu_torch.engine import batched  # noqa: E402
from pydcop_tpu_torch.engine.supervisor import (  # noqa: E402
    UNSUPERVISED,
    DeviceOOMError,
    DeviceTransientError,
    Supervisor,
    SupervisorConfig,
    UnrecoverableDeviceError,
    classify_failure,
    get_supervisor,
    make_supervisor,
    supervision,
)
from pydcop_tpu_torch.faults.plan import FaultPlan, FaultSpecError  # noqa: E402
from pydcop_tpu_torch.ops import compile as tcompile  # noqa: E402
from pydcop_tpu_torch.utils.backoff import backoff_delays  # noqa: E402

CPU = "cpu"
COUNTERS = ("engine.retries", "engine.oom_splits",
            "engine.oom_chunk_halvings", "engine.quarantined_instances",
            "engine.numeric_faults", "engine.instances_batched",
            "fault.device_oom", "fault.device_transient",
            "fault.nan_inject", "dpop.level_dispatches",
            "membound.replans")


def ring_dcop(m, n=6):
    """The JAX test's ring, built with package ``m``'s objects."""
    d = m.Domain("d", "", [0, 1, 2])
    dcop = m.DCOP("ring%d" % n, objective="min")
    vs = [m.Variable(f"v{i}", d) for i in range(n)]
    for v in vs:
        dcop.add_variable(v)
    for i in range(n):
        j = (i + 1) % n
        dcop.add_constraint(m.constraint_from_str(
            f"c{i}_{j}", f"1 if v{i} == v{j} else 0", vs
        ))
    dcop.add_agents([m.AgentDef(f"a{i}") for i in range(n)])
    return dcop


def star_dcop(m, n=6):
    """A hub and ``n`` leaves: DPOP stacks the leaves in one level."""
    d = m.Domain("d", "", [0, 1, 2])
    dcop = m.DCOP("star%d" % n, objective="min")
    vs = [m.Variable(f"v{i}", d) for i in range(n + 1)]
    for v in vs:
        dcop.add_variable(v)
    for i in range(1, n + 1):
        dcop.add_constraint(m.constraint_from_str(
            f"c0_{i}", f"{i % 3} if v0 == v{i} else v{i} * 0.25", vs
        ))
    dcop.add_agents([m.AgentDef(f"a{i}") for i in range(n + 1)])
    return dcop


def counters(result):
    c = result["telemetry"]["counters"]
    return {k: c[k] for k in COUNTERS if k in c}


def same(got, want, keys=("status", "assignment", "cost", "final_cost",
                          "final_assignment", "cycle", "cost_trace")):
    for k in keys:
        assert got[k] == want[k], (k, got[k], want[k])


# -- the spec and plan ---------------------------------------------------

SPECS = [
    "device_oom=16:256,device_transient=0.25:3,nan_inject=0.5:2",
    "device_oom=-:128",
    "device_oom=4",
    "device_oom_bytes=4096",
    "drop=0.1,device_oom=8",
    "device_transient=0.5",
    "nan_inject=1:3",
    "conn_drop=0.1",
    "replica_kill=2.5:1",
    "drop=0.05,dup=0.02,a1>a2:drop=0.5,partition=a1-a2@0.5+2,crash=a3@1.5",
]


@pytest.mark.parametrize("spec", SPECS)
def test_plan_parses_as_jax(spec):
    """Every kind parses to the JAX package's plan, and the pure
    decisions agree for every (seed, scope, seq) tried."""
    for seed in (0, 3, 11):
        want, got = JPlan.from_spec(spec, seed), FaultPlan.from_spec(spec,
                                                                     seed)
        assert got.to_meta() == want.to_meta()
        assert repr(got.device) == repr(want.device).replace(
            "pydcop_tpu.", "pydcop_tpu_torch.")
        for attr in ("device_faults_configured", "message_faults_configured",
                     "wire_faults_configured", "fleet_faults_configured"):
            assert getattr(got, attr) == getattr(want, attr), attr
        for scope in ("engine.chunk", "engine.group", "dpop.level", "s"):
            for seq in range(1, 30):
                assert got.decide_device_transient(scope, seq) == \
                    want.decide_device_transient(scope, seq)
        for lane in range(8):
            for seq in range(1, 12):
                assert got.decide_nan_inject(lane, seq) == \
                    want.decide_nan_inject(lane, seq)
        for w, r, b in ((1, None, None), (8, 64, None), (5, 300, 10 ** 6),
                        (10_000, 64, 512)):
            assert got.oom_injected(w, r, b) == want.oom_injected(w, r, b)


def test_device_spec_fields():
    plan = FaultPlan.from_spec(
        "device_oom=16:256,device_transient=0.25:3,nan_inject=0.5:2", 7)
    d = plan.device
    assert d.oom_width_cap == 16 and d.oom_rounds_cap == 256
    assert d.transient == 0.25 and d.transient_after == 3
    assert d.nan == 0.5 and d.nan_instance == 2
    assert plan.device_faults_configured
    assert not plan.message_faults_configured
    rounds_only = FaultPlan.from_spec("device_oom=-:128", 0)
    assert rounds_only.device.oom_width_cap is None
    assert not rounds_only.oom_injected(10_000, 64)
    assert rounds_only.oom_injected(1, 129)
    cap = FaultPlan.from_spec("device_oom=4", 3)
    assert cap.oom_injected(8) and cap.oom_injected(5)
    assert not cap.oom_injected(4) and not cap.oom_injected(1)
    late = FaultPlan.from_spec("device_transient=1:3", 0)
    assert [late.decide_device_transient("s", i) for i in range(1, 6)] == [
        False, False, False, True, True]
    assert FaultPlan.from_spec("drop=0.1,device_oom=8", 1).to_meta()[
        "spec"] == "drop=0.1,device_oom=8"


@pytest.mark.parametrize("spec", ["device_transient=1.5", "nan_inject=x",
                                  "device_oom="])
def test_bad_specs_rejected_as_jax(spec):
    with pytest.raises(ValueError) as want:
        JPlan.from_spec(spec, 0)
    with pytest.raises(FaultSpecError) as got:
        FaultPlan.from_spec(spec, 0)
    assert str(got.value) == str(want.value)


# -- failure classification ----------------------------------------------

JAX_CASES = [
    (lambda m: m.DeviceOOMError("x"), "oom"),
    (lambda m: m.DeviceTransientError("x"), "transient"),
    (lambda m: MemoryError(), "oom"),
    (lambda m: RuntimeError("RESOURCE_EXHAUSTED: out of memory"), "oom"),
    (lambda m: RuntimeError("UNAVAILABLE: socket closed"), "transient"),
    (lambda m: ValueError("bad shape"), "fatal"),
]


@pytest.mark.parametrize("i", range(len(JAX_CASES)))
def test_classify_failure_as_jax(i):
    import pydcop_tpu_torch.engine.supervisor as tsup

    make, kind = JAX_CASES[i]
    assert jsup.classify_failure(make(jsup)) == kind
    assert classify_failure(make(tsup)) == kind


@pytest.mark.parametrize("exc,kind", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                                 "2.00 GiB"), "oom"),
    (RuntimeError("CUDA out of memory. Tried to allocate 20.00 MiB"), "oom"),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     "fatal"),
    (RuntimeError("CUDA error: unspecified launch failure"), "fatal"),
    (RuntimeError("CUDA error: device-side assert triggered"), "fatal"),
    (RuntimeError("CUDA error: misaligned address"), "fatal"),
    # INTERNAL inside a library error must not make a poisoned context
    # look transient
    (RuntimeError("CUBLAS_STATUS_INTERNAL_ERROR after an illegal memory "
                  "access"), "fatal"),
    (RuntimeError("CUDA kernel q_update was not launched: cudaError 9"),
     "fatal"),
])
def test_classify_cuda_failures(exc, kind):
    assert classify_failure(exc) == kind


# -- the keyed backoff ---------------------------------------------------

def test_backoff_keyed_equals_jax():
    take = lambda it, n: [next(it) for _ in range(n)]  # noqa: E731
    for seed in (0, 1, 5, 6):
        for key in ("k1", "k2", "supervisor:engine.chunk"):
            assert take(backoff_delays(seed=seed, key=key), 6) == take(
                jdelays(seed=seed, key=key), 6)
    a = take(backoff_delays(seed=5, key="k1"), 6)
    assert a != take(backoff_delays(seed=5, key="k2"), 6)
    assert a != take(backoff_delays(seed=6, key="k1"), 6)
    assert take(backoff_delays(base=0.1, factor=2.0, max_delay=0.5,
                               jitter=0.0, seed=0, key="k"), 5) == [
        0.1, 0.2, 0.4, 0.5, 0.5]
    # two keyed streams interleaved give their solo schedules
    s1, s2 = backoff_delays(seed=1, key="a"), backoff_delays(seed=1, key="b")
    mixed = [(next(s1), next(s2)) for _ in range(4)]
    assert [x for x, _ in mixed] == take(backoff_delays(seed=1, key="a"), 4)
    assert [y for _, y in mixed] == take(backoff_delays(seed=1, key="b"), 4)


# -- Supervisor.dispatch -------------------------------------------------

def _sups(spec=None, seed=0, **kw):
    """(JAX supervisor, port supervisor) with the same knobs."""
    kw.setdefault("sleep", lambda _t: None)
    out = []
    for mod, plan_cls in ((jsup, JPlan), (None, FaultPlan)):
        plan = plan_cls.from_spec(spec, seed) if spec else None
        if mod is None:
            out.append(Supervisor(SupervisorConfig(plan=plan, **kw)))
        else:
            out.append(mod.Supervisor(mod.SupervisorConfig(plan=plan, **kw)))
    return out


def _flaky(fail, exc):
    calls = []

    def fn():
        calls.append(1)
        if len(calls) <= fail:
            raise exc
        return "ok"

    return fn, calls


@pytest.mark.parametrize("case", [
    "retry-then-succeed", "exhausted", "oom-surfaces", "fatal",
    "not-retryable",
])
def test_dispatch_as_jax(case):
    """Each dispatch case gives the JAX answer: value or exception kind,
    attempts and the number of calls of the closure."""
    outcomes = []
    for sup, m in zip(_sups(retry_budget=3 if case != "exhausted" else 2),
                      (jsup, None)):
        errs = m or __import__("pydcop_tpu_torch.engine.supervisor",
                               fromlist=["x"])
        exc = {
            "retry-then-succeed": errs.DeviceTransientError("blip"),
            "exhausted": errs.DeviceTransientError("always"),
            "oom-surfaces": RuntimeError("RESOURCE_EXHAUSTED: no memory"),
            "fatal": ValueError("shape"),
            "not-retryable": RuntimeError("UNAVAILABLE: socket closed"),
        }[case]
        fn, calls = _flaky(2 if case == "retry-then-succeed" else 99, exc)
        try:
            got = sup.dispatch(fn, retryable=case != "not-retryable")
        except Exception as e:  # noqa: BLE001 — compared below
            got = (type(e).__name__, getattr(e, "kind", None),
                   getattr(e, "attempts", None))
        outcomes.append((got, len(calls)))
    assert outcomes[1] == outcomes[0]
    want = {
        "retry-then-succeed": ("ok", 3),
        "exhausted": (("UnrecoverableDeviceError", "transient", 2), 3),
        "oom-surfaces": (("DeviceOOMError", None, None), 1),
        "fatal": (("ValueError", None, None), 1),
        "not-retryable": (("DeviceTransientError", None, None), 1),
    }[case]
    assert outcomes[1] == want


def test_dispatch_injects_from_plan_as_jax():
    for sup in _sups("device_oom=4", seed=1):
        with pytest.raises(RuntimeError, match="injected device OOM"):
            sup.dispatch(lambda: "ran", width=8)
        assert sup.dispatch(lambda: "ran", width=4) == "ran"
    # retries draw fresh sequence numbers: P < 1 lets one through, and an
    # injected transient retries in place even when not retryable
    for retryable in (True, False):
        runs = []
        for sup in _sups("device_transient=0.5", seed=0, retry_budget=5):
            fn, calls = _flaky(0, None)
            assert sup.dispatch(fn, scope="engine.chunk",
                                retryable=retryable) == "ok"
            runs.append((len(calls), sup._seq))
        assert runs[0] == runs[1] and runs[1][0] == 1


def test_dispatch_fatal_cuda_error_is_not_retried():
    [_, sup] = _sups(retry_budget=5)
    fn, calls = _flaky(99, RuntimeError(
        "CUDA error: an illegal memory access was encountered (INTERNAL)"))
    with pytest.raises(RuntimeError, match="illegal memory access"):
        sup.dispatch(fn)
    assert len(calls) == 1


def test_supervision_context_and_default():
    default = get_supervisor()
    assert default.active and default.plan is None
    mine = make_supervisor(retry_budget=9)
    with supervision(mine):
        assert get_supervisor() is mine
    assert get_supervisor() is default
    assert UNSUPERVISED.dispatch(lambda: 42) == 42
    assert UNSUPERVISED.nan_lanes(8) == []


@pytest.mark.parametrize("kw", [{"retry_budget": -1}, {"chunk_floor": 0},
                                {"on_numeric_fault": "explode"}])
def test_config_validation_as_jax(kw):
    with pytest.raises(ValueError) as want:
        jsup.SupervisorConfig(**kw)
    with pytest.raises(ValueError) as got:
        SupervisorConfig(**kw)
    assert str(got.value) == str(want.value)


# -- solve_many: group split, quarantine ---------------------------------

def both_many(algo, spec, chaos_seed, dcops_of, **kw):
    """(JAX chaos run, port chaos run, port fault-free run)."""
    want = jsolve_many(dcops_of(jdcop), algo, chaos=spec,
                       chaos_seed=chaos_seed, **kw)
    got = solve_many(dcops_of(tdcop), algo, chaos=spec,
                     chaos_seed=chaos_seed, device=CPU, **kw)
    base = solve_many(dcops_of(tdcop), algo, device=CPU, **kw)
    return want, got, base


MANY = dict(rounds=24, chunk_size=12, pad_policy="pow2:16", seed=7)


def test_solve_many_oom_group_split():
    """K=8 under device_oom=4: one split, every instance equal to the
    fault-free group, counters equal to the JAX run's."""
    want, got, base = both_many(
        "mgm", "device_oom=4", 3,
        lambda m: [ring_dcop(m, 5 + i % 3) for i in range(8)], **MANY)
    for g, b in zip(got, base):
        same(g, b)
    assert counters(got[0]) == counters(want[0])
    assert counters(got[0])["engine.oom_splits"] == 1
    assert got[0]["chaos"] == want[0]["chaos"] == {"spec": "device_oom=4",
                                                   "seed": 3}


def test_solve_many_oom_recursive_split_to_singles():
    want, got, base = both_many(
        "mgm", "device_oom=1", 0, lambda m: [ring_dcop(m, 6)] * 4,
        rounds=12, chunk_size=12, pad_policy="pow2:16", seed=1)
    for g, b in zip(got, base):
        same(g, b)
    assert counters(got[0]) == counters(want[0])
    assert counters(got[0])["engine.oom_splits"] == 3  # 4 -> 2+2 -> 1 x 4


def test_solve_many_nan_quarantine_spares_the_group():
    want, got, base = both_many(
        "mgm", "nan_inject=1:2", 3,
        lambda m: [ring_dcop(m, 5 + i % 3) for i in range(8)], **MANY)
    assert [r["status"] for r in got] == [r["status"] for r in want]
    assert [r["status"] for r in got].count("degraded") == 1
    assert got[2]["status"] == "degraded" and np.isfinite(got[2]["cost"])
    for i, (g, b) in enumerate(zip(got, base)):
        if i != 2:
            same(g, b)
    # the degraded lane's final is its last finite best
    assert got[2]["final_cost"] == got[2]["cost"]
    # poisoned at the first chunk's last sample (chunk 12, cost every
    # round); the samples before it are the fault-free ones
    assert got[2]["cost_trace"][:11] == base[2]["cost_trace"][:11]
    assert np.isnan(got[2]["cost_trace"][11])
    assert counters(got[0]) == counters(want[0])
    assert counters(got[0])["engine.quarantined_instances"] == 1


def test_solve_many_numeric_fault_raise_mode():
    kw = dict(rounds=12, chunk_size=12, pad_policy="pow2:16",
              chaos="nan_inject=1:1", chaos_seed=0, on_numeric_fault="raise")
    with pytest.raises(jsup.UnrecoverableDeviceError) as want:
        jsolve_many([ring_dcop(jdcop, 6)] * 3, "mgm", **kw)
    with pytest.raises(UnrecoverableDeviceError) as got:
        solve_many([ring_dcop(tdcop, 6)] * 3, "mgm", device=CPU, **kw)
    assert got.value.kind == want.value.kind == "numeric"
    assert str(got.value) == str(want.value)


def test_split_half_of_a_stochastic_group_equals_the_half_alone():
    """DSA on the union draws from one generator seeded with the group's
    first seed: a split half equals run_many_batched on that half alone
    (ROADMAP.md, C), not the unsplit group."""
    dcops = [ring_dcop(tdcop, 6)] * 4
    probs = [tcompile.compile_dcop(d, pad_policy="pow2:16", device=CPU)
             for d in dcops]
    mod = load_algorithm_module("dsa")
    params = prepare_algo_params({"variant": "B"}, mod.algo_params)
    kw = dict(rounds=24, chunk_size=8)
    seeds = [3, 4, 5, 6]
    with supervision(make_supervisor(plan=FaultPlan.from_spec(
            "device_oom=2", 0))):
        split = batched.run_many_batched(
            tcompile.stack_problems(probs)[0], mod, params, seeds=seeds,
            **kw)
    for lo, hi in ((0, 2), (2, 4)):
        alone = batched.run_many_batched(
            tcompile.stack_problems(probs[lo:hi])[0], mod, params,
            seeds=seeds[lo:hi], **kw)
        for s_, a in zip(split[lo:hi], alone):
            assert s_.best_assignment == a.best_assignment
            np.testing.assert_array_equal(s_.cost_trace, a.cost_trace)


def test_oom_split_frees_the_group_before_its_halves(monkeypatch):
    """A split hands the failed group's stacked tensors back before its
    halves are stacked: weak references to them are dead when the first
    half starts (``api.solve_many`` hands each group over), and the
    split counts stay the JAX package's."""
    import weakref

    refs, alive = [], []
    real = tcompile.stack_problems

    def first(problems):  # api.solve_many stacks the group
        out = real(problems)
        refs.extend(weakref.ref(t) for t in (
            out[0].problem.tables_flat, out[0].problem.unary,
            out[0].problem.buckets[2].tables_t))
        return out

    def halves(problems):  # run_many_batched stacks each half
        alive.append([r() is not None for r in refs])
        return real(problems)

    monkeypatch.setattr(tcompile, "stack_problems", first)
    monkeypatch.setattr(batched, "stack_problems", halves)
    got = solve_many([ring_dcop(tdcop, 6)] * 4, "maxsum", {}, rounds=12,
                     chunk_size=12, pad_policy="pow2:16",
                     chaos="device_oom=2", device=CPU)
    want = jsolve_many([ring_dcop(jdcop, 6)] * 4, "maxsum", {}, rounds=12,
                       chunk_size=12, pad_policy="pow2:16",
                       chaos="device_oom=2")
    assert len(refs) == 3 and len(alive) == 2  # two halves
    assert alive == [[False] * 3] * 2
    assert counters(got[0]) == counters(want[0])
    assert counters(got[0])["engine.oom_splits"] == 1


def test_run_many_batched_takes_a_holder():
    """A one-element list hands the group over: the call empties it."""
    probs = [tcompile.compile_dcop(ring_dcop(tdcop, 6),
                                   pad_policy="pow2:16", device=CPU)] * 2
    mod = load_algorithm_module("mgm")
    params = prepare_algo_params({}, mod.algo_params)
    hand = tcompile.stack_problems(probs)
    got = batched.run_many_batched(hand, mod, params, rounds=8, seeds=1)
    assert hand == []
    want = batched.run_many_batched(tcompile.stack_problems(probs)[0], mod,
                                    params, rounds=8, seeds=1)
    for g, w in zip(got, want):
        assert g.best_assignment == w.best_assignment
        np.testing.assert_array_equal(g.cost_trace, w.cost_trace)
    with pytest.raises(ValueError, match="one-element list"):
        batched.run_many_batched([], mod, params, rounds=8)


# -- solve: retries, halving, floor, quarantine --------------------------

SOLO = dict(rounds=48, chunk_size=12, seed=3)


def both(algo, **kw):
    """(JAX run, port run) of the 6-ring under the same knobs."""
    want = jsolve(ring_dcop(jdcop), algo, mode="batched", **kw)
    got = solve(ring_dcop(tdcop), algo, device=CPU, **kw)
    return want, got


def test_solve_transient_retry_parity():
    want, got = both("dsa", chaos="device_transient=0.5", chaos_seed=3,
                     retry_budget=4, **SOLO)
    base = solve(ring_dcop(tdcop), "dsa", device=CPU, **SOLO)
    same(got, base)
    assert counters(got) == counters(want)
    assert counters(got)["engine.retries"] >= 1


@pytest.mark.parametrize("algo", ["mgm", "dsa"])
def test_solve_oom_chunk_halving(algo):
    """A rounds cap halves the chunk until it fits; the halved run
    continues the same generator stream, so DSA too equals its
    fault-free run (the JAX package's stream changes there)."""
    kw = dict(rounds=48, chunk_size=48, seed=3)
    want, got = both(algo, chaos="device_oom=-:16", chaos_seed=0,
                     chunk_floor=4, **kw)
    base = solve(ring_dcop(tdcop), algo, device=CPU, **kw)
    same(got, base, ("status", "assignment", "cost", "final_cost",
                     "final_assignment", "cycle"))
    assert counters(got) == counters(want)
    assert counters(got)["engine.oom_chunk_halvings"] == 2


def test_solve_oom_below_floor_unrecoverable(tmp_path):
    kw = dict(rounds=48, chunk_size=16, seed=3, chaos="device_oom=-:1",
              chaos_seed=0, chunk_floor=8, checkpoint_every=999)
    with pytest.raises(jsup.UnrecoverableDeviceError) as want:
        jsolve(ring_dcop(jdcop), "mgm", mode="batched",
               checkpoint_path=str(tmp_path / "jax.npz"), **kw)
    ck = str(tmp_path / "final.npz")
    with pytest.raises(UnrecoverableDeviceError) as got:
        solve(ring_dcop(tdcop), "mgm", device=CPU, checkpoint_path=ck, **kw)
    assert got.value.kind == want.value.kind == "oom"
    assert os.path.exists(ck)  # the supervisor's final checkpoint


def test_solve_nan_quarantine_single_run_degrades(tmp_path):
    ck = str(tmp_path / "never.npz")
    kw = dict(chaos="nan_inject=1", chaos_seed=0, **SOLO)
    want, got = both("dsa", **kw)
    assert got["status"] == want["status"] == "degraded"
    assert np.isfinite(got["cost"]) and got["final_cost"] == got["cost"]
    assert counters(got) == counters(want)
    assert counters(got)["engine.numeric_faults"] == 1
    # a degraded state never lands in a checkpoint
    again = solve(ring_dcop(tdcop), "dsa", device=CPU, checkpoint_path=ck,
                  checkpoint_every=999, **kw)
    assert again["status"] == "degraded" and not os.path.exists(ck)


def test_dpop_level_oom_falls_back_exactly():
    """DPOP level stacks over the width cap go per node: the JAX
    package's result, UTIL counts and counters."""
    prm = {"util_device": "always", "bnb": "off"}
    kw = dict(algo_params=prm, chaos="device_oom=1", chaos_seed=0)
    want = jsolve(star_dcop(jdcop), "dpop", mode="batched", **kw)
    got = solve(star_dcop(tdcop), "dpop", device=CPU, **kw)
    base = solve(star_dcop(tdcop), "dpop", prm, device=CPU)
    for k in ("assignment", "cost", "util_cells", "util_device_nodes",
              "util_host_nodes", "util_dispatches"):
        assert got[k] == want[k], k
    assert (got["assignment"], got["cost"]) == (base["assignment"],
                                                base["cost"])
    assert counters(got) == counters(want)
    assert counters(got)["engine.oom_splits"] >= 1


def test_membound_replans_under_device_oom_bytes():
    """The planner re-plans on an injected byte cap as the JAX one does."""
    prm = {"util_device": "always", "bnb": "off"}
    kw = dict(algo_params=prm, max_util_bytes=4 * 27,
              chaos="device_oom_bytes=64", chaos_seed=0)
    want, got = both("dpop", **kw)
    assert got["membound"] == want["membound"]
    assert got["membound"]["replans"] >= 1
    assert (got["assignment"], got["cost"]) == (want["assignment"],
                                                want["cost"])
    assert counters(got) == counters(want)


# -- the knob and chaos rejections ---------------------------------------

@pytest.mark.parametrize("kw", [
    dict(mode="thread", retry_budget=1),
    dict(mode="thread", chaos="device_oom=4"),
    dict(mode="thread", chaos="conn_drop=0.1"),
    dict(mode="sim", max_util_bytes=64),
])
def test_knobs_on_an_unported_mode_raise_not_ported(kw):
    """The message-driven modes are ported since ROADMAP A15a: a
    batched-engine knob or a foreign chaos kind on them meets the JAX
    package's ValueError and message, before the algorithm is looked at
    (MGM has host computations since A15b's first half, so nothing but
    the knob could raise here).  The name is kept from before
    A15a, when these modes raised the port's NotImplementedError."""
    with pytest.raises(ValueError) as want:
        jsolve(ring_dcop(jdcop, 3), "mgm", **kw)
    with pytest.raises(ValueError) as got:
        solve(ring_dcop(tdcop, 3), "mgm", device=CPU, **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("call,kw", [
    ("solve", dict(chaos="drop=0.5")),
    ("solve", dict(chaos="conn_drop=0.1")),
    ("solve", dict(chaos="replica_kill=2.5")),
    ("solve_many", dict(chaos="drop=0.5")),
    ("solve_many", dict(chaos="frame_corrupt=0.1")),
])
def test_knob_and_chaos_rejections_as_jax(call, kw):
    jfn, tfn = {"solve": (jsolve, solve),
                "solve_many": (jsolve_many, solve_many)}[call]
    one = (lambda m: ring_dcop(m, 3)) if call == "solve" else (
        lambda m: [ring_dcop(m, 3)])
    with pytest.raises(ValueError) as want:
        jfn(one(jdcop), "mgm", **kw)
    with pytest.raises(ValueError) as got:
        tfn(one(tdcop), "mgm", device=CPU, **kw)
    assert str(got.value) == str(want.value)


# -- real failures inside a chunk ----------------------------------------

@pytest.fixture
def fail_chunk_once(monkeypatch):
    """Make the engine's chunk raise ``text`` once, after it has run its
    rounds (so the generator has advanced)."""
    def arm(text):
        real = batched._run_chunk
        fired = []

        def chunk(*a, **k):
            out = real(*a, **k)
            if not fired:
                fired.append(1)
                raise RuntimeError(text)
            return out

        monkeypatch.setattr(batched, "_run_chunk", chunk)
        return fired
    return arm


def test_real_transient_retries_the_chunk_in_place(fail_chunk_once):
    """A real transient after the chunk drew its numbers: the retry
    starts from the chunk's generator state, so DSA ends as undisturbed."""
    base = solve(ring_dcop(tdcop), "dsa", device=CPU, **SOLO)
    fail_chunk_once("UNAVAILABLE: link blipped")
    got = solve(ring_dcop(tdcop), "dsa", device=CPU, **SOLO)
    same(got, base)
    assert counters(got)["engine.retries"] == 1


def test_real_oom_halves_the_chunk_in_place(fail_chunk_once):
    base = solve(ring_dcop(tdcop), "dsa", device=CPU, rounds=48,
                 chunk_size=48, seed=3)
    fail_chunk_once("CUDA out of memory. Tried to allocate 2.00 GiB")
    got = solve(ring_dcop(tdcop), "dsa", device=CPU, rounds=48,
                chunk_size=48, seed=3)
    same(got, base, ("status", "assignment", "cost", "final_cost"))
    assert counters(got)["engine.oom_chunk_halvings"] == 1


def test_real_transient_restarts_the_group(fail_chunk_once):
    """As the JAX package's donated group: a real transient restarts the
    whole group from round 0 (``group-restart``), results unchanged."""
    dcops = [ring_dcop(tdcop, 5 + i % 3) for i in range(4)]
    base = solve_many(dcops, "dsa", device=CPU, **MANY)
    fail_chunk_once("UNAVAILABLE: link blipped")
    got = solve_many(dcops, "dsa", device=CPU, trace=None, **MANY)
    for g, b in zip(got, base):
        same(g, b)
    assert counters(got[0])["engine.retries"] == 1


def test_real_oom_single_lane_restarts_halved(fail_chunk_once):
    dcops = [ring_dcop(tdcop, 6)]
    kw = dict(rounds=24, chunk_size=24, pad_policy="pow2:16", seed=7)
    base = solve_many(dcops, "mgm", device=CPU, **kw)
    fail_chunk_once("RESOURCE_EXHAUSTED: out of memory allocating")
    got = solve_many(dcops, "mgm", device=CPU, **kw)
    same(got[0], base[0], ("status", "assignment", "cost"))
    assert counters(got[0])["engine.oom_chunk_halvings"] == 1


def test_real_fatal_error_is_reported_with_a_final_checkpoint(
        fail_chunk_once, tmp_path):
    ck = str(tmp_path / "f.npz")
    fail_chunk_once("CUDA error: an illegal memory access was encountered")
    with pytest.raises(RuntimeError, match="illegal memory access"):
        solve(ring_dcop(tdcop), "dsa", device=CPU, checkpoint_path=ck,
              checkpoint_every=999, **SOLO)
    assert not os.path.exists(ck)  # fatal: no final write, the error is it


@pytest.mark.parametrize("algo", ["maxsum", "amaxsum", "dsa", "dsatuto",
                                  "adsa", "mgm", "mgm2", "dba", "gdba"])
def test_steps_never_write_into_the_carried_state(algo):
    """Why a retried chunk may restart from the chunk-start carry: a
    step returns new tensors and leaves its input state as it was."""
    problem = tcompile.compile_dcop(ring_dcop(tdcop, 7), device=CPU)
    mod = load_algorithm_module(algo)
    params = prepare_algo_params({}, mod.algo_params)
    state = mod.init_state(problem, 0, params, (2,))
    gen = batched.round_generator(0, problem.device)
    for _ in range(3):
        before = {k: v.clone() for k, v in state.items()}
        new = mod.step(problem, state, params, gen)
        for k, v in before.items():
            assert torch.equal(state[k], v), (algo, k)
        state = new


# -- crash-resume --------------------------------------------------------

def test_crash_resume_bit_identical(tmp_path):
    """Killed by device_transient past the retry budget, resumed from
    the supervisor's final checkpoint: the uninterrupted run's result."""
    ck = str(tmp_path / "crash.npz")
    base = solve(ring_dcop(tdcop), "dsa", device=CPU, **SOLO)
    kw = dict(chaos="device_transient=1:2", chaos_seed=0, retry_budget=1)
    with pytest.raises(jsup.UnrecoverableDeviceError) as want:
        jsolve(ring_dcop(jdcop), "dsa", mode="batched",
               checkpoint_path=str(tmp_path / "jax.npz"),
               checkpoint_every=999, **kw, **SOLO)
    with pytest.raises(UnrecoverableDeviceError) as got:
        solve(ring_dcop(tdcop), "dsa", device=CPU, checkpoint_path=ck,
              checkpoint_every=999, **kw, **SOLO)
    assert (got.value.kind, got.value.attempts) == (want.value.kind,
                                                    want.value.attempts)
    resumed = solve(ring_dcop(tdcop), "dsa", device=CPU, checkpoint_path=ck,
                    resume=True, **SOLO)
    same(resumed, base)


# -- chunk callbacks -----------------------------------------------------

def test_chunk_callbacks_as_jax():
    """The 2-argument form sees each boundary (not the last) with the
    best cost; a returned status ends the run; a wants_values callback
    gets the values; restarts refuse a wants_values callback."""
    problem = tcompile.compile_dcop(ring_dcop(tdcop, 6), device=CPU)
    mod = load_algorithm_module("mgm")
    params = prepare_algo_params({}, mod.algo_params)
    seen = []
    r = batched.run_batched(problem, mod, params, rounds=48, chunk_size=12,
                            chunk_callback=lambda n, b: seen.append((n, b)))
    assert [n for n, _ in seen] == [12, 24, 36]
    assert seen[-1][1] <= seen[0][1] and r.status == "finished"
    stop = batched.run_batched(
        problem, mod, params, rounds=48, chunk_size=12,
        chunk_callback=lambda n, b: "stopped" if n >= 24 else None)
    assert (stop.status, stop.cycles) == ("stopped", 24)

    def with_values(n, b, values):
        seen.append(values.shape)

    with_values.wants_values = True
    batched.run_batched(problem, mod, params, rounds=24, chunk_size=12,
                        chunk_callback=with_values)
    assert seen[-1] == (problem.n_vars,)
    with pytest.raises(ValueError, match="wants_values"):
        batched.run_batched(problem, mod, params, rounds=24, n_restarts=2,
                            chunk_callback=with_values)


# -- the CLIs ------------------------------------------------------------

def test_cli_chaos_flags(capsys):
    """``solve --chaos --chaos_seed --chunk_floor`` and ``solve --many
    --chaos``, as the JAX CLI spells them; ``infer --retry_budget``."""
    import json

    from pydcop_tpu_torch.cli import main as tmain

    ring = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "graph_coloring_3.yaml")

    def run(argv):
        assert tmain(argv) == 0
        return json.loads(capsys.readouterr().out)

    r = run(["solve", "-a", "maxsum", "--rounds", "64", "--chunk_floor", "4",
             "--chaos", "device_oom=-:16", "--chaos_seed", "1", "--device",
             "cpu", ring])
    assert r["chaos"] == {"spec": "device_oom=-:16", "seed": 1}
    assert r["telemetry"]["counters"]["engine.oom_chunk_halvings"] == 2
    many = run(["solve", "-a", "maxsum", "--many", "--rounds", "16",
                "--chaos", "device_oom=2", "--on_numeric_fault", "raise",
                "--retry_budget", "1", "--device", "cpu"] + [ring] * 4)
    assert [m["status"] for m in many] == ["finished"] * 4
    assert run(["infer", ring, "-q", "map", "--retry_budget", "1",
                "--torch_device", "cpu"])["cost"] == 0.0
