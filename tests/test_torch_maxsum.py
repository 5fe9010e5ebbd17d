"""The port's batched Max-Sum against the JAX package's, on the CPU.

Both packages get the same numpy-made problem arrays and the same numpy
state (the packages draw different random numbers, so the noise is made
here).  Tolerances: the JAX CPU path sums the belief with
``segment_sum`` while the port adds the incoming messages slot by slot
(``ops/costs.py``), so after one step belief and q agree to 1e-6 rather
than bit for bit; the factor phase (min/+) is bit-equal.  End to end the
JAX engine runs with its TPU belief lowering (the per-slot gather the
port uses everywhere), so trajectories cannot drift apart: the best
assignments are equal, and the best costs and cost traces, each an f32
sum over all constraints taken in another order, agree to 1e-6 and
1e-5 relative.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from pydcop_tpu.algorithms import load_algorithm_module as jax_algo  # noqa: E402
from pydcop_tpu.algorithms import prepare_algo_params as jax_params  # noqa: E402
from pydcop_tpu.engine.batched import run_batched as jax_run  # noqa: E402
from pydcop_tpu.ops import compile as jcompile  # noqa: E402

from pydcop_tpu_torch import interop  # noqa: E402
from pydcop_tpu_torch.algorithms import load_algorithm_module  # noqa: E402
from pydcop_tpu_torch.algorithms import prepare_algo_params  # noqa: E402
from pydcop_tpu_torch.engine.batched import run_batched  # noqa: E402
from pydcop_tpu_torch.ops import compile as tcompile  # noqa: E402
from pydcop_tpu_torch.ops.generate import coloring_arrays  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RING = os.path.join(REPO, "examples", "graph_coloring_3.yaml")


def _instance(kind: str, n: int = 500):
    """(scopes, tables, d, unary) lists for compile_from_arrays."""
    scopes, table, unary = coloring_arrays(n, seed=1)
    rng = np.random.default_rng(11)
    if kind == "shared":
        return [scopes], [table], 3, unary
    if kind == "per_table":
        return (
            [scopes], [rng.random((len(scopes), 3, 3)).astype(np.float32)],
            3, unary,
        )
    if kind == "per_table_d10":  # 10 values: the lane-tile instance's d
        scopes, _, unary = coloring_arrays(n, colors=10, seed=1)
        tables = rng.random((len(scopes), 10, 10), dtype=np.float32)
        return [scopes], [tables], 10, unary
    if kind == "ternary":  # binary + ternary buckets: the generic path
        s3 = np.stack([rng.choice(n, 3, replace=False) for _ in range(n // 2)])
        t3 = rng.random((len(s3), 3, 3, 3)).astype(np.float32)
        return [scopes, s3], [table, t3], 3, unary
    raise ValueError(kind)


def _problems(kind: str, n: int = 500):
    scopes, tables, d, unary = _instance(kind, n)
    ref = jcompile.compile_from_arrays(scopes, tables, d, unary=unary)
    port = tcompile.compile_from_arrays(
        scopes, tables, d, unary=unary, device="cpu"
    )
    return ref, port


def _state(problem_ref, msg_dtype: str, seed: int = 3, random_q=False):
    """A numpy Max-Sum state for both packages."""
    rng = np.random.default_rng(seed)
    d, e, n = problem_ref.d_max, problem_ref.n_edges, problem_ref.n_vars
    mdt = jnp.bfloat16 if msg_dtype == "bf16" else np.float32
    q = rng.random((d, e)).astype(np.float32) if random_q else np.zeros((d, e), np.float32)
    return {
        "q": q.astype(mdt),
        "r": np.zeros((d, e), np.float32).astype(mdt),
        "values": np.zeros(n, np.int32),
        "noise": (0.001 * rng.random((d, n))).astype(np.float32),
    }


def _np(x):
    if isinstance(x, torch.Tensor):
        return interop.to_numpy(x)
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


@pytest.mark.parametrize("kind", ["shared", "per_table", "ternary"])
def test_one_step_matches_jax(kind):
    from pydcop_tpu.algorithms import maxsum as jms

    from pydcop_tpu_torch.algorithms import maxsum as tms

    ref, port = _problems(kind, n=200)
    st = _state(ref, "f32", random_q=True)
    params = {"damping": 0.5}
    jp = jax_params(params, jax_algo("maxsum").algo_params)
    tp = prepare_algo_params(params, tms.algo_params)
    out_j = jms.step(
        ref, {k: jnp.asarray(v) for k, v in st.items()},
        jax.random.PRNGKey(0), jp,
    )
    out_t = tms.step(port, interop.state_from_arrays(st, "cpu"), tp)
    np.testing.assert_array_equal(_np(out_t["r"]), _np(out_j["r"]))
    np.testing.assert_allclose(
        _np(out_t["q"]), _np(out_j["q"]), rtol=1e-6, atol=1e-6
    )
    np.testing.assert_array_equal(_np(out_t["values"]), _np(out_j["values"]))

    unary_t = np.asarray(ref.unary).T + st["noise"]
    b_j = jms.belief_from_r(ref, out_j["r"], jnp.asarray(unary_t))
    b_t = tms.belief_from_r(
        port, out_t["r"], torch.from_numpy(np.array(unary_t))
    )
    np.testing.assert_allclose(_np(b_t), _np(b_j), rtol=1e-6, atol=1e-6)


@pytest.fixture
def jax_gather_lowering(monkeypatch):
    """Run the JAX engine with its per-slot gather belief (the TPU
    lowering, which the port uses on every device) instead of the CPU
    ``segment_sum``: beliefs then agree bit for bit and trajectories
    cannot drift apart through summation order.  Runner caches are
    cleared on both sides so no executable traced with the other
    lowering is reused here, nor this one elsewhere."""
    from pydcop_tpu.engine import batched
    from pydcop_tpu.ops import costs

    monkeypatch.setattr(costs, "CPU_SEGMENT_MIN_EDGES", 1 << 62)
    batched._RUNNER_CACHE.clear()
    yield
    batched._RUNNER_CACHE.clear()


def _run_both(ref, port, msg_dtype="f32", rounds=64):
    params = {"damping": 0.5, "msg_dtype": msg_dtype}
    st = _state(ref, msg_dtype)
    kw = dict(rounds=rounds, chunk_size=32, cost_every=8, initial_state=st)
    rj = jax_run(
        ref, jax_algo("maxsum"),
        jax_params(params, jax_algo("maxsum").algo_params), **kw,
    )
    mod = load_algorithm_module("maxsum")
    rt = run_batched(
        port, mod, prepare_algo_params(params, mod.algo_params), **kw
    )
    return rj, rt


@pytest.mark.parametrize(
    "kind,msg_dtype",
    [("shared", "f32"), ("per_table", "f32"), ("ternary", "f32"),
     ("shared", "bf16")],
)
def test_run_batched_matches_jax(kind, msg_dtype, jax_gather_lowering):
    ref, port = _problems(kind)
    rj, rt = _run_both(ref, port, msg_dtype)
    assert rt.cycles == rj.cycles == 64
    assert rt.messages == rj.messages
    assert rt.status == rj.status == "finished"
    # the cost is one f32 sum over all constraints, taken in another
    # order by each package: equal to rounding, not bit for bit
    assert rt.best_cost == pytest.approx(rj.best_cost, rel=1e-6)
    assert rt.best_assignment == rj.best_assignment
    assert len(rt.cost_trace) == len(rj.cost_trace) == 8
    np.testing.assert_allclose(rt.cost_trace, rj.cost_trace, rtol=1e-5)


def test_run_batched_matches_jax_per_table_d10(jax_gather_lowering):
    """A per-factor instance with 10 values (random 10x10 tables; on the
    card the factor kernels' lane-tile instance runs it): 16 rounds from
    the same numpy state (shared noise) end with the JAX engine's q, r
    and values, bit for bit, and the same best assignment and cost."""
    ref, port = _problems("per_table_d10", n=200)
    assert port.d_max == 10 and not port.buckets[2].shared_table
    params = {"damping": 0.5}
    kw = dict(rounds=16, chunk_size=16, cost_every=8,
              initial_state=_state(ref, "f32"), return_state=True)
    rj = jax_run(
        ref, jax_algo("maxsum"),
        jax_params(params, jax_algo("maxsum").algo_params), **kw,
    )
    mod = load_algorithm_module("maxsum")
    rt = run_batched(
        port, mod, prepare_algo_params(params, mod.algo_params), **kw
    )
    for k in ("q", "r", "values"):  # the gather lowering: bit for bit
        np.testing.assert_array_equal(
            _np(rt.state[k]), rj.state[k], err_msg=k
        )
    assert rt.best_assignment == rj.best_assignment
    assert rt.best_cost == pytest.approx(rj.best_cost, rel=1e-6)


def test_run_batched_returns_state_and_rejects_unported_options(tmp_path):
    ref, port = _problems("shared", n=100)
    mod = load_algorithm_module("maxsum")
    params = prepare_algo_params({}, mod.algo_params)
    r = run_batched(port, mod, params, rounds=10, return_state=True)
    assert set(r.state) == {"q", "r", "values", "noise"}
    assert all(t.device.type == "cpu" for t in r.state.values())
    # continuing from the returned state equals one longer run
    r2 = run_batched(
        port, mod, params, rounds=5, initial_state=r.state,
        return_state=True,
    )
    r15 = run_batched(port, mod, params, rounds=15, return_state=True)
    for k in ("q", "r", "values"):
        assert torch.equal(r2.state[k], r15.state[k])
    with pytest.raises((TypeError, ValueError), match="Mesh"):
        run_batched(port, mod, params, rounds=1, mesh=object())
    # chunk callbacks are ported: called at every boundary but the last,
    # with the best cost so far, and the run is the same
    seen = []
    rcb = run_batched(port, mod, params, rounds=15, chunk_size=5,
                      chunk_callback=lambda n, b: seen.append((n, b)),
                      return_state=True)
    assert [n for n, _ in seen] == [5, 10]
    assert all(b >= rcb.best_cost for _, b in seen)
    for k in ("q", "r", "values"):
        assert torch.equal(rcb.state[k], r15.state[k])
    # checkpoints are ported (tests/test_torch_checkpoint.py): a run
    # resumed from round 10 ends where the 15-round run ends
    ck = str(tmp_path / "x.npz")
    run_batched(port, mod, params, rounds=10, checkpoint_path=ck)
    r15c = run_batched(port, mod, params, rounds=15, checkpoint_path=ck,
                       resume=True, return_state=True)
    for k in ("q", "r", "values"):
        assert torch.equal(r15c.state[k], r15.state[k])
    # restarts are ported: the state takes the [K] axis
    rk = run_batched(port, mod, params, rounds=2, n_restarts=2,
                     return_state=True)
    assert len(rk.restart_costs) == 2
    assert rk.state["q"].shape == (2,) + r.state["q"].shape
    # belief='blockdiag' is ported: its index rides the state (shared
    # by the restarts) and the run finds the same best assignment
    bd = prepare_algo_params({"belief": "blockdiag"}, mod.algo_params)
    rb = run_batched(port, mod, bd, rounds=15, n_restarts=2,
                     return_state=True)
    assert rb.state["bd_onehot"].dim() == 3
    assert rb.state["q"].shape == (2,) + r.state["q"].shape
    rb1 = run_batched(port, mod, bd, rounds=15)
    assert rb1.best_assignment == r15.best_assignment


def test_cli_matches_jax_solve():
    """``python -m pydcop_tpu_torch solve --device cpu`` prints the cost
    and assignment that ``pydcop_tpu.api.solve`` returns."""
    from pydcop_tpu.api import solve as jax_solve

    # noise 0: the two packages draw different noise, and on this
    # symmetric ring the noise decides which optimal coloring is found
    want = jax_solve(
        RING, "maxsum", {"damping": 0.5, "noise": 0.0}, rounds=30
    )
    proc = subprocess.run(
        [sys.executable, "-m", "pydcop_tpu_torch", "solve", "-a", "maxsum",
         "-p", "damping:0.5", "-p", "noise:0", "--rounds", "30",
         "--device", "cpu", RING],
        capture_output=True, text=True, cwd=REPO, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout)
    assert got["cost"] == want["cost"]
    assert got["assignment"] == want["assignment"]
    assert got["cycle"] == want["cycle"] == 30
    assert got["msg_count"] == want["msg_count"]
    assert set(got) == set(want) - {"cost_trace"}


def test_bf16_tables_generic_path_matches_jax_round_by_round(
    jax_gather_lowering,
):
    """bf16 tables (so bf16 unary, noise and messages) on a binary +
    ternary instance, which the factor kernels do not take: 30 rounds per
    damping, q, r and values bit-equal to the JAX step every round."""
    from pydcop_tpu.algorithms import maxsum as jms

    from pydcop_tpu_torch.algorithms import maxsum as tms

    scopes, tables, d, unary = _instance("ternary", n=200)
    ref = jcompile.compile_from_arrays(
        scopes, tables, d, unary=unary, table_dtype="bf16"
    )
    port = tcompile.compile_from_arrays(
        scopes, tables, d, unary=unary, table_dtype="bf16", device="cpu"
    )
    assert port.unary.dtype == torch.bfloat16
    jp = jax_params({}, jax_algo("maxsum").algo_params)
    jstep = jax.jit(
        lambda s, k, damping: jms.step(ref, s, k, {**jp, "damping": damping})
    )
    for damping in (0.3, 0.5, 0.7):
        tp = prepare_algo_params({"damping": damping}, tms.algo_params)
        ts = tms.init_state(port, 3, tp)
        js = {
            k: jnp.asarray(_np(v)).astype(
                jnp.bfloat16 if v.dtype == torch.bfloat16 else _np(v).dtype
            )
            for k, v in ts.items()
        }
        for i in range(30):
            js = jstep(js, jax.random.PRNGKey(i), damping)
            ts = tms.step(port, ts, tp)
            for k in ("q", "r", "values"):
                np.testing.assert_array_equal(
                    _np(ts[k]), _np(js[k]), err_msg=f"{k} d{damping} r{i}"
                )


def test_blockdiag_index_and_step_match_jax():
    """``_blockdiag_index`` is the JAX package's bit for bit; the
    belief and one step agree within 1e-6 (the one-hot products add in
    another order than JAX's einsum; ROADMAP.md, C)."""
    from pydcop_tpu.algorithms import maxsum as jms

    from pydcop_tpu_torch.algorithms import maxsum as tms

    ref, port = _problems("per_table", n=300)
    pj, oj = jms._blockdiag_index(ref)
    pt, ot = tms._blockdiag_index(port)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    st = _state(ref, "f32", random_q=True)
    params = {"damping": 0.5, "belief": "blockdiag"}
    jp = jax_params(params, jax_algo("maxsum").algo_params)
    tp = prepare_algo_params(params, tms.algo_params)
    js = {k: jnp.asarray(v) for k, v in st.items()}
    js["bd_perm"], js["bd_onehot"] = pj, oj
    ts = interop.state_from_arrays(st, "cpu")
    ts["bd_perm"], ts["bd_onehot"] = pt, ot
    out_j = jms.step(ref, js, jax.random.PRNGKey(0), jp)
    out_t = tms.step(port, ts, tp)
    np.testing.assert_array_equal(_np(out_t["r"]), _np(out_j["r"]))
    np.testing.assert_allclose(
        _np(out_t["q"]), _np(out_j["q"]), rtol=1e-6, atol=1e-6
    )
    np.testing.assert_array_equal(_np(out_t["values"]), _np(out_j["values"]))
    unary_t = np.asarray(ref.unary).T + st["noise"]
    b_j = jms.belief_from_r(ref, out_j["r"], jnp.asarray(unary_t),
                            mode="blockdiag")
    b_t = tms.belief_from_r(port, out_t["r"], torch.from_numpy(unary_t),
                            mode="blockdiag")
    np.testing.assert_allclose(_np(b_t), _np(b_j), rtol=1e-6, atol=1e-6)


def test_blockdiag_run_matches_jax_and_skips_checkpoint(tmp_path):
    """32 rounds from a shared state: the JAX run's best assignment, best
    cost within 1e-6; a checkpoint leaves the index out, and a run
    resumed from it rebuilds the index and ends as the whole run."""
    from pydcop_tpu.algorithms import maxsum as jms

    ref, port = _problems("shared", n=300)
    st = _state(ref, "f32")
    params = {"damping": 0.5, "belief": "blockdiag"}
    kw = dict(rounds=32, chunk_size=16, cost_every=8)
    pj, oj = jms._blockdiag_index(ref)
    rj = jax_run(
        ref, jax_algo("maxsum"),
        jax_params(params, jax_algo("maxsum").algo_params),
        initial_state=dict(st, bd_perm=np.asarray(pj),
                           bd_onehot=np.asarray(oj)), **kw,
    )
    mod = load_algorithm_module("maxsum")
    tp = prepare_algo_params(params, mod.algo_params)
    rt = run_batched(port, mod, tp, initial_state=st, return_state=True,
                     **kw)
    assert rt.best_assignment == rj.best_assignment
    assert rt.best_cost == pytest.approx(rj.best_cost, rel=1e-6)
    ck = str(tmp_path / "bd.npz")
    run_batched(port, mod, tp, rounds=16, chunk_size=16, cost_every=8,
                checkpoint_path=ck)
    with np.load(ck) as f:
        assert f.files and not any("bd_" in k for k in f.files)
    whole = run_batched(port, mod, tp, return_state=True, **kw)
    res = run_batched(port, mod, tp, checkpoint_path=ck, resume=True,
                      return_state=True, **kw)
    for k in ("q", "r", "values"):
        assert torch.equal(res.state[k], whole.state[k])


def test_blockdiag_rejects_a_stacked_group():
    ref, port = _problems("shared", n=100)
    mod = load_algorithm_module("maxsum")
    [grp] = tcompile.stack_problems([port, port])
    from pydcop_tpu_torch.engine.batched import run_many_batched

    with pytest.raises(ValueError, match="blockdiag"):
        run_many_batched(grp, mod, prepare_algo_params(
            {"belief": "blockdiag"}, mod.algo_params), rounds=2)
