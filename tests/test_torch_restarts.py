"""Parallel restarts on the port's batched engine (``n_restarts > 1``).

The restart axis is a leading ``[K]`` axis on the state: a K-restart run
must equal K single-restart ``apply`` sequences fed the same slices of
the engine's draws, report the best over its restarts, and return the
JAX package's result keys (``restart_costs`` included).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from pydcop_tpu_torch.algorithms import load_algorithm_module  # noqa: E402
from pydcop_tpu_torch.algorithms import prepare_algo_params  # noqa: E402
from pydcop_tpu_torch.api import _result_dict, solve_compiled  # noqa: E402
from pydcop_tpu_torch.engine.batched import (  # noqa: E402
    round_generator,
    run_batched,
)
from pydcop_tpu_torch.ops import compile as tcompile  # noqa: E402
from pydcop_tpu_torch.ops.generate import (  # noqa: E402
    coloring_arrays,
    ising_arrays,
)

K = 4


@pytest.fixture(scope="module")
def coloring():
    s, t, u = coloring_arrays(150, seed=2)
    return tcompile.compile_from_arrays(s, t, 3, unary=u, device="cpu")


@pytest.mark.parametrize("algo", ["dsa", "mgm2"])
def test_restarts_equal_single_runs_on_sliced_draws(algo, coloring):
    port = coloring
    mod = load_algorithm_module(algo)
    params = prepare_algo_params({}, mod.algo_params)
    r = run_batched(port, mod, params, rounds=12, seed=4, n_restarts=K,
                    cost_every=4, return_state=True)

    stacked = mod.init_state(port, 4, params, (K,))
    gen = round_generator(4, port.device)
    static = {k: v for k, v in stacked.items() if k != "values"}
    singles = [{**static, "values": stacked["values"][k]} for k in range(K)]
    for _ in range(12):
        drawn = mod.draws(port, params, gen, (K,))
        singles = [
            mod.apply(port, s, params, {n: v[k] for n, v in drawn.items()})
            for k, s in enumerate(singles)
        ]
    want = torch.stack([s["values"] for s in singles])
    assert torch.equal(r.state["values"], want)
    # the static pair index is shared, not stacked
    for key, v in static.items():
        assert torch.equal(r.state[key], v)

    assert r.restart_costs.shape == (K,)
    assert r.best_cost == pytest.approx(float(r.restart_costs.min()))
    assert r.messages == mod.messages_per_round(port, params) * 12 * K
    assert len(r.cost_trace) == 3
    assert r.cost_trace.min() >= r.best_cost - 1e-4
    assert len(set(r.restart_costs.tolist())) > 1  # restarts differ


def test_result_keys_equal_jax_result_dict(coloring):
    """``api._result_dict`` of the port gives the keys, and the values,
    that the JAX package's ``_result_dict`` gives for the same run."""
    from pydcop_tpu.api import _result_dict as jax_result_dict
    from pydcop_tpu.engine.batched import RunResult as JaxRunResult

    mod = load_algorithm_module("dsa")
    params = prepare_algo_params({}, mod.algo_params)
    for k in (1, K):
        r = run_batched(coloring, mod, params, rounds=8, n_restarts=k)
        fields = {f.name: getattr(r, f.name)
                  for f in dataclasses.fields(JaxRunResult)}
        want = jax_result_dict(JaxRunResult(**fields))
        got = _result_dict(r)
        assert got == want
        assert ("restart_costs" in got) == (k > 1)
    got = solve_compiled(coloring, "dsa", rounds=8, n_restarts=K)
    assert len(got["restart_costs"]) == K
    assert got["cost"] == min(got["restart_costs"])


def test_restart_state_carries_and_is_validated():
    s, t, u = ising_arrays(6, 6, seed=1)
    port = tcompile.compile_from_arrays(s, t, 2, unary=u, device="cpu")
    mod = load_algorithm_module("gdba")
    params = prepare_algo_params({}, mod.algo_params)
    r = run_batched(port, mod, params, rounds=6, n_restarts=3,
                    return_state=True)
    assert r.state["values"].shape == (3, port.n_vars)
    assert r.state["w2"].shape == (3, port.buckets[2].n_cons, 4)
    # GDBA draws nothing: continuing from the returned state equals one
    # longer run
    r2 = run_batched(port, mod, params, rounds=6, n_restarts=3,
                     initial_state=r.state, return_state=True)
    r12 = run_batched(port, mod, params, rounds=12, n_restarts=3,
                      return_state=True)
    for k in r12.state:
        assert torch.equal(r2.state[k], r12.state[k])
    with pytest.raises(ValueError, match="n_restarts=2"):
        run_batched(port, mod, params, rounds=1, n_restarts=2,
                    initial_state=r.state)
    with pytest.raises(ValueError, match="n_restarts"):
        run_batched(port, mod, params, rounds=1, n_restarts=0)


@pytest.mark.parametrize("algo", ["maxsum", "amaxsum"])
def test_message_passing_restarts_not_ported(algo, coloring):
    """Max-Sum and A-Max-Sum restarts (ported: the kernels take the
    restart axis): K restarts equal K single-restart runs of ``apply``
    on the slices of the stacked initial state and of the engine's
    draws, bit for bit, and the result reports the best of them."""
    port = coloring
    mod = load_algorithm_module(algo)
    params = prepare_algo_params({"noise": 0.01}, mod.algo_params)
    r = run_batched(port, mod, params, rounds=8, seed=4, n_restarts=K,
                    cost_every=4, return_state=True)
    stacked = mod.init_state(port, 4, params, (K,))
    gen = round_generator(4, port.device)
    singles = [{k: v[i] for k, v in stacked.items()} for i in range(K)]
    for _ in range(8):
        if algo == "amaxsum":
            drawn = mod.draws(port, params, gen, (K,))
            singles = [
                mod.apply(port, s, params, {n: v[i] for n, v in drawn.items()})
                for i, s in enumerate(singles)
            ]
        else:
            singles = [mod.step(port, s, params) for s in singles]
    for key in ("q", "r", "values"):
        assert torch.equal(
            r.state[key], torch.stack([s[key] for s in singles])
        ), key
    assert len(r.restart_costs) == K
    assert r.best_cost == min(r.restart_costs)
    res = solve_compiled(coloring, algo, {"noise": 0.01}, rounds=4,
                         n_restarts=2, seed=1)
    assert len(res["restart_costs"]) == 2
    assert res["msg_count"] == 2 * 4 * mod.messages_per_round(
        coloring, params
    )


def test_maxsum_restarts_equal_jax_run_batched():
    """Max-Sum with 3 restarts from one shared numpy state (per-restart
    noise) equals the JAX engine's ``run_batched(n_restarts=3)``: q, r
    and values bit for bit after 16 rounds, the same best assignment,
    restart costs within 1e-6 (an f32 sum taken in another order).  The
    JAX engine runs with its per-slot gather belief (ROADMAP queue C,
    'Belief summation')."""
    import numpy as np
    from pydcop_tpu.algorithms import load_algorithm_module as jalgo
    from pydcop_tpu.algorithms import prepare_algo_params as jparams
    from pydcop_tpu.engine import batched as jbatched
    from pydcop_tpu.ops import compile as jcompile
    from pydcop_tpu.ops import costs as jcosts

    s, t, u = coloring_arrays(120, seed=5)
    ref = jcompile.compile_from_arrays(s, t, 3, unary=u)
    port = tcompile.compile_from_arrays(s, t, 3, unary=u, device="cpu")
    rng = np.random.default_rng(2)
    d, e, n = ref.d_max, ref.n_edges, ref.n_vars
    st = {
        "q": rng.random((3, d, e), dtype=np.float32),
        "r": np.zeros((3, d, e), np.float32),
        "values": np.zeros((3, n), np.int32),
        "noise": (0.01 * rng.random((3, d, n))).astype(np.float32),
    }
    kw = dict(rounds=16, chunk_size=8, cost_every=4, n_restarts=3,
              initial_state=st, return_state=True)
    saved = jcosts.CPU_SEGMENT_MIN_EDGES
    jcosts.CPU_SEGMENT_MIN_EDGES = 1 << 62
    jbatched._RUNNER_CACHE.clear()
    try:
        rj = jbatched.run_batched(
            ref, jalgo("maxsum"),
            jparams({"damping": 0.5}, jalgo("maxsum").algo_params), **kw,
        )
    finally:
        jcosts.CPU_SEGMENT_MIN_EDGES = saved
        jbatched._RUNNER_CACHE.clear()
    mod = load_algorithm_module("maxsum")
    rt = run_batched(
        port, mod, prepare_algo_params({"damping": 0.5}, mod.algo_params),
        **kw,
    )
    for key in ("q", "r", "values"):
        np.testing.assert_array_equal(
            rt.state[key].numpy(), np.asarray(rj.state[key]), err_msg=key
        )
    assert rt.best_assignment == rj.best_assignment
    np.testing.assert_allclose(rt.restart_costs, rj.restart_costs,
                               rtol=1e-6)
