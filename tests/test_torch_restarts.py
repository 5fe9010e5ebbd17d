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
    mod = load_algorithm_module(algo)
    params = prepare_algo_params({}, mod.algo_params)
    with pytest.raises(NotImplementedError, match="n_restarts"):
        run_batched(coloring, mod, params, rounds=1, n_restarts=2)
    with pytest.raises(NotImplementedError):
        solve_compiled(coloring, algo, rounds=1, n_restarts=2)
    r = run_batched(coloring, mod, params, rounds=2)
    assert r.restart_costs is None
