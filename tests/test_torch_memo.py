"""The port's memoized exact sessions (``pydcop_tpu_torch/engine/memo.py``)
against the JAX package's ``engine/memo.py``.

The same delta streams go through both packages' ``ExactSession`` and
``InferSession``: assignments, costs, the ``result["memo"]`` block and the
three ``engine.memo_*`` counters must be equal, a memoized follow-up must
equal the same session with the memo off bit for bit, and the bytes
bound must evict least-recently-used entries.
"""

import random
from argparse import Namespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import pydcop_tpu.dcop as jdcop  # noqa: E402
from pydcop_tpu.commands.generators import secp as jsecp  # noqa: E402
from pydcop_tpu.engine import memo as jmemo  # noqa: E402
from pydcop_tpu.telemetry import session as jsession  # noqa: E402

import pydcop_tpu_torch.dcop as tdcop  # noqa: E402
from pydcop_tpu_torch import telemetry as ttel  # noqa: E402
from pydcop_tpu_torch.commands.generators import secp as tsecp  # noqa: E402
from pydcop_tpu_torch.engine import memo as tmemo  # noqa: E402

CPU = "cpu"
MEMO_COUNTERS = (
    "engine.memo_hits", "engine.memo_recontractions",
    "engine.memo_evictions",
)
# a small zone-overlap SECP (the bnb tests' shape, cut down); the
# external "demand" drives one light, as a sensor would
SECP = dict(
    nb_lights=10, nb_models=6, nb_rules=4, light_levels=4,
    model_arity=3, zone_size=6, zone_layout="overlap", zone_overlap=3,
    efficiency_weight=0.1, capacity=100.0, seed=3, hard_cap=1.1,
)


@pytest.fixture(autouse=True)
def no_session_left():
    assert ttel._active is None
    yield
    assert ttel._active is None


def delta_tree(m, n_hubs=3, n_leaves=6, seed=77):
    """``tools/recompile_guard.py:_build_delta_tree`` with the model
    objects of package ``m``: a chain of hubs, each with leaves, and one
    external-driven tracking constraint on the last leaf."""
    rnd = random.Random(seed)
    dcop = m.DCOP(f"delta_tree_{n_hubs}x{n_leaves}_{seed}")
    dom = m.Domain("b", "", [0, 1])
    ext = m.ExternalVariable("e0", dom, value=0)
    dcop.add_variable(ext)

    def m22():
        return np.array(
            [[rnd.uniform(0.0, 1.0) for _ in range(2)] for _ in range(2)]
        )

    prev = track = None
    for h in range(n_hubs):
        hv = m.Variable(f"h{h}", dom)
        dcop.add_variable(hv)
        if prev is not None:
            dcop.add_constraint(
                m.NAryMatrixRelation([prev, hv], m22(), name=f"ch{h}")
            )
        for leaf in range(n_leaves):
            lv = m.Variable(f"x{h}_{leaf}", dom)
            dcop.add_variable(lv)
            dcop.add_constraint(
                m.NAryMatrixRelation([hv, lv], m22(), name=f"c{h}_{leaf}")
            )
            track = lv
        prev = hv
    dcop.add_constraint(
        m.NAryMatrixRelation([track, ext], m22(), name="track")
    )
    dcop.add_agents([m.AgentDef("a0")])
    return dcop


def secp_with_demand(m, gen_module):
    dcop = gen_module.generate(Namespace(**SECP))
    light = dcop.variables["l0000"]
    demand = m.ExternalVariable("demand", light.domain, value=0)
    dcop.add_variable(demand)
    dcop.add_constraint(
        m.constraint_from_str(
            "track", "abs(l0000 - demand) * 3", [light, demand]
        )
    )
    return dcop


PROBLEMS = {
    "delta_tree": (
        lambda: delta_tree(jdcop), lambda: delta_tree(tdcop), "e0", [0, 1],
    ),
    "secp": (
        lambda: secp_with_demand(jdcop, jsecp),
        lambda: secp_with_demand(tdcop, tsecp), "demand", [1, 3, 0, 3],
    ),
}


def _counters(tel):
    c = tel.metrics.snapshot()["counters"]
    return {k: c.get(k, 0) for k in MEMO_COUNTERS}


def _stream(session_ctx, es, ext, values, params):
    out = []
    for v in values:
        with session_ctx() as tel:
            es.set_values({ext: v})
            r = es.solve(params)
        out.append((r, _counters(tel)))
    return out


@pytest.mark.parametrize("bnb", ["off", "on"])
@pytest.mark.parametrize("problem", ["delta_tree", "secp"])
def test_exact_session_equals_jax(problem, bnb):
    jb, tb, ext, values = PROBLEMS[problem]
    params = {"util_device": "always", "bnb": bnb}
    want = _stream(
        jsession, jmemo.ExactSession(jb(), pad_policy="pow2"), ext,
        values, params,
    )
    got = _stream(
        ttel.session,
        tmemo.ExactSession(tb(), pad_policy="pow2", device=CPU), ext,
        values, params,
    )
    for (w, wc), (g, gc) in zip(want, got):
        for k in ("assignment", "cost", "memo", "util_cells",
                  "util_device_nodes", "util_host_nodes",
                  "util_dispatches"):
            assert g[k] == w[k], k
        assert gc == wc
    # every follow-up re-contracts only the dirty path
    assert all(g["memo"]["hits"] > 0 for g, _ in got[1:])


@pytest.mark.parametrize("problem", ["delta_tree", "secp"])
def test_memo_on_equals_memo_off(problem):
    _, tb, ext, values = PROBLEMS[problem]
    on = tmemo.ExactSession(tb(), pad_policy="pow2", device=CPU)
    off = tmemo.ExactSession(tb(), pad_policy="pow2", device=CPU,
                             memo_bytes=0)
    params = {"util_device": "always"}
    for v in values:
        on.set_values({ext: v})
        off.set_values({ext: v})
        a, b = on.solve(params), off.solve(params)
        assert b["memo"]["hits"] == 0
        # the answer keys; the util_* counts and msg_size meter the
        # work done, which the memo cuts
        for k in ("assignment", "cost", "final_assignment", "final_cost",
                  "cycle", "msg_count", "status", "cost_trace"):
            assert a[k] == b[k], k


@pytest.mark.parametrize("query", ["map", "kbest:3", "log_z", "marginals"])
def test_infer_session_equals_jax(query):
    jd, td = delta_tree(jdcop), delta_tree(tdcop)
    js = jmemo.InferSession(jd, query, device="always", pad_policy="pow2")
    ts = tmemo.InferSession(td, query, device="always", pad_policy="pow2",
                            torch_device=CPU)
    for v in (1, 0, 1):
        js.set_values({"e0": v})
        ts.set_values({"e0": v})
        a, b = js.solve(), ts.solve()
        assert b["memo"] == a["memo"]
        for k in ("assignment", "cost", "costs", "solutions"):
            if k in a:
                assert b[k] == a[k], k
        if "log_z" in a:
            assert b["log_z"] == pytest.approx(a["log_z"], rel=1e-6)
        for var, p in (a.get("marginals") or {}).items():
            np.testing.assert_allclose(b["marginals"][var], p, rtol=1e-6)


def test_sweep_memo_byte_bound_evicts_lru():
    entry = np.zeros(16)  # 128 bytes
    nb = tmemo._nbytes((entry,))
    memo = tmemo.SweepMemo(max_bytes=3 * nb)
    view = memo.begin({f"n{i}": (i,) for i in range(5)})
    with ttel.session() as tel:
        for i in range(4):
            view.store(f"n{i}", (entry,))
        assert view.lookup("n0") is None  # the oldest went first
        assert view.lookup("n1") is not None  # a hit refreshes n1
        view.store("n4", (entry,))
        assert view.lookup("n2") is None  # so n2 was the next LRU
        assert view.lookup("n1") is not None
        view.store("big", (np.zeros(1024),))  # oversized: not stored
    assert memo.evictions == 2 and memo._bytes == 3 * nb
    assert tel.metrics.snapshot()["counters"]["engine.memo_evictions"] == 2
    assert tmemo.SweepMemo(0).begin({"n": ()}) is None


def test_prewarm_is_a_counted_no_op():
    """ROADMAP C, 'Memo prewarm': the port compiles nothing ahead of a
    dispatch, so the pre-warm runs no kernel and counts 0."""
    es = tmemo.ExactSession(delta_tree(tdcop), pad_policy="pow2",
                            device=CPU)
    es.solve({"util_device": "always"})
    assert es.memo.prewarm() == 0
    assert es.memo.prewarm(heights=(1, 2)) == 0


def test_exact_session_rejects_unknown_external_and_keeps_caller_dcop():
    d = delta_tree(tdcop)
    es = tmemo.ExactSession(d, device=CPU)
    with pytest.raises(ValueError, match="not an external"):
        es.set_values({"h0": 1})
    es.set_values({"e0": 1})
    assert d.external_variables["e0"].value == 0
