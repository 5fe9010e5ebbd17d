"""The port's solver service (``pydcop_tpu_torch/engine/service.py``):
coalesced dispatch against the port's own solves, the stochastic
lowering, admission and shedding, sessions, checkpoint/resume and
standby promotion, and the ``service.*`` counters against the JAX
package's service on the same traffic.

Timing discipline (the JAX package's ``tests/test_service.py``): a
deterministic tick uses ``max_batch`` equal to the number of requests
submitted with a long ``max_wait``, or a service built with
``autostart=False`` and started once the queue holds the whole tick.
Every wait has a timeout.
"""

import os

import pytest

torch = pytest.importorskip("torch")

from pydcop_tpu.engine import service as jservice  # noqa: E402
from pydcop_tpu.telemetry import session as jsession  # noqa: E402

from pydcop_tpu_torch import api  # noqa: E402
from pydcop_tpu_torch import telemetry as ttel  # noqa: E402
from pydcop_tpu_torch.dcop.yamldcop import load_dcop  # noqa: E402
from pydcop_tpu_torch.engine import service as tservice  # noqa: E402

CPU = "cpu"
WAIT = 60  # seconds: every result() in this file is bounded
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RING = open(os.path.join(REPO, "examples", "graph_coloring_3.yaml")).read()
# the JAX package's fleet/service session workload
SENSOR_YAML = """name: ext
objective: min
domains:
  colors: {values: [0, 1, 2]}
variables:
  v0: {domain: colors}
  v1: {domain: colors}
  v2: {domain: colors}
external_variables:
  sensor: {domain: colors, initial_value: 0}
constraints:
  c0: {type: intention, function: '1 if v0 == v1 else 0'}
  c1: {type: intention, function: '1 if v1 == v2 else 0'}
  track: {type: intention, function: '0 if v0 == sensor else 1'}
agents: [a1]
"""
SERVICE_KEYS = ("time", "util_time", "phases", "queue_wait",
                "instances_batched", "trace", "telemetry")


@pytest.fixture(autouse=True)
def no_session_left():
    assert ttel._active is None
    yield
    assert ttel._active is None


def svc(**kw):
    kw.setdefault("max_wait", 5.0)
    return tservice.SolverService(device=CPU, **kw)


def solve(service, *args, **kwargs):
    """``service.solve`` with a bounded wait."""
    return service.submit(*args, **kwargs).result(WAIT)


def strip(r):
    return {k: v for k, v in r.items() if k not in SERVICE_KEYS}


def ring_dcop(n, seed):
    """A soft random graph coloring (the port's generator)."""
    from argparse import Namespace

    from pydcop_tpu_torch.commands.generators import graphcoloring

    return graphcoloring.generate(Namespace(
        graph="random", variables_count=n, colors_count=3, p_edge=0.3,
        m_edge=2, soft=True, noise=0.0, intentional=False, seed=seed,
        agents_count=None, capacity=100.0,
    ))


@pytest.mark.parametrize("algo,params,rounds", [
    ("maxsum", {"damping": 0.5}, 48),
    ("mgm", {}, 32),
    ("dpop", {"util_device": "always"}, 0),
])
def test_coalesced_results_equal_solo_solves(algo, params, rounds):
    # three objects of one shape: one group, three compiles
    dcops = [ring_dcop(12, 1) for _ in range(3)]
    with svc(max_batch=3) as s:
        pend = [
            s.submit(d, algo, params, rounds=rounds or 200, seed=i)
            for i, d in enumerate(dcops)
        ]
        got = [p.result(WAIT) for p in pend]
    for i, (d, r) in enumerate(zip(dcops, got)):
        solo = api.solve(d, algo, params, rounds=rounds or 200, seed=i,
                         pad_policy="pow2", device=CPU)
        assert strip(r) == strip(solo)
        assert r["instances_batched"] == 3


def test_stochastic_tick_equals_solve_many_of_its_padded_group():
    """ROADMAP C, 'Coalesced stochastic requests': a DSA tick of three
    equals ``solve_many`` over the same members, the last repeated to
    the pow-2 count of four."""
    dcops = [ring_dcop(12, 4) for _ in range(3)]
    params = {"variant": "B"}
    with ttel.session() as tel, svc(max_batch=3) as s:
        got = [
            p.result(WAIT) for p in [
                s.submit(d, "dsa", params, rounds=40, seed=10 + i)
                for i, d in enumerate(dcops)
            ]
        ]
    assert tel.metrics.snapshot()["counters"]["service.pad_instances"] == 1
    want = api.solve_many(
        dcops + [dcops[-1]], "dsa", params, rounds=40,
        seed=[10, 11, 12, 12], pad_policy="pow2", device=CPU,
    )
    for r, w in zip(got, want):
        assert strip(r) == strip(w)


def test_tick_policy_shedding_and_validation():
    with pytest.raises(ValueError, match="max_batch"):
        tservice.TickPolicy(max_batch=0)
    with pytest.raises(ValueError, match="instance_bucket"):
        svc(instance_bucket="pow3")
    with pytest.raises(ValueError, match="fleet-level chaos"):
        svc(chaos="replica_kill=1:0")
    s = svc(max_batch=2, max_queue=2, autostart=False)
    try:
        ok = [s.submit(RING, "maxsum", {}, rounds=8) for _ in range(2)]
        shed = s.submit(RING, "maxsum", {}, rounds=8).result(0)
        assert shed["status"] == "shed"
        assert shed["shed_reason"] == "queue-full"
        # the deadline shed needs a tick-duration estimate
        s.max_queue = 8
        s._tick_med = 10.0
        late = s.submit(RING, "maxsum", {}, rounds=8, timeout=1.0)
        assert late.result(0)["shed_reason"] == "deadline"
        with pytest.raises(ValueError, match="set_values"):
            s.submit(RING, "maxsum", set_values={"x": 1})
        s.start()
        assert all(p.result(WAIT)["status"] == "finished" for p in ok)
        h = s.health()
        assert h["status"] == "ok" and h["shed"] == 2
    finally:
        s.close()
    assert s.health()["status"] == "drained"
    with pytest.raises(tservice.ServiceError, match="closed"):
        s.submit(RING, "maxsum")


def _traffic(mod, sess_ctx, **kw):
    """One fixed traffic mix through package ``mod``'s service: a
    coalesced Max-Sum tick, a DPOP pair, an infer, a session with a
    follow-up, a queue-full shed and a bad request."""
    with sess_ctx() as tel:
        s = mod.SolverService(max_batch=4, max_wait=0.05, max_queue=6,
                              autostart=False, **kw)
        try:
            pend = [s.submit(RING, "maxsum", {"damping": 0.5}, rounds=16,
                             seed=i) for i in range(3)]
            pend.append(s.submit_infer(RING, "log_z"))
            pend += [s.submit(RING, "dpop", {}) for _ in range(2)]
            shed = s.submit(RING, "maxsum", {}, rounds=16)
            s.start()
            res = [p.result(WAIT) for p in pend] + [shed.result(WAIT)]
            a = solve(s, SENSOR_YAML, "maxsum", {}, rounds=16,
                        session="plant")
            b = solve(s, None, "maxsum", {}, rounds=16, session="plant",
                        set_values={"sensor": 2})
            res += [a, b]
            with pytest.raises(ValueError):  # refused at admission
                solve(s, RING, "nosuchalgo", {}, rounds=4)
        finally:
            s.close()
        stats, health = s.stats(), s.health()
    counters = {
        k: v for k, v in tel.metrics.snapshot()["counters"].items()
        if k.startswith(("service.", "compile.", "telemetry."))
    }
    return res, stats, health, counters


def test_stats_health_and_counters_equal_jax_on_the_same_traffic():
    jres, jstats, jhealth, jc = _traffic(jservice, jsession)
    tres, tstats, thealth, tc = _traffic(tservice, ttel.session, device=CPU)
    assert tc == jc
    assert set(tstats) == set(jstats)
    timing = ("coalesce_ratio", "queue_wait_s", "latency_s",
              "batch_occupancy", "shed_latency_s")
    assert ({k: v for k, v in tstats.items() if k not in timing}
            == {k: v for k, v in jstats.items() if k not in timing})
    assert thealth == jhealth
    # [maxsum x3, log_z, dpop x2, shed, session a, session b]
    assert [t["status"] for t in tres] == [j["status"] for j in jres]
    for j, t in zip(jres, tres):
        for k in ("shed_reason", "queue_depth", "session", "segment",
                  "instances_batched"):
            assert t.get(k) == j.get(k), k
        assert set(t.get("phases", {})) == set(j.get("phases", {}))
        assert set(t) == set(j) - {"telemetry"}
    assert tres[3]["log_z"] == pytest.approx(jres[3]["log_z"], rel=1e-6)
    for i in (4, 5):  # DPOP: exact on both sides
        assert tres[i]["assignment"] == jres[i]["assignment"]
        assert tres[i]["cost"] == jres[i]["cost"]


def _sensor(value):
    d = load_dcop(SENSOR_YAML)
    d.external_variables["sensor"].value = value
    return d


def test_session_follow_ups_checkpoint_resume(tmp_path):
    ck = str(tmp_path / "sessions.json")
    seq = [None, {"sensor": 1}, {"sensor": 2}, {"sensor": 1}]
    kw = dict(rounds=16, seed=3)
    with ttel.session() as tel:
        s = svc(max_batch=1, session_checkpoint=ck)
        outs = []
        for sv in seq[:3]:
            outs.append(solve(s, SENSOR_YAML if sv is None else None,
                                "maxsum", {}, session="plant",
                                set_values=sv, **kw))
        s.close()
    c = tel.metrics.snapshot()["counters"]
    assert c["compile.full"] == 1 and c["compile.incremental"] == 2
    for out, val in zip(outs, (0, 1, 2)):
        fresh = api.solve(_sensor(val), "maxsum", {}, pad_policy="pow2",
                          device=CPU, **kw)
        assert strip(out) == {**strip(fresh), "session": "plant",
                              "segment": out["segment"]}
    assert [o["segment"] for o in outs] == [1, 2, 3]
    with ttel.session() as tel:
        r = svc(max_batch=1, session_checkpoint=ck, resume=True)
        try:
            assert r.stats()["sessions_restored"] == 1
            nxt = solve(r, None, "maxsum", {}, session="plant",
                          set_values=seq[3], **kw)
        finally:
            r.close()
    c = tel.metrics.snapshot()["counters"]
    assert c["compile.full"] == 1  # the replay's segment 1, at startup
    assert nxt["segment"] == 4
    fresh = api.solve(_sensor(1), "maxsum", {}, pad_policy="pow2",
                      device=CPU, **kw)
    assert strip(nxt) == {**strip(fresh), "session": "plant",
                          "segment": 4}


def test_exact_session_memo_and_standby_promotion():
    standby = svc(max_batch=1)
    server = tservice.ServiceServer(standby)
    primary = svc(max_batch=1)
    try:
        primary.set_standbys(["%s:%d" % server.address])
        a = solve(primary, SENSOR_YAML, "dpop", {}, session="plant")
        primary.replicate_session("plant")
        b = solve(primary, None, "dpop", {}, session="plant",
                          set_values={"sensor": 2})
        primary.replicate_session("plant")
        assert b["memo"]["hits"] >= 1
        assert b["memo"]["hits"] + b["memo"]["recontracted"] == 3
        assert standby.stats()["standby_sessions"] == 1
        c = solve(standby, None, "dpop", {}, session="plant",
                          set_values={"sensor": 1})
        assert standby.stats()["sessions_promoted"] == 1
        assert c["segment"] == 3
        fresh = api.solve(_sensor(1), "dpop", {}, device=CPU)
        assert c["cost"] == fresh["cost"]
        assert c["assignment"] == fresh["assignment"]
        assert a["cost"] == api.solve(_sensor(0), "dpop", {},
                                      device=CPU)["cost"]
    finally:
        primary.close()
        server.close()
        standby.close()


def test_nan_inject_quarantines_only_the_named_request():
    dcops = [ring_dcop(12, 7) for _ in range(4)]
    with svc(max_batch=4, chaos="nan_inject=1:2") as s:
        got = [p.result(WAIT) for p in [
            s.submit(d, "maxsum", {"damping": 0.5}, rounds=32, seed=i)
            for i, d in enumerate(dcops)
        ]]
    statuses = [r["status"] for r in got]
    assert statuses.count("degraded") == 1
    for i, (d, r) in enumerate(zip(dcops, got)):
        if r["status"] == "degraded":
            continue
        solo = api.solve(d, "maxsum", {"damping": 0.5}, rounds=32, seed=i,
                         pad_policy="pow2", device=CPU)
        assert strip(r) == strip(solo)


def test_service_raises_without_cuda(monkeypatch):
    from pydcop_tpu_torch.cli import main
    from pydcop_tpu_torch.device import NoCudaDeviceError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDeviceError):
        tservice.SolverService()
    with pytest.raises(NoCudaDeviceError):
        main(["serve", "--port", "0"])
    with pytest.raises(SystemExit, match="compile_cache"):
        main(["serve", "--port", "0", "--compile_cache", "d",
              "--device", "cpu"])
    with pytest.raises(SystemExit, match="serve: .*fleet-level"):
        main(["serve", "--port", "0", "--device", "cpu",
              "--chaos", "replica_kill=1:0"])


def test_json_text_sessions_checkpoint_and_resume(tmp_path):
    """JSON text, YAML's subset and the form the card's smoke run
    submits, loads through PyYAML to the DCOP the YAML text gives; a
    session on it checkpoints its source verbatim and resumes, and the
    resumed follow-up equals the undisturbed service's."""
    import json

    doc = {
        "name": "ext", "objective": "min",
        "domains": {"colors": {"values": [0, 1, 2]}},
        "variables": {f"v{i}": {"domain": "colors"} for i in range(3)},
        "external_variables": {
            "sensor": {"domain": "colors", "initial_value": 0}},
        "constraints": {
            "c0": {"type": "intention", "function": "1 if v0 == v1 else 0"},
            "c1": {"type": "intention", "function": "1 if v1 == v2 else 0"},
            "track": {"type": "intention",
                      "function": "0 if v0 == sensor else 1"}},
        "agents": ["a1"],
    }
    text = json.dumps(doc, indent=1)
    ck = str(tmp_path / "sessions.json")
    kw = dict(rounds=16, seed=3, session="plant")
    with svc(max_batch=1, session_checkpoint=ck) as s:
        a = solve(s, text, "maxsum", {}, **kw)
        solve(s, None, "maxsum", {}, set_values={"sensor": 2}, **kw)
    r = svc(max_batch=1, session_checkpoint=ck, resume=True)
    try:
        b = solve(r, None, "maxsum", {}, set_values={"sensor": 1}, **kw)
    finally:
        r.close()
    with svc(max_batch=1) as s:
        solve(s, text, "maxsum", {}, **kw)
        solve(s, None, "maxsum", {}, set_values={"sensor": 2}, **kw)
        c = solve(s, None, "maxsum", {}, set_values={"sensor": 1}, **kw)
    assert b["segment"] == 3
    assert strip(b) == strip(c)
    want = api.solve(load_dcop(text), "maxsum", {}, rounds=16, seed=3,
                     pad_policy="pow2", device=CPU)
    assert strip(a) == {**strip(want), "session": "plant", "segment": 1}


def test_concurrent_submits_lose_no_request():
    """Stress: more client threads than cores admit at once under a
    shortened switch interval; every request is answered and counted."""
    import sys
    import threading

    n = 4 * (os.cpu_count() or 4)
    dcop = ring_dcop(12, 1)
    out = [None] * n
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with svc(max_batch=8, max_wait=0.01) as s:
            barrier = threading.Barrier(n)

            def client(i):
                barrier.wait(WAIT)
                out[i] = s.submit(dcop, "mgm", {}, rounds=4,
                                  seed=i).result(WAIT)

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(WAIT)
            assert not any(t.is_alive() for t in threads)
            stats = s.stats()
    finally:
        sys.setswitchinterval(old)
    assert all(r["status"] == "finished" for r in out)
    assert stats["requests"] == n
    assert sum(1 for r in out if r["instances_batched"] > 1) == (
        stats["coalesced_requests"])
