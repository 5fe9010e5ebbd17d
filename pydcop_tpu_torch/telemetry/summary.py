"""Trace readers + aggregation behind ``pydcop_tpu_torch trace-summary``
(a copy of ``pydcop_tpu/telemetry/summary.py``: the same records give
the same aggregates and the same text).

Both trace formats (JSONL and Chrome ``trace_event``) normalize back to
the JSONL record schema (``tracer.py``); aggregation is format-blind.
The service sections (queue wait, occupancy, request timelines) read the
records the JAX package's solver service writes; the port's tracer does
not emit the JAX package's ``jit.*`` names, so a summary of a port trace
has no jit section.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List


def load_trace(path: str) -> List[Dict[str, Any]]:
    """Read a trace file in either format into normalized records."""
    with open(path, encoding="utf-8") as f:
        text = f.read()
    stripped = text.lstrip()
    if not stripped:
        raise ValueError(f"{path}: empty trace file")
    if stripped.startswith("{") and '"traceEvents"' in stripped[:2000]:
        return _from_chrome(json.loads(stripped), path)
    records = []
    for i, line in enumerate(text.splitlines()):
        line = line.strip()
        if not line:
            continue
        try:
            records.append(json.loads(line))
        except ValueError as e:
            raise ValueError(f"{path}:{i + 1}: not a JSONL trace: {e}")
    return records


def _from_chrome(doc: Dict[str, Any], path: str) -> List[Dict[str, Any]]:
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError(f"{path}: no traceEvents array")
    records: List[Dict[str, Any]] = []
    meta = doc.get("metadata")
    if isinstance(meta, dict):
        records.append(meta)
    for e in events:
        ph = e.get("ph")
        if ph == "X":
            records.append(
                {
                    "kind": "span",
                    "name": e.get("name", "?"),
                    "cat": e.get("cat", ""),
                    "t": e.get("ts", 0.0) / 1e6,
                    "dur": e.get("dur", 0.0) / 1e6,
                    "tid": e.get("tid", 0),
                    "args": e.get("args", {}),
                }
            )
        elif ph == "i":
            if e.get("cat") == "metrics":
                records.append({"kind": "metrics", **e.get("args", {})})
            else:
                records.append(
                    {
                        "kind": "event",
                        "name": e.get("name", "?"),
                        "cat": e.get("cat", ""),
                        "t": e.get("ts", 0.0) / 1e6,
                        "tid": e.get("tid", 0),
                        "args": e.get("args", {}),
                    }
                )
    return records


def _percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile of an unsorted sample (0 <= q <= 100)."""
    if not values:
        return 0.0
    s = sorted(values)
    idx = min(len(s) - 1, max(0, int(round(q / 100.0 * (len(s) - 1)))))
    return float(s[idx])


def percentiles_from_histogram(
    bounds, counts, qs=(50, 90, 99)
) -> Dict[str, float]:
    """Percentiles of a fixed-bucket histogram, at bucket resolution.

    Shares :func:`_percentile`'s nearest-rank convention (the rank of
    the q-th percentile over n samples is ``round(q/100 * (n-1))``)
    but walks cumulative bucket counts instead of a sorted sample, so
    ``result["telemetry"]["histograms"]`` and the serving report agree
    on what a percentile means.  The reported value is the UPPER BOUND
    of the bucket holding the rank (the overflow bucket reports the
    largest finite bound — a lower-bound estimate, flagged by the
    bucket counts themselves)."""
    out: Dict[str, float] = {}
    n = sum(counts)
    for q in qs:
        key = f"p{int(q)}"
        if n <= 0 or not bounds:
            out[key] = 0.0
            continue
        rank = min(n - 1, max(0, int(round(q / 100.0 * (n - 1)))))
        cum = 0
        val = float(bounds[-1])
        for i, c in enumerate(counts):
            cum += c
            if cum > rank:
                val = float(bounds[min(i, len(bounds) - 1)])
                break
        out[key] = val
    return out


def _service_summary(
    waits: List[float], lats: List[float], occs: List[float]
) -> Dict[str, Any]:
    """Serving aggregates from the solver service's spans
    (``engine/service.py``, ``docs/serving.md``): queue-wait /
    request-latency / batch-occupancy percentiles plus the coalesce
    ratio (requests per dispatch) — the numbers that say whether the
    tick policy is batching without blowing the latency SLO."""
    out: Dict[str, Any] = {
        "requests": len(lats),
        "dispatches": len(occs),
    }
    if occs:
        out["coalesce_ratio"] = round(sum(occs) / len(occs), 3)
    for label, values in (
        ("queue_wait_s", waits),
        ("latency_s", lats),
        ("batch_occupancy", occs),
    ):
        if values:
            out[label] = {
                "p50": _percentile(values, 50),
                "p90": _percentile(values, 90),
                "p99": _percentile(values, 99),
                "max": max(values),
            }
    return out


def summarize(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Aggregate a trace: per-phase span totals, per-category event
    counts, per-agent message/fault activity, the embedded metrics
    snapshot (when the session wrote one), and — for traces from a
    solver service (``pydcop_tpu serve``) — queue-wait / occupancy /
    latency percentiles under ``service``."""
    phases: Dict[str, Dict[str, float]] = {}
    events: Dict[str, int] = {}
    agents: Dict[str, Dict[str, int]] = {}
    faults: Dict[str, int] = {}
    metrics: Dict[str, Any] = {}
    meta: Dict[str, Any] = {}
    svc_waits: List[float] = []
    svc_lats: List[float] = []
    svc_occs: List[float] = []
    # semiring contraction sweeps (ops/semiring.py, docs/semirings.md)
    # aggregate per ⊕: sweep spans carry the semiring name and cell
    # counts, so the report can say cells/sec per semiring
    semirings: Dict[str, Dict[str, Any]] = {}
    for r in records:
        kind = r.get("kind")
        if kind == "meta":
            meta = {k: v for k, v in r.items() if k != "kind"}
        elif kind == "metrics":
            metrics = {k: v for k, v in r.items() if k != "kind"}
        elif kind == "span":
            name = r.get("name", "?")
            s = phases.setdefault(
                name,
                {"count": 0, "total_s": 0.0, "max_s": 0.0},
            )
            dur = float(r.get("dur", 0.0))
            s["count"] += 1
            s["total_s"] += dur
            s["max_s"] = max(s["max_s"], dur)
            if name == "service.queue-wait":
                svc_waits.append(dur)
            elif name == "service.request":
                svc_lats.append(dur)
            elif name == "service.dispatch":
                occ = (r.get("args") or {}).get("instances")
                if occ is not None:
                    svc_occs.append(float(occ))
            elif name.startswith("semiring."):
                args = r.get("args") or {}
                rec = semirings.setdefault(
                    str(args.get("semiring", "?")),
                    {"sweeps": 0, "total_s": 0.0, "cells": 0},
                )
                rec["sweeps"] += 1
                rec["total_s"] += dur
                cells = args.get("cells")
                if cells:
                    rec["cells"] += int(cells)
        elif kind == "event":
            name = r.get("name", "?")
            events[name] = events.get(name, 0) + 1
            args = r.get("args") or {}
            # chaos-plan announces the spec/seed; it is provenance,
            # not an injected fault
            if r.get("cat") == "fault" and name != "chaos-plan":
                faults[name] = faults.get(name, 0) + 1
            agent = args.get("agent")
            if agent is None and isinstance(args.get("link"), str):
                agent = args["link"].split(">", 1)[0]
            if agent is not None:
                a = agents.setdefault(str(agent), {})
                a[name] = a.get(name, 0) + 1
    out = {
        "meta": meta,
        "phases": phases,
        "events": events,
        "agents": agents,
        "faults": faults,
        "metrics": metrics,
    }
    if svc_waits or svc_lats or svc_occs:
        out["service"] = _service_summary(svc_waits, svc_lats, svc_occs)
    # serving hardening rows (docs/serving.md): shed / client-retry /
    # restore / frame-rejection counters and the final drain span — a
    # trace where ONLY these fired (e.g. a pure-overload run) still
    # gets a service block
    counters = metrics.get("counters") or {}
    svc_extra: Dict[str, Any] = {}
    for counter, label in (
        ("service.shed", "shed"),
        ("service.client_retries", "client_retries"),
        ("service.sessions_restored", "sessions_restored"),
        ("service.frames_rejected", "frames_rejected"),
        ("service.replayed_replies", "replayed_replies"),
    ):
        if counter in counters:
            svc_extra[label] = counters[counter]
    drain = phases.get("service.drain")
    if drain:
        svc_extra["drain_s"] = round(drain["total_s"], 6)
    if svc_extra:
        out.setdefault("service", {}).update(svc_extra)
    if semirings:
        for rec in semirings.values():
            rec["total_s"] = round(rec["total_s"], 6)
            if rec["cells"] and rec["total_s"] > 0:
                rec["cells_per_sec"] = round(
                    rec["cells"] / rec["total_s"]
                )
        counters = metrics.get("counters") or {}
        out["semiring"] = {
            "by_semiring": semirings,
            "counters": {
                k: counters[k]
                for k in (
                    "semiring.contractions",
                    "semiring.dispatches",
                    "semiring.logsumexp_repairs",
                    "semiring.cert_fallbacks",
                )
                if k in counters
            },
        }
    return out


def format_summary(s: Dict[str, Any]) -> str:
    """Human-readable per-phase / per-agent report."""
    lines: List[str] = []
    phases = s.get("phases", {})
    if phases:
        lines.append("phase                         count    total_s      max_s")
        for name in sorted(
            phases, key=lambda n: -phases[n]["total_s"]
        ):
            p = phases[name]
            lines.append(
                f"{name:<28} {p['count']:>6} {p['total_s']:>10.4f} "
                f"{p['max_s']:>10.4f}"
            )
    events = s.get("events", {})
    if events:
        lines.append("")
        lines.append("event                          count")
        for name in sorted(events, key=lambda n: -events[n]):
            lines.append(f"{name:<28} {events[name]:>7}")
    svc = s.get("service")
    if svc:
        lines.append("")
        lines.append(
            f"service: {svc.get('requests', 0)} requests / "
            f"{svc.get('dispatches', 0)} dispatches"
            + (
                f", coalesce ratio {svc['coalesce_ratio']}"
                if "coalesce_ratio" in svc
                else ""
            )
        )
        lines.append(
            "                                  p50        p90"
            "        p99        max"
        )
        for label in ("queue_wait_s", "latency_s", "batch_occupancy"):
            if label in svc:
                v = svc[label]
                lines.append(
                    f"  {label:<28}"
                    + "".join(
                        f" {v[q]:>10.4f}"
                        for q in ("p50", "p90", "p99", "max")
                    )
                )
        # hardening rows: overload shedding, idempotent client
        # retries, drain/restore lifecycle, rejected frames
        hard = [
            (label, svc[label])
            for label in (
                "shed", "client_retries", "sessions_restored",
                "replayed_replies", "frames_rejected", "drain_s",
            )
            if label in svc
        ]
        if hard:
            lines.append(
                "  "
                + "  ".join(f"{k}={v}" for k, v in hard)
            )
    sem = s.get("semiring")
    if sem:
        lines.append("")
        lines.append(
            "semiring contractions (ops/semiring.py, "
            "docs/semirings.md):"
        )
        for name in sorted(sem.get("by_semiring", {})):
            rec = sem["by_semiring"][name]
            rate = (
                f" ({rec['cells_per_sec']} cells/s)"
                if "cells_per_sec" in rec
                else ""
            )
            lines.append(
                f"  {name:<14} {rec['sweeps']:>3} sweep(s) "
                f"{rec['cells']:>10} cells {rec['total_s']:>9.4f}s"
                + rate
            )
        for k, v in sorted(sem.get("counters", {}).items()):
            lines.append(f"  {k:<34} {v}")
    faults = s.get("faults", {})
    if faults:
        lines.append("")
        lines.append("injected faults:")
        for name in sorted(faults):
            lines.append(f"  {name:<26} {faults[name]:>7}")
    agents = s.get("agents", {})
    if agents:
        lines.append("")
        lines.append("per-agent activity:")
        for agent in sorted(agents):
            parts = ", ".join(
                f"{k}={v}" for k, v in sorted(agents[agent].items())
            )
            lines.append(f"  {agent:<12} {parts}")
    counters = (s.get("metrics") or {}).get("counters") or {}
    if counters:
        lines.append("")
        lines.append("counters:")
        for name in sorted(counters):
            lines.append(f"  {name:<34} {counters[name]}")
    if not lines:
        lines.append("(empty trace: no spans or events)")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# request stitching (`trace-summary --requests`): one correlated
# timeline per trace id across SEPARATE trace files — client-side
# attempt spans from the client process's trace, server-side
# queue/dispatch/device spans from the service's.  Records correlate
# by the wire-propagated trace id (telemetry/context.py): every span/
# event whose args carry `trace` (a single id or a list, for group
# dispatches) joins its request's timeline.  Cross-file ordering
# normalizes each record to unix time via its file's meta `unix_t0`
# (same-host clocks; skew shows up as offset, never as mis-grouping).
# ---------------------------------------------------------------------------

#: the client-side span names (engine/service.py ServiceClient): one
#: `client.request` span per logical request (its dur is the
#: client-measured end-to-end latency) and one `client.attempt` span
#: per delivery attempt (resends under retry get fresh attempt spans
#: that stitch to the SAME trace id)
CLIENT_REQUEST_SPAN = "client.request"
CLIENT_ATTEMPT_SPAN = "client.attempt"
#: the server-side span that carries the request's phase breakdown in
#: its args (engine/service.py)
SERVER_REQUEST_SPAN = "service.request"

#: the reply phase-breakdown keys, in pipeline order (docs/
#: observability.md, "Serving observability")
PHASE_KEYS = (
    "admission", "queue", "compile", "device", "decode", "reply_write",
)


def _record_traces(rec: Dict[str, Any]) -> List[str]:
    tr = (rec.get("args") or {}).get("trace")
    if isinstance(tr, str):
        return [tr]
    if isinstance(tr, (list, tuple)):
        return [t for t in tr if isinstance(t, str)]
    return []


def stitch_requests(
    tracesets: List[List[Dict[str, Any]]],
) -> Dict[str, Dict[str, Any]]:
    """Correlate one or more loaded traces into per-request timelines.

    Returns ``{trace_id: {"timeline": [...], "attempts": n,
    "server_requests": n, "replays": n, "client_latency_s": s|None,
    "phases": {...}|None, "status": ...}}`` with each timeline entry
    ``{"t": unix_seconds, "src": file_index, "kind", "name", "dur",
    "args"}`` sorted by time.  ``server_requests`` counts
    ``service.request`` spans — a retry whose reply was replayed
    stitches to the ORIGINAL server spans, so it stays 1 however many
    client attempts the request took."""
    out: Dict[str, Dict[str, Any]] = {}
    for src, records in enumerate(tracesets):
        unix_t0 = 0.0
        for r in records:
            if r.get("kind") == "meta":
                try:
                    unix_t0 = float(r.get("unix_t0") or 0.0)
                except (TypeError, ValueError):
                    unix_t0 = 0.0
                break
        for r in records:
            kind = r.get("kind")
            if kind not in ("span", "event"):
                continue
            for tid in _record_traces(r):
                req = out.setdefault(
                    tid,
                    {
                        "timeline": [],
                        "attempts": 0,
                        "server_requests": 0,
                        "replays": 0,
                        "client_latency_s": None,
                        "phases": None,
                        "status": None,
                    },
                )
                entry = {
                    "t": unix_t0 + float(r.get("t", 0.0)),
                    "src": src,
                    "kind": kind,
                    "name": r.get("name", "?"),
                    "args": {
                        k: v
                        for k, v in (r.get("args") or {}).items()
                        if k != "trace"
                    },
                }
                if kind == "span":
                    entry["dur"] = float(r.get("dur", 0.0))
                req["timeline"].append(entry)
                name = entry["name"]
                if name == CLIENT_ATTEMPT_SPAN:
                    req["attempts"] += 1
                elif name == CLIENT_REQUEST_SPAN:
                    req["client_latency_s"] = entry.get("dur")
                    req["status"] = entry["args"].get("status")
                elif name == SERVER_REQUEST_SPAN:
                    req["server_requests"] += 1
                    phases = entry["args"].get("phases")
                    if isinstance(phases, dict):
                        req["phases"] = phases
                    if req["status"] is None:
                        req["status"] = entry["args"].get("status")
                elif name == "service-replay":
                    req["replays"] += 1
    for req in out.values():
        req["timeline"].sort(key=lambda e: e["t"])
    return out


def format_requests(stitched: Dict[str, Dict[str, Any]]) -> str:
    """Human-readable per-request timelines (``trace-summary
    --requests``)."""
    if not stitched:
        return "(no trace-tagged records: nothing to stitch)"
    lines: List[str] = []
    order = sorted(
        stitched,
        key=lambda tid: (
            stitched[tid]["timeline"][0]["t"]
            if stitched[tid]["timeline"]
            else 0.0
        ),
    )
    for tid in order:
        req = stitched[tid]
        head = (
            f"request {tid}: {req['attempts']} attempt(s), "
            f"{req['server_requests']} server solve(s)"
        )
        if req["replays"]:
            head += f", {req['replays']} replayed reply(ies)"
        if req["status"] is not None:
            head += f", status={req['status']}"
        if req["client_latency_s"] is not None:
            head += f", client latency {req['client_latency_s']:.4f}s"
        lines.append(head)
        t0 = req["timeline"][0]["t"] if req["timeline"] else 0.0
        for e in req["timeline"]:
            dur = (
                f" dur={e['dur']:.4f}" if e["kind"] == "span" else ""
            )
            args = " ".join(
                f"{k}={v}"
                for k, v in sorted(e["args"].items())
                if v is not None and k != "phases"
            )
            lines.append(
                f"  +{e['t'] - t0:>8.4f}s [{e['src']}] "
                f"{e['kind']:<5} {e['name']:<22}{dur}  {args}".rstrip()
            )
        phases = req.get("phases")
        if phases:
            total = sum(
                float(phases.get(k, 0.0)) for k in PHASE_KEYS
            )
            parts = " ".join(
                f"{k}={float(phases[k]):.4f}"
                for k in PHASE_KEYS
                if k in phases
            )
            tail = f"  phases: {parts} sum={total:.4f}"
            lat = req["client_latency_s"]
            if lat:
                tail += f" ({100.0 * total / lat:.1f}% of client latency)"
            lines.append(tail)
        lines.append("")
    return "\n".join(lines).rstrip()
