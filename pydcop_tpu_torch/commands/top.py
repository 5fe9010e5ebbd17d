"""``top`` — live terminal view of serving processes (a copy of
``pydcop_tpu/commands/top.py``: the exporter format is shared, so it
reads either package's ``serve --metrics_port``).

Polls ``serve --metrics_port`` exporters' ``/metrics`` and
``/healthz`` endpoints (``telemetry/export.py``,
``docs/observability.md`` "Serving observability") and renders the
serving vitals in place: health/drain state, queue depth, request /
tick / shed counters with per-interval rates, and the latency
histogram percentiles.  ``--count 1`` prints one snapshot and exits
(scriptable); the default loops until Ctrl-C.

Fleet mode: pass SEVERAL exporter addresses, or just the ``fleet``
router's aggregate endpoint — its ``/healthz`` carries the
per-replica roster (name, liveness, metrics address), which ``top``
expands into one row per replica plus a fleet-total row
(``docs/serving.md``, "The fleet")."""

from __future__ import annotations

import json
import sys
import time


def set_parser(subparsers) -> None:
    p = subparsers.add_parser(
        "top",
        help="live terminal view of a running serve --metrics_port "
        "process: polls /metrics + /healthz into request/shed rates, "
        "queue depth and latency percentiles "
        "(docs/observability.md)",
    )
    p.add_argument(
        "addresses", nargs="+", metavar="address",
        help="one or more exporter addresses: host:port or a full "
        "http:// URL (the serving line of `pydcop_tpu serve "
        "--metrics_port` prints it).  Several addresses — or a "
        "single `fleet --metrics_port` aggregate endpoint, whose "
        "roster is expanded automatically — render per-replica "
        "rows plus a fleet total",
    )
    p.add_argument(
        "--interval", type=float, default=2.0, metavar="SECONDS",
        help="poll interval (default 2s)",
    )
    p.add_argument(
        "--count", type=int, default=0, metavar="N",
        help="stop after N polls (0 = until Ctrl-C); --count 1 is "
        "the scriptable one-shot snapshot",
    )
    p.set_defaults(func=run_cmd)


#: the headline counter rows, in display order (raw exported names —
#: the `pydcop_` prefix and `_total` suffix are added by the exporter)
_HEADLINE_COUNTERS = (
    ("service_requests", "requests"),
    ("service_ticks", "ticks"),
    ("service_dispatches", "dispatches"),
    ("service_coalesced", "coalesced"),
    ("service_shed", "shed"),
    ("service_errors", "errors"),
    ("service_replayed_replies", "replayed"),
    ("service_frames_rejected", "frames_rejected"),
    # deterministic contraction work delivered — the rate column is
    # cells/s, the FAQ cost-model throughput unit (docs/performance.md)
    ("service_work_cells", "work_cells"),
    ("telemetry_flight_dumps", "flight_dumps"),
)

_HIST_ROWS = (
    ("service_queue_wait_s", "queue_wait_s"),
    ("service_latency_s", "latency_s"),
    ("service_shed_latency_s", "shed_latency_s"),
    ("service_batch_occupancy", "occupancy"),
)


def _base_url(address: str) -> str:
    if address.startswith(("http://", "https://")):
        return address.rstrip("/")
    return "http://" + address


def format_top(
    metrics: dict, health: dict, rates: dict
) -> str:
    """One rendered frame from parsed /metrics + /healthz (split out
    for tests)."""
    lines = []
    status = health.get("status", "?")
    lines.append(
        f"serve: status={status} queue_depth="
        f"{health.get('queue_depth', '?')} inflight="
        f"{health.get('inflight', '?')} sessions="
        f"{health.get('sessions', '?')}"
    )
    lines.append("")
    lines.append(f"{'counter':<18}{'total':>12}{'per_sec':>10}")
    from pydcop_tpu_torch.telemetry.export import PREFIX

    for raw, label in _HEADLINE_COUNTERS:
        key = PREFIX + raw + "_total"
        if key not in metrics:
            continue
        rate = rates.get(key)
        lines.append(
            f"{label:<18}{int(metrics[key]):>12}"
            + (f"{rate:>10.1f}" if rate is not None else f"{'-':>10}")
        )
    hist_lines = []
    for raw, label in _HIST_ROWS:
        count_key = PREFIX + raw + "_count"
        if count_key not in metrics:
            continue
        row = f"{label:<18}{int(metrics[count_key]):>8}"
        for q in ("p50", "p90", "p99"):
            v = metrics.get(f"{PREFIX}{raw}_{q}")
            row += (
                f"  {q}={v:g}" if v is not None else f"  {q}=-"
            )
        hist_lines.append(row)
    if hist_lines:
        lines.append("")
        lines.append(f"{'histogram':<18}{'count':>8}  percentiles")
        lines.extend(hist_lines)
    return "\n".join(lines)


def _collect_rows(addresses):
    """One poll over every requested address: returns
    ``(router_health, rows)`` where ``rows`` is an ordered list of
    ``(label, metrics-or-None, health)``.  A fleet router's aggregate
    ``/healthz`` (it carries ``fleet: true`` and the replica roster)
    expands into one row per replica — scraped from each replica's
    OWN exporter; a dead or unreachable replica still gets a row, so
    the view never silently narrows during an outage."""
    from pydcop_tpu_torch.telemetry.export import (
        http_get,
        parse_prometheus_text,
    )

    router_health = None
    rows = []
    for address in addresses:
        base = _base_url(address)
        try:
            health = json.loads(http_get(base + "/healthz"))
        except (OSError, ValueError) as e:
            raise SystemExit(f"top: cannot scrape {base}: {e}")
        roster = health.get("replicas")
        if health.get("fleet") and isinstance(roster, dict):
            router_health = health
            for name in sorted(roster):
                rep = roster[name] or {}
                maddr = rep.get("metrics")
                if not rep.get("alive", True):
                    rows.append((name, None, {"status": "dead"}))
                    continue
                if not maddr:
                    rows.append(
                        (name, None, {"status": "no-metrics"})
                    )
                    continue
                rbase = _base_url(maddr)
                try:
                    rows.append(
                        (
                            name,
                            parse_prometheus_text(
                                http_get(rbase + "/metrics")
                            ),
                            json.loads(
                                http_get(rbase + "/healthz")
                            ),
                        )
                    )
                except (OSError, ValueError):
                    rows.append(
                        (name, None, {"status": "unreachable"})
                    )
            continue
        try:
            metrics = parse_prometheus_text(
                http_get(base + "/metrics")
            )
        except (OSError, ValueError) as e:
            raise SystemExit(f"top: cannot scrape {base}: {e}")
        rows.append((address, metrics, health))
    return router_health, rows


def format_fleet_top(router_health, rows, rates) -> str:
    """The fleet frame: one row per replica plus a total (split out
    for tests).  ``rates`` maps row label → requests/sec (None on
    the first poll)."""
    from pydcop_tpu_torch.telemetry.export import PREFIX

    lines = []
    if router_health is not None:
        dead = [
            n
            for n, rep in (router_health.get("replicas") or {}).items()
            if not (rep or {}).get("alive", True)
        ]
        lines.append(
            f"fleet: status={router_health.get('status', '?')} "
            f"replicas={len(router_health.get('replicas') or {})} "
            f"dead={sorted(dead)} "
            f"sessions={router_health.get('sessions', '?')} "
            f"requests={router_health.get('requests', '?')} "
            f"failovers={router_health.get('failovers', '?')}"
        )
        lines.append("")
    lines.append(
        f"{'replica':<12}{'status':<12}{'queue':>6}{'sess':>6}"
        f"{'requests':>10}{'req/s':>8}{'shed':>7}{'errors':>7}"
        f"{'p99_s':>9}"
    )
    tot = {"queue": 0, "sess": 0, "requests": 0, "shed": 0,
           "errors": 0}
    tot_rate = 0.0
    saw_rate = False
    for label, metrics, health in rows:
        status = (health or {}).get("status", "?")
        if metrics is None:
            lines.append(f"{label:<12}{status:<12}" + "-".rjust(6))
            continue
        queue = int((health or {}).get("queue_depth", 0))
        sess = int((health or {}).get("sessions", 0))
        reqs = int(metrics.get(
            PREFIX + "service_requests_total", 0
        ))
        shed = int(metrics.get(PREFIX + "service_shed_total", 0))
        errs = int(metrics.get(PREFIX + "service_errors_total", 0))
        p99 = metrics.get(PREFIX + "service_latency_s_p99")
        rate = rates.get(label)
        if rate is not None:
            tot_rate += rate
            saw_rate = True
        tot["queue"] += queue
        tot["sess"] += sess
        tot["requests"] += reqs
        tot["shed"] += shed
        tot["errors"] += errs
        lines.append(
            f"{label:<12}{status:<12}{queue:>6}{sess:>6}"
            f"{reqs:>10}"
            + (f"{rate:>8.1f}" if rate is not None else f"{'-':>8}")
            + f"{shed:>7}{errs:>7}"
            + (f"{p99:>9.3g}" if p99 is not None else f"{'-':>9}")
        )
    lines.append(
        f"{'TOTAL':<12}{'':<12}{tot['queue']:>6}{tot['sess']:>6}"
        f"{tot['requests']:>10}"
        + (f"{tot_rate:>8.1f}" if saw_rate else f"{'-':>8}")
        + f"{tot['shed']:>7}{tot['errors']:>7}" + f"{'':>9}"
    )
    return "\n".join(lines)


def run_cmd(args) -> int:
    if args.interval <= 0:
        raise SystemExit("top: --interval must be > 0")
    prev: dict = {}
    prev_t = None
    polls = 0
    try:
        while True:
            router_health, rows = _collect_rows(args.addresses)
            now = time.perf_counter()
            fleet_view = router_health is not None or len(rows) > 1
            if not fleet_view:
                label, metrics, health = rows[0]
                rates = {}
                if prev_t is not None:
                    dt = max(now - prev_t, 1e-9)
                    rates = {
                        k: (v - prev.get(label, {}).get(k, 0.0))
                        / dt
                        for k, v in metrics.items()
                        if isinstance(v, (int, float))
                        and k.endswith("_total")
                    }
                frame = format_top(metrics, health, rates)
                prev = {label: metrics}
            else:
                from pydcop_tpu_torch.telemetry.export import PREFIX

                req_key = PREFIX + "service_requests_total"
                rates = {}
                cur = {}
                for label, metrics, _health in rows:
                    if metrics is None:
                        continue
                    cur[label] = metrics
                    if prev_t is not None and label in prev:
                        dt = max(now - prev_t, 1e-9)
                        rates[label] = (
                            metrics.get(req_key, 0.0)
                            - prev[label].get(req_key, 0.0)
                        ) / dt
                frame = format_fleet_top(
                    router_health, rows, rates
                )
                prev = cur
            if polls and sys.stdout.isatty():
                # redraw in place on a live terminal; plain append
                # otherwise (pipes/tests get one frame per poll)
                print("\x1b[2J\x1b[H", end="")
            print(frame, flush=True)
            polls += 1
            prev_t = now
            if args.count and polls >= args.count:
                return 0
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0
