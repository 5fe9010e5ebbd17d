"""Live metrics export: Prometheus text exposition + the ``/metrics``
and ``/healthz`` HTTP endpoints (a copy of
``pydcop_tpu/telemetry/export.py``: the same names and format).

Everything before this module was pull-at-the-end observability: the
``stats`` wire op polls a bounded window over the solve protocol
itself, and ``result["telemetry"]`` / ``--trace`` only exist once a
call (or the process) finishes.  A resident service needs the standard
serving answer instead — a scrape endpoint any Prometheus/agent stack
(or ``curl``, or ``top``) can hit while the tick loop is
hot:

- ``GET /metrics`` — the FULL registry in Prometheus text exposition
  format 0.0.4: counters as ``_total`` samples, gauges verbatim,
  histograms as cumulative ``_bucket{le=...}`` series plus ``_sum`` /
  ``_count`` AND the serving percentiles (``p50``/``p90``/``p99``
  gauges at bucket resolution, the same nearest-rank definition as the
  serving report — ``telemetry/summary.py``).  Dots in metric names
  become underscores (``service.requests`` →
  ``pydcop_service_requests_total``).
- ``GET /healthz`` — a small JSON liveness/readiness document from the
  owner's health callback (the solver service reports queue depth,
  in-flight count, and its drain state; ``status`` flips ``ok`` →
  ``draining`` during a graceful shutdown).

The server is a stdlib ``ThreadingHTTPServer`` on its own daemon
threads: a scrape never touches the tick worker, and a hung scraper
costs its connection, nothing else.  Scrapes count on
``telemetry.scrapes``.

:func:`parse_prometheus_text` is the matching reader — ``top`` and the round-trip tests use it, so the writer and reader cannot
drift.
"""

from __future__ import annotations

import json
import re
import threading
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

#: exported metric-name prefix (one namespace for every pydcop_tpu
#: process on a shared scrape target)
PREFIX = "pydcop_"

_NAME_SANITIZE = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(name: str) -> str:
    return PREFIX + _NAME_SANITIZE.sub("_", name)


def _fmt(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def prometheus_text(snapshot: Mapping[str, Any]) -> str:
    """Render a ``MetricsRegistry.snapshot()`` as Prometheus text
    exposition (format 0.0.4)."""
    lines = []
    for name, value in sorted((snapshot.get("counters") or {}).items()):
        pname = _prom_name(name) + "_total"
        lines.append(f"# TYPE {pname} counter")
        lines.append(f"{pname} {_fmt(value)}")
    for name, value in sorted((snapshot.get("gauges") or {}).items()):
        pname = _prom_name(name)
        lines.append(f"# TYPE {pname} gauge")
        lines.append(f"{pname} {_fmt(value)}")
    for name, h in sorted((snapshot.get("histograms") or {}).items()):
        pname = _prom_name(name)
        lines.append(f"# TYPE {pname} histogram")
        bounds = h.get("buckets") or []
        counts = h.get("counts") or []
        cum = 0
        for bound, count in zip(bounds, counts):
            cum += int(count)
            lines.append(
                f'{pname}_bucket{{le="{_fmt(bound)}"}} {cum}'
            )
        cum += int(counts[len(bounds)]) if len(counts) > len(bounds) else 0
        lines.append(f'{pname}_bucket{{le="+Inf"}} {cum}')
        lines.append(f"{pname}_sum {_fmt(h.get('sum', 0.0))}")
        lines.append(f"{pname}_count {int(h.get('count', 0))}")
        # the serving percentiles, at bucket resolution (computed by
        # Histogram.to_dict via the one shared percentile helper)
        for q in ("p50", "p90", "p99"):
            if q in h:
                lines.append(f"# TYPE {pname}_{q} gauge")
                lines.append(f"{pname}_{q} {_fmt(h[q])}")
    return "\n".join(lines) + "\n"


_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+(\S+)$"
)


def parse_prometheus_text(text: str) -> Dict[str, Any]:
    """Parse exposition text back into ``{name: value}`` /
    ``{name: {labelset: value}}`` (labeled series nest under the raw
    label string).  Raises ValueError on a line that is neither a
    comment nor a valid sample — the format round-trip test and the
    live-scrape acceptance both lean on this being strict."""
    out: Dict[str, Any] = {}
    for lineno, line in enumerate(text.splitlines(), start=1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(
                f"line {lineno}: not a Prometheus sample: {line!r}"
            )
        name, labels, value = m.groups()
        v = float(value)
        if labels:
            out.setdefault(name, {})[labels[1:-1]] = v
        else:
            out[name] = v
    return out


class MetricsExporter:
    """The ``/metrics`` + ``/healthz`` HTTP server.

    ``snapshot_fn`` returns the registry snapshot to expose (the serve
    command passes the active session's ``metrics.snapshot``);
    ``health_fn`` returns the ``/healthz`` JSON document.  Both run on
    the scrape thread — they must be cheap and lock-light, which
    ``MetricsRegistry.snapshot`` and ``SolverService.health`` are.
    """

    def __init__(
        self,
        snapshot_fn: Callable[[], Mapping[str, Any]],
        health_fn: Optional[Callable[[], Mapping[str, Any]]] = None,
        host: str = "127.0.0.1",
        port: int = 0,
    ):
        # stdlib-lazy so importing telemetry never pays http.server
        from http.server import (
            BaseHTTPRequestHandler,
            ThreadingHTTPServer,
        )

        exporter = self

        class _Handler(BaseHTTPRequestHandler):
            # scrapes are high-frequency: no per-request stderr line
            def log_message(self, fmt, *args):  # noqa: ARG002
                pass

            def do_GET(self):  # noqa: N802 — http.server contract
                try:
                    if self.path.split("?", 1)[0] == "/metrics":
                        body = prometheus_text(
                            exporter._snapshot_fn()
                        ).encode("utf-8")
                        ctype = (
                            "text/plain; version=0.0.4; charset=utf-8"
                        )
                    elif self.path.split("?", 1)[0] == "/healthz":
                        health = (
                            exporter._health_fn()
                            if exporter._health_fn
                            else {"status": "ok"}
                        )
                        body = (
                            json.dumps(health) + "\n"
                        ).encode("utf-8")
                        ctype = "application/json"
                    else:
                        self.send_error(404, "unknown path")
                        return
                except Exception as e:  # noqa: BLE001 — a broken
                    # callback must cost the scrape, not the handler
                    # thread (and never the tick loop)
                    self.send_error(
                        500, f"{type(e).__name__}: {e}"[:200]
                    )
                    return
                from pydcop_tpu_torch.telemetry import get_metrics

                met = get_metrics()
                if met.enabled:
                    met.inc("telemetry.scrapes")
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._snapshot_fn = snapshot_fn
        self._health_fn = health_fn
        self._server = ThreadingHTTPServer((host, port), _Handler)
        self._server.daemon_threads = True
        self.address: Tuple[str, int] = (
            host, self._server.server_address[1]
        )
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="metrics-exporter",
            daemon=True,
        )
        self._thread.start()

    def close(self) -> None:
        try:
            self._server.shutdown()
            self._server.server_close()
        except OSError:
            pass
        self._thread.join(timeout=5)

    def __enter__(self) -> "MetricsExporter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def http_get(url: str, timeout: float = 5.0) -> str:
    """Tiny GET helper (``top`` and the tests — loopback
    scrapes, no TLS, no redirects)."""
    from urllib.request import urlopen

    with urlopen(url, timeout=timeout) as resp:  # noqa: S310 — the
        # callers pass loopback/operator-supplied scrape addresses
        return resp.read().decode("utf-8")
