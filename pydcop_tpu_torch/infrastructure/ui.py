"""Live observability bridge (a copy of ``pydcop_tpu/infrastructure/ui.py``;
reference: ``pydcop/infrastructure/ui.py``).

The reference runs one websocket server per agent feeding the external
``pydcop-ui`` front-end with live value/graph events.  Here solving is
batched, so ONE server observes the whole run: a tiny dependency-free
HTTP server exposing

- ``GET /events`` — **Server-Sent Events** stream; one ``data:`` line
  per engine chunk with ``{"cycle", "cost", "best_cost", "values"}``
  (SSE is websocket-equivalent for a one-way feed and consumable from
  a browser with three lines of ``EventSource`` JS — no extra
  dependency in this zero-egress image, where the reference's
  ``websocket-server`` package is unavailable).
- ``GET /state`` — current snapshot as one JSON object (poll-style).
- ``GET /`` — a minimal built-in live page (cost curve + assignment),
  so the bridge is usable without the external front-end.

Wire-up: ``solve(..., ui_port=N)`` / CLI ``--uiport N`` starts the
server and the engine publishes at every chunk boundary via its
``chunk_callback`` seam; ``pydcop_tpu_torch orchestrator --runtime host
--uiport N`` serves the same feed for cross-process runs (the host
orchestrator's best-cost samples).
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

_PAGE = """<!doctype html>
<html><head><title>pydcop_tpu_torch live</title></head><body>
<h3>pydcop_tpu_torch live run</h3>
<div>cycle: <span id="cy">-</span> cost: <span id="co">-</span>
 best: <span id="be">-</span></div>
<pre id="vals"></pre>
<script>
const es = new EventSource('/events');
es.onmessage = (e) => {
  const d = JSON.parse(e.data);
  document.getElementById('cy').textContent = d.cycle;
  document.getElementById('co').textContent = d.cost;
  document.getElementById('be').textContent = d.best_cost;
  if (d.values) document.getElementById('vals').textContent =
    JSON.stringify(d.values, null, 1);
};
</script></body></html>"""


class UiServer:
    """One SSE publisher for a run.  Thread-safe ``publish()``; every
    connected ``/events`` client receives all events from connect time
    on (plus one replay of the latest event so late joiners render
    immediately)."""

    def __init__(self, port: int, host: str = "0.0.0.0"):
        self._clients: List["queue.Queue"] = []
        self._lock = threading.Lock()
        self._last: Optional[Dict[str, Any]] = None
        self.events_published = 0

        ui = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path == "/":
                    body = _PAGE.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if self.path == "/state":
                    body = json.dumps(ui._last or {}).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if self.path != "/events":
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()
                q = ui._attach()
                try:
                    while True:
                        evt = q.get()
                        if evt is None:  # server closing
                            break
                        self.wfile.write(
                            b"data: " + json.dumps(evt).encode() + b"\n\n"
                        )
                        self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError, OSError):
                    pass
                finally:
                    ui._detach(q)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()

    def _attach(self):
        import queue

        q: "queue.Queue" = queue.Queue()
        with self._lock:
            if self._last is not None:
                q.put(self._last)
            self._clients.append(q)
        return q

    def _detach(self, q) -> None:
        with self._lock:
            if q in self._clients:
                self._clients.remove(q)

    def publish(
        self,
        cycle: int,
        cost: float,
        best_cost: float,
        values: Optional[Dict[str, Any]] = None,
        **extra: Any,
    ) -> None:
        evt = {
            "t": time.time(),
            "cycle": int(cycle),
            "cost": None if cost is None else float(cost),
            "best_cost": None if best_cost is None else float(best_cost),
            **extra,
        }
        if values is not None:
            evt["values"] = values
        with self._lock:
            self._last = evt
            self.events_published += 1
            for q in self._clients:
                q.put(evt)

    def close(self) -> None:
        with self._lock:
            clients = list(self._clients)
        for q in clients:
            q.put(None)
        self._httpd.shutdown()
        self._httpd.server_close()


def chunk_publisher(ui: "UiServer", prev_callback=None):
    """Adapt a :class:`UiServer` to the engine's ``chunk_callback``
    seam: publishes ``{cycle, best_cost}`` per chunk, chaining any
    existing callback (e.g. the orchestrator's lockstep barrier)."""

    def cb(done_rounds: int, best_cost: float):
        ui.publish(done_rounds, None, best_cost)
        if prev_callback is not None:
            return prev_callback(done_rounds, best_cost)
        return None

    return cb
