"""Process-local metrics registry: counters, gauges, fixed-bucket
histograms (a copy of ``pydcop_tpu/telemetry/metrics.py``).

Hot-path contract: producers guard every update with ONE attribute
check::

    met = get_metrics()
    if met.enabled:
        met.inc("engine.chunks")

When no telemetry session is active, ``get_metrics()`` returns the
:data:`NULL_METRICS` singleton whose ``enabled`` is ``False``: the guard
is the whole cost of a disabled metric.

Updates are plain dict operations on int/float values; a concurrent
read-modify-write pair can lose one increment, which these
observability counters accept.  ``snapshot()`` copies whatever is
visible at call time.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

# Default histogram buckets: log-spaced duration boundaries (seconds).
# An observation lands in the first bucket whose bound is >= value; the
# implicit last bucket is +inf.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 60.0,
)


def percentiles_from_histogram(
    bounds, counts, qs=(50, 90, 99)
) -> Dict[str, float]:
    """Percentiles of a fixed-bucket histogram, at bucket resolution:
    the rank of the q-th percentile over n samples is
    ``round(q/100 * (n-1))``, and the reported value is the UPPER BOUND
    of the bucket holding that rank (the overflow bucket reports the
    largest finite bound)."""
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


class Histogram:
    """Fixed-bucket histogram: per-bucket counts plus sum/count."""

    __slots__ = ("bounds", "counts", "total", "n")

    def __init__(self, bounds: Sequence[float] = DEFAULT_BUCKETS):
        self.bounds: Tuple[float, ...] = tuple(bounds)
        # one count per bound + one overflow bucket (+inf)
        self.counts: List[int] = [0] * (len(self.bounds) + 1)
        self.total = 0.0
        self.n = 0

    def observe(self, value: float) -> None:
        i = 0
        for i, b in enumerate(self.bounds):  # noqa: B007 — small, fixed
            if value <= b:
                break
        else:
            i = len(self.bounds)
        self.counts[i] += 1
        self.total += value
        self.n += 1

    def to_dict(self) -> Dict[str, object]:
        return {
            "buckets": list(self.bounds),
            "counts": list(self.counts),
            "sum": self.total,
            "count": self.n,
            **percentiles_from_histogram(self.bounds, self.counts),
        }


class MetricsRegistry:
    """Live registry installed by a telemetry session.

    ``flight`` (attached by the session) mirrors counter and gauge
    deltas onto the flight-recorder ring (``telemetry/flightrec.py``);
    histogram observations are not mirrored."""

    enabled = True

    def __init__(self):
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, Histogram] = {}
        self.flight = None

    def inc(self, name: str, n: float = 1) -> None:
        c = self._counters
        c[name] = c.get(name, 0) + n
        flight = self.flight
        if flight is not None:
            flight.counter(name, n)

    def gauge(self, name: str, value: float) -> None:
        self._gauges[name] = value
        flight = self.flight
        if flight is not None:
            flight.gauge(name, value)

    def observe(
        self, name: str, value: float,
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ) -> None:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram(buckets)
        h.observe(value)

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """JSON-safe copy of everything recorded so far."""
        return {
            "counters": dict(self._counters),
            "gauges": dict(self._gauges),
            "histograms": {
                k: h.to_dict() for k, h in self._hists.items()
            },
        }


class _NullMetrics:
    """Disabled registry: every producer's one-attribute-check guard."""

    enabled = False

    def inc(self, name: str, n: float = 1) -> None:
        pass

    def gauge(self, name: str, value: float) -> None:
        pass

    def observe(self, name, value, buckets=DEFAULT_BUCKETS) -> None:
        pass

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        return {"counters": {}, "gauges": {}, "histograms": {}}


NULL_METRICS = _NullMetrics()
