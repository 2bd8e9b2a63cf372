"""Metrics — Prometheus-style counters/histograms, dependency-free.

Rebuild of reference ``metrics/metrics.go:31-68``: per-feature serve
latency histograms + error counters and training-row counters, exposed
in Prometheus text format (scrapeable by an actual Prometheus).
"""

from __future__ import annotations

import threading
from collections import defaultdict

_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0)


class Histogram:
    def __init__(self):
        self.counts = [0] * (len(_BUCKETS) + 1)
        self.total = 0.0
        self.n = 0

    def observe(self, v: float) -> None:
        self.total += v
        self.n += 1
        for i, b in enumerate(_BUCKETS):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1


class MetricsHandler:
    """The reference's MetricsHandler interface: observe serve events,
    render /metrics."""

    def __init__(self, namespace: str = "embeddinghub_tpu"):
        self.ns = namespace
        self._lock = threading.Lock()
        self._serve_hist: dict[tuple[str, str], Histogram] = defaultdict(Histogram)
        self._errors: dict[tuple[str, str], int] = defaultdict(int)
        self._training_rows: dict[tuple[str, str], int] = defaultdict(int)
        self._counters: dict[str, int] = defaultdict(int)

    def feature_served(self, feature: str, variant: str, latency_s: float) -> None:
        with self._lock:
            self._serve_hist[(feature, variant)].observe(latency_s)

    def feature_error(self, feature: str, variant: str) -> None:
        with self._lock:
            self._errors[(feature, variant)] += 1

    def training_rows(self, name: str, variant: str, n: int) -> None:
        with self._lock:
            self._training_rows[(name, variant)] += n

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] += n

    def snapshot(self) -> dict:
        """JSON-friendly snapshot for the dashboard's metrics view
        (the reference dashboard charts Prometheus queries; without a
        Prometheus in-process the UI polls this and keeps its own
        short history for sparklines)."""
        with self._lock:
            return {
                "serve": [
                    {
                        "feature": f,
                        "variant": v,
                        "count": h.n,
                        "avg_latency_ms": (
                            round(1000.0 * h.total / h.n, 3) if h.n else 0.0
                        ),
                    }
                    for (f, v), h in self._serve_hist.items()
                ],
                "errors": [
                    {"feature": f, "variant": v, "count": n}
                    for (f, v), n in self._errors.items()
                ],
                "training_rows": [
                    {"training_set": f, "variant": v, "rows": n}
                    for (f, v), n in self._training_rows.items()
                ],
                "counters": dict(self._counters),
            }

    def render(self) -> str:
        """Prometheus text exposition format."""
        with self._lock:
            lines = []
            h = f"{self.ns}_feature_serve_latency_seconds"
            lines.append(f"# TYPE {h} histogram")
            for (f, v), hist in self._serve_hist.items():
                labels = f'feature="{f}",variant="{v}"'
                cum = 0
                for i, b in enumerate(_BUCKETS):
                    cum += hist.counts[i]
                    lines.append(f'{h}_bucket{{{labels},le="{b}"}} {cum}')
                cum += hist.counts[-1]
                lines.append(f'{h}_bucket{{{labels},le="+Inf"}} {cum}')
                lines.append(f"{h}_sum{{{labels}}} {hist.total}")
                lines.append(f"{h}_count{{{labels}}} {hist.n}")
            c = f"{self.ns}_feature_serve_errors_total"
            lines.append(f"# TYPE {c} counter")
            for (f, v), n in self._errors.items():
                lines.append(f'{c}{{feature="{f}",variant="{v}"}} {n}')
            t = f"{self.ns}_training_rows_served_total"
            lines.append(f"# TYPE {t} counter")
            for (f, v), n in self._training_rows.items():
                lines.append(f'{t}{{trainingset="{f}",variant="{v}"}} {n}')
            for name, n in self._counters.items():
                lines.append(f"# TYPE {self.ns}_{name} counter")
                lines.append(f"{self.ns}_{name} {n}")
            return "\n".join(lines) + "\n"


class NoOpMetricsHandler(MetricsHandler):
    """Reference parity: the local binary uses a no-op handler
    (main.go:183)."""

    def feature_served(self, *a, **k):
        pass

    def feature_error(self, *a, **k):
        pass

    def training_rows(self, *a, **k):
        pass

    def inc(self, *a, **k):
        pass


METRICS = MetricsHandler()
