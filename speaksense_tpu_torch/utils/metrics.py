"""Lightweight metrics: counters + latency histograms + gauges, exported in
Prometheus text format.

The port's own copy of `speaksense_tpu/utils/metrics.py`. The port's
counters live in this module's `REGISTRY`, not in the JAX package's.

The reference has no metrics/health endpoints (SURVEY.md §5 observability:
only per-key usage stats and task status counts); this module adds the
per-stage latency instrumentation that section calls for. Zero deps,
thread-safe, negligible overhead.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import contextmanager

_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = defaultdict(float)
        self._gauges: dict[str, float] = {}
        # name -> (bucket_counts, sum, count)
        self._hists: dict[str, tuple[list[int], float, int]] = {}

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += value

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            buckets, total, count = self._hists.get(name, ([0] * len(_BUCKETS), 0.0, 0))
            buckets = list(buckets)
            for i, b in enumerate(_BUCKETS):
                if seconds <= b:
                    buckets[i] += 1
            self._hists[name] = (buckets, total + seconds, count + 1)

    @contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(name, time.perf_counter() - t0)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {
                    k: {"sum": s, "count": c,
                        "buckets": dict(zip(map(str, _BUCKETS), b))}
                    for k, (b, s, c) in self._hists.items()
                },
            }

    def render_prometheus(self) -> str:
        lines: list[str] = []
        snap = self.snapshot()
        for name, v in sorted(snap["counters"].items()):
            lines.append(f"# TYPE {name} counter")
            lines.append(f"{name} {v}")
        for name, v in sorted(snap["gauges"].items()):
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {v}")
        for name, h in sorted(snap["histograms"].items()):
            lines.append(f"# TYPE {name} histogram")
            # bucket counts are recorded cumulatively (every le >= value)
            for b, c in h["buckets"].items():
                lines.append(f'{name}_bucket{{le="{b}"}} {c}')
            lines.append(f'{name}_bucket{{le="+Inf"}} {h["count"]}')
            lines.append(f"{name}_sum {h['sum']}")
            lines.append(f"{name}_count {h['count']}")
        return "\n".join(lines) + "\n"


REGISTRY = Registry()
