"""Lightweight metrics: counters + latency histograms + gauges, exported in
Prometheus text format, and spans for tracing.

The port's own copy of `speaksense_tpu/utils/metrics.py`. The port's
counters live in this module's `REGISTRY`, not in the JAX package's.

The reference has no metrics/health endpoints (SURVEY.md §5 observability:
only per-key usage stats and task status counts); this module adds the
per-stage latency instrumentation that section calls for. Zero deps,
thread-safe, negligible overhead.

Spans (`Registry.span`) are off until `trace_spans(True)`: off, a span is
one flag read and a shared no-op context. On, each records its id, its
parent (the innermost span open on the same thread), the thread's name,
start and end on `time.time_ns` (the clock `torch.profiler`'s device
events are stamped with) and its attributes; a span given a CUDA device
also records a CUDA event pair on that device's current stream, read only
when the spans are drained. Spans stay out of `snapshot` and `/metrics`.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import defaultdict

_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)
# spans held until drained; those ending past it are counted in `spans_dropped`
SPAN_CAPACITY = 1 << 16


class _NoSpan:
    """The span of a registry that records none: one object, shared."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None

    def annotate(self, **attrs) -> None:
        return None


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("_reg", "_device", "_events", "name", "attrs", "id", "parent", "thread",
                 "start_ns", "end_ns")

    def __init__(self, reg: "Registry", name: str, device, attrs: dict):
        self._reg, self._device, self._events = reg, device, None
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = self._reg._stack()
        self.id = next(self._reg._span_ids)
        self.parent = stack[-1] if stack else None
        stack.append(self.id)
        self.thread = threading.current_thread().name
        self.start_ns = time.time_ns()
        if self._device is not None and self._device.type == "cuda":
            import torch

            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record(torch.cuda.current_stream(self._device))
        return self

    def __exit__(self, *exc) -> None:
        if self._events is not None:
            import torch

            self._events[1].record(torch.cuda.current_stream(self._device))
        self.end_ns = time.time_ns()
        self._reg._stack().pop()
        self._reg._keep(self)

    def annotate(self, **attrs) -> None:
        """Add attributes to the span while it is open."""
        self.attrs.update(attrs)


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = defaultdict(float)
        self._gauges: dict[str, float] = {}
        # name -> (bucket_counts, sum, count)
        self._hists: dict[str, tuple[list[int], float, int]] = {}
        self._spans_on = False
        self._spans: list[_Span] = []
        self._span_ids = itertools.count()
        self._local = threading.local()
        self.spans_dropped = 0

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

    # ------------------------------------------------------------------ spans

    def span(self, name: str, device=None, **attrs):
        """Context manager: one span named `name` with `attrs`. `device`, a
        `torch.device`, adds a CUDA event pair on its current stream where
        it is a CUDA device. Off (the default), the shared no-op context:
        no clock read, no event, nothing kept."""
        if not self._spans_on:
            return _NO_SPAN
        return _Span(self, name, device, attrs)

    def trace_spans(self, on: bool) -> None:
        """Record spans from now on (True) or stop recording them (False)."""
        self._spans_on = bool(on)

    def drain_spans(self) -> list[dict]:
        """The spans recorded since the last drain, in the order they ended,
        as dicts (id, parent, thread, name, start_ns, end_ns, attrs), and
        forgets them. A span with CUDA events adds device, device_start_ms
        and device_end_ms: its events in ms after the earliest-starting
        span's start event on the same device in this drain. Waits for each
        event to complete."""
        with self._lock:
            spans, self._spans = self._spans, []
        origins: dict = {}
        for s in sorted((s for s in spans if s._events is not None), key=lambda s: s.start_ns):
            origins.setdefault(str(s._device), s._events[0])
        out = []
        for s in spans:
            d = {"id": s.id, "parent": s.parent, "thread": s.thread, "name": s.name,
                 "start_ns": s.start_ns, "end_ns": s.end_ns, "attrs": s.attrs}
            if s._events is not None:
                start, end = s._events
                end.synchronize()
                origin = origins[str(s._device)]
                d.update(device=str(s._device), device_start_ms=origin.elapsed_time(start),
                         device_end_ms=origin.elapsed_time(end))
            out.append(d)
        return out

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _keep(self, span: _Span) -> None:
        with self._lock:
            if len(self._spans) < SPAN_CAPACITY:
                self._spans.append(span)
            else:
                self.spans_dropped += 1

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
