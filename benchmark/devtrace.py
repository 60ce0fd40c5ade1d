"""The device trace of a run: `torch.profiler` with device activity only,
started and stopped around a stretch of the measured window, reduced to
what the per-layer readers and the result line need.

The profiler's raw events are read (`kineto_results.events()`): building
its per-event tree takes minutes for the half a million launches of one
batch. The traced window is the host's interval between start and stop on
the clock the events are stamped with, `time.time_ns` (the H100's traces
show it); a trace whose events do not fall inside that interval is refused.
Each `start` opens a session of its own, so a stretch whose trace came out
short can be traced again.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np


def short(name: str, width: int = 96) -> str:
    """A kernel's name without its return type, namespaces and arguments'
    noise, cut to `width` characters."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::",
                  "std::enable_if<true, void>::type ", "std::enable_if<!(false), void>::type ",
                  "at::"):
        name = name.replace(noise, "")
    return name[:width]


@dataclass
class Summary:
    window_s: float
    busy_s: float
    kernels: dict = field(default_factory=dict)     # name -> device seconds in the window
    durations: dict = field(default_factory=dict)   # name -> [seconds of each launch]
    idle_gaps: list = field(default_factory=list)   # [[name, seconds], ...] longest first
    # every interval of the window in which nothing ran on the device, in time
    # order: (n, 2) [start_ns, end_ns] on `time.time_ns`, the clock of the
    # program's spans
    idle: np.ndarray = field(default_factory=lambda: np.zeros((0, 2), np.int64))

    def device_ops(self, top: int = 10) -> list:
        ranked = sorted(self.kernels.items(), key=lambda kv: -kv[1])[:top]
        return [[short(name), sec] for name, sec in ranked]

    def launches_of(self, part: str) -> list[float]:
        """Device seconds of each launch of every kernel whose name holds `part`."""
        return [d for name, ds in self.durations.items() if part in name for d in ds]


class DeviceTrace:
    def __init__(self):
        self._prof = None
        self._marks: list[int] = []        # time.time_ns() at start and stop
        self.info: dict | None = None       # what `summary` found, for the run's log

    @property
    def running(self) -> bool:
        return self._prof is not None and len(self._marks) == 1

    @property
    def done(self) -> bool:
        return len(self._marks) == 2

    def _mark(self) -> None:
        self._marks.append(time.time_ns())

    def prepare(self, device) -> None:
        """A throwaway profiler run around one small launch. The process's first
        profiler start sets up the device tracing, which takes seconds and
        holds the interpreter meanwhile; set-up pays that, not the window."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):
            torch.ones(1, device=device).add_(1)
            torch.cuda.synchronize(device)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._marks, self.info = [], None
        self._prof.start()
        self._mark()

    def stop(self) -> None:
        self._mark()
        self._prof.stop()

    def summary(self, top_gaps: int = 10) -> Summary | None:
        """The last session's reduction. None when the trace holds no
        device event. Raises when the events' middle falls outside the
        window's marks: their clock is then another, and the window cannot
        be placed."""
        from torch.autograd import DeviceType

        events = [(e.name(), e.start_ns(), e.duration_ns())
                  for e in self._prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0]
        if not events:
            return None
        events.sort(key=lambda e: e[1])
        mid = events[len(events) // 2][1]
        lo, hi = self._marks
        if not lo <= mid <= hi:
            raise RuntimeError(f"the trace's events ({events[0][1]} to {events[-1][1]} ns) do "
                               f"not fall inside its window ({lo} to {hi} ns of time.time_ns)")
        self.info = {"events": len(events),
                     "events_span_s": (max(s + d for _, s, d in events) - events[0][1]) / 1e9}
        kernels: dict = {}
        durations: dict = {}
        busy, gaps, idle = 0, [], []
        cur_end, cur_name = lo, "window start"
        for name, start, dur in events:
            s, e = max(start, lo), min(start + dur, hi)
            if e <= s:
                continue
            kernels[name] = kernels.get(name, 0.0) + (e - s) / 1e9
            durations.setdefault(name, []).append(dur / 1e9)
            if s > cur_end:
                gaps.append(((s - cur_end) / 1e9, cur_name))
                idle += (cur_end, s)
            if e > cur_end:
                busy += e - max(s, cur_end)
                cur_end, cur_name = e, name
        if hi > cur_end:
            gaps.append(((hi - cur_end) / 1e9, cur_name))
            idle += (cur_end, hi)
        gaps.sort(key=lambda g: -g[0])
        return Summary(window_s=(hi - lo) / 1e9, busy_s=busy / 1e9, kernels=kernels,
                       durations=durations,
                       idle_gaps=[[f"after {short(name)}", sec] for sec, name in gaps[:top_gaps]],
                       idle=np.asarray(idle, np.int64).reshape(-1, 2))
