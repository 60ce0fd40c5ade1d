"""Readings of the program's spans (`REGISTRY.drain_spans()` of
`speaksense_tpu_torch.utils.metrics`) over a window backlog's batches and
its device trace. Each function is the reduction behind one per-layer
reading of the window path:

- `launch_sync_ms`: per batch, the mean host ms of a `decode.step` less
  its `decode.sync` (the host launching one step), and the mean host ms a
  step spends in `decode.sync` (the host waiting on the card);
- `encode_device_ms`: per batch, the device ms from the start event of
  `decode.encode` to the end event of `decode.cross_kv`;
- `off_device_ms`: the batcher thread's host ms from the end of one
  batch's last `engine.attempt` to the start of the next batch's first;
- `idle_in(idle, spans, "decode.steps")`: the trace's idle ns inside the
  batcher thread's decode steps, `idle` being the traced window's idle
  intervals (`devtrace.Summary.idle`);
- `idle_by_span`: each idle interval split by the innermost span open on
  the batcher thread, with the part during another thread's `engine.mel`.

Spans and the device trace share `time.time_ns`. A batch's spans are its
`batcher.batch` span (whose `batch` attribute is the batcher's
`batches_run` at its completion) and that span's descendants. The span
readings read the batches that `kept_batches` names, those that
`window_backlog.untraced_batch_s` times.
"""

from __future__ import annotations

import bisect
import statistics

BATCHER = "batch-engine"     # the window batcher's thread
NONE = "(none)"


def kept_batches(served) -> list[int]:
    """The window's batches outside every traced stretch and the batch
    after each (which pays the profiler's stop), as `untraced_batch_s`
    keeps them: batch b with its predecessor a, neither ending a stretch.
    The same selection as `untraced_batch_s`, written again because that
    function returns only the median; the two should share one function."""
    order = sorted(b for b, t in served.batch_t.items() if t == served.t_open)
    order += served.window_batches
    ends = {end for _, end in served.trace_tries}
    return [b for a, b in zip(order, order[1:]) if a not in ends and b not in ends]


def by_batch(spans: list[dict]) -> dict[int, list[dict]]:
    """{batch number: its `batcher.batch` span and every descendant}. A
    batch that failed (attribute `failed`) is left out with its spans: the
    batch after it carries the same number."""
    parent = {s["id"]: s["parent"] for s in spans}
    roots = {s["id"]: (None if s["attrs"].get("failed") else s["attrs"]["batch"])
             for s in spans if s["name"] == "batcher.batch"}
    out: dict[int, list[dict]] = {b: [] for b in roots.values() if b is not None}
    for s in spans:
        i = s["id"]
        while i is not None and i not in roots:
            i = parent.get(i)
        if i is not None and roots[i] is not None:
            out[roots[i]].append(s)
    return out


def _ms(s: dict) -> float:
    return (s["end_ns"] - s["start_ns"]) / 1e6


def launch_sync_ms(batch: list[dict]) -> tuple[float, float, int] | None:
    """(launch ms, sync ms, steps) of one batch's spans: the mean over its
    steps of a step's host ms less its sync child's, and of its sync
    child's (0 for a step that ends without one). None without steps."""
    steps = [s for s in batch if s["name"] == "decode.step"]
    if not steps:
        return None
    sync: dict = {}
    for s in batch:
        if s["name"] == "decode.sync":
            sync[s["parent"]] = sync.get(s["parent"], 0.0) + _ms(s)
    total = sum(_ms(s) for s in steps)
    waited = sum(sync.get(s["id"], 0.0) for s in steps)
    return (total - waited) / len(steps), waited / len(steps), len(steps)


def encode_device_ms(batch: list[dict]) -> float | None:
    """Device ms from each attempt's `decode.encode` start event to its
    `decode.cross_kv` end event, summed over the batch's attempts; None
    where the spans carry no CUDA events."""
    enc = {s["parent"]: s for s in batch if s["name"] == "decode.encode"}
    kv = {s["parent"]: s for s in batch if s["name"] == "decode.cross_kv"}
    pairs = [(enc[p], kv[p]) for p in enc if p in kv]
    if not pairs or any("device_start_ms" not in e for e, _ in pairs):
        return None
    return sum(k["device_end_ms"] - e["device_start_ms"] for e, k in pairs)


def off_device_ms(prev: list[dict], batch: list[dict]) -> float | None:
    """Host ms from the end of `prev`'s last `engine.attempt` to the start
    of `batch`'s first."""
    ends = [s["end_ns"] for s in prev if s["name"] == "engine.attempt"]
    starts = [s["start_ns"] for s in batch if s["name"] == "engine.attempt"]
    if not ends or not starts:
        return None
    return (min(starts) - max(ends)) / 1e6


def median_over(batches: list[int], spans: list[dict], reading) -> float | None:
    """The median of `reading(spans of b, spans of the batch before b)`
    over `batches`, leaving out those it gives None."""
    grouped = by_batch(spans)
    values = [reading(grouped[b], grouped.get(b - 1, [])) for b in batches if b in grouped]
    values = [v for v in values if v is not None]
    return statistics.median(values) if values else None


def span_readings(spans: list[dict], batches: list[int]) -> dict:
    """{metric name: median over `batches`} of the four span readings; a
    reading with nothing to read is left out."""
    def part(i):
        return lambda cur, prev: (launch_sync_ms(cur) or (None, None))[i]

    out = {"decode.launch_ms.batch": median_over(batches, spans, part(0)),
           "decode.sync_ms.batch": median_over(batches, spans, part(1)),
           "window.encode_device_ms.batch":
               median_over(batches, spans, lambda cur, prev: encode_device_ms(cur)),
           "engine.off_device_ms.batch":
               median_over(batches, spans, lambda cur, prev: off_device_ms(prev, cur))}
    return {k: v for k, v in out.items() if v is not None}


# ------------------------------------------------------------ device trace


def _union(intervals) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _overlap(s: int, e: int, union: list[tuple[int, int]], starts: list[int]) -> int:
    """ns of [s, e] inside the sorted disjoint intervals `union`."""
    i = max(bisect.bisect_right(starts, s) - 1, 0)
    got = 0
    while i < len(union) and union[i][0] < e:
        got += max(0, min(e, union[i][1]) - max(s, union[i][0]))
        i += 1
    return got


def idle_in(idle, spans: list[dict], name: str, thread: str = BATCHER) -> int:
    """ns of the idle intervals inside `thread`'s spans named `name`."""
    union = _union((s["start_ns"], s["end_ns"]) for s in spans
                   if s["name"] == name and s["thread"] == thread)
    starts = [s for s, _ in union]
    return sum(_overlap(s, e, union, starts) for s, e in idle)


def innermost(spans: list[dict], thread: str = BATCHER) -> list[tuple[int, int, str]]:
    """`thread`'s timeline as (start_ns, end_ns, name) pieces, each named
    after the innermost of the thread's spans open over it; where none is
    open there is no piece. A thread's spans nest."""
    out: list[tuple[int, int, str]] = []
    stack: list[tuple[int, str]] = []      # (end, name) of the open spans
    cur = None

    def close_until(t):
        nonlocal cur
        while stack and stack[-1][0] <= t:
            end, name = stack.pop()
            if end > cur:
                out.append((cur, end, name))
                cur = end

    for s in sorted((s for s in spans if s["thread"] == thread),
                    key=lambda s: (s["start_ns"], -s["end_ns"])):
        start = s["start_ns"]
        if stack:
            close_until(start)
        if stack and start > cur:
            out.append((cur, start, stack[-1][1]))
        cur = start
        stack.append((s["end_ns"], s["name"]))
    if stack:
        close_until(max(end for end, _ in stack))
    return out


def idle_by_span(idle, spans: list[dict], thread: str = BATCHER, top: int = 10) -> list:
    """[[name, idle s, of which during another thread's engine.mel s], ...],
    longest first, at most `top`: each idle interval split by the
    innermost span open on `thread`; idle outside every span under
    `NONE`."""
    pieces = innermost(spans, thread)
    mel = _union((s["start_ns"], s["end_ns"]) for s in spans
                 if s["name"] == "engine.mel" and s["thread"] != thread)
    mel_starts = [s for s, _ in mel]
    sums: dict[str, list[int]] = {}

    def add(name, s, e):
        got = sums.setdefault(name, [0, 0])
        got[0] += e - s
        got[1] += _overlap(s, e, mel, mel_starts)

    j = 0
    for s, e in idle:
        while j < len(pieces) and pieces[j][1] <= s:
            j += 1
        cur, k = s, j
        while k < len(pieces) and pieces[k][0] < e:
            ps, pe, name = pieces[k]
            if ps > cur:
                add(NONE, cur, ps)
            a, b = max(ps, cur), min(pe, e)
            if b > a:
                add(name, a, b)
                cur = b
            k += 1
        if e > cur:
            add(NONE, cur, e)
    ranked = sorted(sums.items(), key=lambda kv: -kv[1][0])[:top]
    return [[name, ns / 1e9, mel_ns / 1e9] for name, (ns, mel_ns) in ranked]
