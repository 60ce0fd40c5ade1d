"""The span readings of `spans.py` on hand-made spans and idle intervals:
the batches they keep, launch against sync, the encoder's device time, the
host's time between two batches, idle intersected with spans and split by
the innermost span (summing to the idle), and a `--trace 0` run of the
tiny cell recording no span."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from benchmark import run, spans as S
from benchmark.tests import tiny

MS = 1_000_000     # ns


def sp(i, parent, name, start, end, thread=S.BATCHER, device=None, **attrs):
    """A span as `drain_spans` gives it, start and end in ms."""
    s = {"id": i, "parent": parent, "thread": thread, "name": name,
         "start_ns": int(start * MS), "end_ns": int(end * MS), "attrs": attrs}
    if device is not None:
        s.update(device="cuda:0", device_start_ms=device[0], device_end_ms=device[1])
    return s


def batch(b, t0, ids, steps=3, step_ms=4.0, sync_ms=1.0):
    """Batch b from t0 ms: stack 1 ms, prompt 1 ms, one attempt (encode and
    cross-KV on the device 20 ms after t0 for 30 + 5 ms, prefill, `steps`
    steps of `step_ms` each ending with `sync_ms` of sync but the last),
    readback, settle 2 ms, delivery 1 ms."""
    n = lambda: next(ids)     # noqa: E731
    root, att, st = n(), n(), n()
    out = [sp(n(), root, "batcher.stack", t0, t0 + 1),
           sp(n(), root, "engine.prompt", t0 + 1, t0 + 2)]
    t = t0 + 2
    out += [sp(n(), att, "decode.encode", t, t + 1, device=(20.0, 50.0)),
            sp(n(), att, "decode.cross_kv", t + 1, t + 2, device=(50.0, 55.0)),
            sp(n(), att, "decode.prefill", t + 2, t + 3, device=(55.0, 56.0))]
    t += 3
    for k in range(steps):
        step = n()
        out.append(sp(step, st, "decode.step", t, t + step_ms, step=k))
        if k + 1 < steps:
            out.append(sp(n(), step, "decode.sync", t + step_ms - sync_ms, t + step_ms))
        t += step_ms
    out += [sp(st, att, "decode.steps", t0 + 5, t, device=(56.0, 90.0)),
            sp(n(), att, "engine.readback", t, t + 1)]
    out.append(sp(att, root, "engine.attempt", t0 + 2, t + 1, attempt=0, rows=64))
    t += 1
    out.append(sp(n(), root, "engine.settle", t, t + 2))
    t += 2
    out.append(sp(n(), root, "batcher.deliver", t, t + 1))
    out.append(sp(root, None, "batcher.batch", t0, t + 1, batch=b, rows=64, pad=0))
    return out, t + 1


def backlog(n=6, gap=3.0, **kw):
    ids, spans, t, ends = iter(range(1, 10 ** 6)), [], 0.0, {}
    for b in range(1, n + 1):
        got, t = batch(b, t, ids, **kw)
        spans += got
        ends[b] = t
        t += gap
    return spans, ends


def test_kept_batches_leave_out_traced_and_the_next():
    """Batches 1 (warm-up, the window opens at its end) to 8; stretch 3 -> 4
    traced, then 5 -> 6 tried again: 4 and 6 ran traced, 5 and 7 after a
    stop; kept are 2, 3 and 8, as `untraced_batch_s` keeps them."""
    served = SimpleNamespace(batch_t={b: float(b) for b in range(1, 9)}, t_open=1.0,
                             window_batches=list(range(2, 9)), trace_tries=[(3, 4), (5, 6)])
    assert S.kept_batches(served) == [2, 3, 8]


def test_launch_and_sync_per_step():
    spans, _ = backlog(n=1, steps=4, step_ms=4.0, sync_ms=1.5)
    launch, sync, steps = S.launch_sync_ms(S.by_batch(spans)[1])
    assert steps == 4
    assert sync == pytest.approx(3 * 1.5 / 4)
    assert launch == pytest.approx((4 * 4.0 - 3 * 1.5) / 4)
    assert launch * steps + sync * steps == pytest.approx(4 * 4.0)


def test_encode_device_ms_from_encode_start_to_cross_kv_end():
    spans, _ = backlog(n=1)
    assert S.encode_device_ms(S.by_batch(spans)[1]) == pytest.approx(55.0 - 20.0)
    host_only = [{k: v for k, v in s.items() if not k.startswith("device")} for s in spans]
    assert S.encode_device_ms(S.by_batch(host_only)[1]) is None


def test_off_device_ms_across_two_batches():
    """From batch 1's attempt end to batch 2's attempt start: batch 1's
    settle (2 ms) and delivery (1 ms), the 3 ms gap, batch 2's stack and
    prompt (2 ms)."""
    spans, _ = backlog(n=2, gap=3.0)
    grouped = S.by_batch(spans)
    assert S.off_device_ms(grouped[1], grouped[2]) == pytest.approx(2 + 1 + 3 + 2)
    assert S.off_device_ms([], grouped[2]) is None


def test_failed_batch_is_left_out():
    """A failed batch carries the number of the batch after it: `by_batch`
    drops it with its spans, so the next batch's readings are its own."""
    spans, _ = backlog(n=2, gap=3.0)
    failed, _ = batch(2, -100.0, iter(range(10 ** 6, 2 * 10 ** 6)), steps=7)
    next(s for s in failed if s["name"] == "batcher.batch")["attrs"]["failed"] = True
    grouped = S.by_batch(spans + failed)
    assert sorted(grouped) == [1, 2]
    assert S.launch_sync_ms(grouped[2])[2] == 3
    assert {s["id"] for s in grouped[2]} == {s["id"] for s in S.by_batch(spans)[2]}


def test_span_readings_are_medians_over_the_kept_batches():
    spans, _ = backlog(n=5, gap=3.0, steps=3, step_ms=4.0, sync_ms=1.0)
    slow, _ = batch(9, 10_000.0, iter(range(10 ** 6, 2 * 10 ** 6)), steps=3, step_ms=40.0)
    got = S.span_readings(spans + slow, [2, 3, 4])
    assert got == pytest.approx({"decode.launch_ms.batch": (12.0 - 2.0) / 3,
                                 "decode.sync_ms.batch": 2.0 / 3,
                                 "window.encode_device_ms.batch": 35.0,
                                 "engine.off_device_ms.batch": 8.0})
    assert S.span_readings(spans, [42]) == {}


def test_idle_in_steps_and_by_span_sum_to_the_idle():
    """Idle split by the innermost batcher span: entries and `(none)` sum to
    the idle; the part under steps is what lies inside `decode.steps`;
    another thread's `engine.mel` is counted beside the batcher's span it
    fell in."""
    spans, ends = backlog(n=3, gap=3.0)
    idle = [(s * MS, (s + 0.5) * MS) for s in range(0, int(ends[3]) + 2)]
    mel = sp(10 ** 7, None, "engine.mel", 0, ends[3] + 2, thread="MainThread")
    rows = S.idle_by_span(idle, spans + [mel], top=100)
    total = sum(e - s for s, e in idle) / 1e9
    assert sum(r[1] for r in rows) == pytest.approx(total)
    assert sum(r[2] for r in rows) == pytest.approx(total)     # the client ran mel throughout
    names = {r[0] for r in rows}
    assert S.NONE in names and "decode.step" in names and "decode.sync" in names
    assert "batcher.batch" not in names      # every ms of a batch is inside a child
    assert [r[1] for r in rows] == sorted((r[1] for r in rows), reverse=True)
    in_steps = S.idle_in(idle, spans, "decode.steps")
    by_step = sum(r[1] for r in rows if r[0] in ("decode.step", "decode.sync")) * 1e9
    assert in_steps == pytest.approx(by_step)
    assert 0 < in_steps < sum(e - s for s, e in idle)
    assert len(S.idle_by_span(idle, spans, top=3)) == 3


def test_innermost_names_each_piece_after_the_deepest_span():
    spans = [sp(1, None, "outer", 0, 10), sp(2, 1, "a", 2, 4), sp(3, 2, "deep", 3, 4),
             sp(4, 1, "b", 6, 7), sp(5, None, "other", 12, 13, thread="x")]
    assert S.innermost(spans) == [(0, 2 * MS, "outer"), (2 * MS, 3 * MS, "a"),
                                  (3 * MS, 4 * MS, "deep"), (4 * MS, 6 * MS, "outer"),
                                  (6 * MS, 7 * MS, "b"), (7 * MS, 10 * MS, "outer")]


def test_untraced_run_records_no_span():
    """A `--trace 0` run of the cell keeps the program's spans off."""
    from speaksense_tpu_torch.utils.metrics import REGISTRY

    REGISTRY.drain_spans()
    dropped = REGISTRY.spans_dropped
    torch.set_num_threads(4)
    out = run.run_cell(tiny.cell(), 3_000_000_019, 8.0, False, "cpu")
    assert out["correct"] is True and out["attempted"] > 0
    assert REGISTRY.drain_spans() == [] and REGISTRY.spans_dropped == dropped
