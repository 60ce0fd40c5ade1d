"""The port's span recorder (`utils/metrics.py` `Registry.span`) and the
spans of the window path: the off path records nothing and makes no CUDA
event, nesting follows each thread's own stack, the buffer drains and
counts what it drops, times are on `time.time_ns`, a window batch through
`BatchedEngine` yields its whole tree, tokens do not depend on tracing, and
`asr_windows_total` counts only real windows."""

import threading
import time
import types
from collections import Counter

import numpy as np
import pytest
import torch

from speaksense_tpu_torch.asr.engine import WhisperEngine
from speaksense_tpu_torch.config import EngineConfig
from speaksense_tpu_torch.models import whisper as W
from speaksense_tpu_torch.models.tokenizer import Tokenizer
from speaksense_tpu_torch.runtime.batcher import BatchedEngine
from speaksense_tpu_torch.utils import metrics as M


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the parallel test run puts several workers on
    the cores, and torch's thread pool then spins against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tracing():
    """The shared registry with spans on, drained before and after."""
    M.REGISTRY.drain_spans()
    M.REGISTRY.trace_spans(True)
    try:
        yield M.REGISTRY
    finally:
        M.REGISTRY.trace_spans(False)
        M.REGISTRY.drain_spans()


DIMS = W.WhisperDims(n_mels=80, n_vocab=51865, n_audio_ctx=1500, n_audio_state=64,
                     n_audio_head=2, n_audio_layer=1, n_text_ctx=448, n_text_state=64,
                     n_text_head=2, n_text_layer=1)
MAX_NEW = 8
# no fallback fires: one greedy attempt a batch
CONFIG = dict(compute_dtype="float32", max_decode_len=2 * MAX_NEW, best_of=1,
              compression_ratio_thold=1e9, logprob_thold=-1e9, entropy_thold=-1.0)
# a batch's tree below `batcher.batch`: each span's parent
TREE = {"batcher.stack": "batcher.batch", "engine.prompt": "batcher.batch",
        "engine.attempt": "batcher.batch", "decode.encode": "engine.attempt",
        "decode.cross_kv": "engine.attempt", "decode.prefill": "engine.attempt",
        "decode.steps": "engine.attempt", "decode.step": "decode.steps",
        "decode.sync": "decode.step", "engine.readback": "engine.attempt",
        "engine.settle": "batcher.batch", "batcher.deliver": "batcher.batch"}


@pytest.fixture(scope="module")
def engine():
    model = W.init_random(DIMS, torch.Generator().manual_seed(5), device="cpu",
                          dtype=torch.float32)
    return WhisperEngine(model, Tokenizer.synthetic(DIMS.n_vocab), config=EngineConfig(**CONFIG),
                         name="tiny", seed=0)


@pytest.fixture(scope="module")
def mels(engine):
    rng = np.random.default_rng(11)
    audio = (0.1 * rng.standard_normal((3, 16000 * 30))).astype(np.float32)
    return engine.compute_mel(audio)


def _windows_total() -> float:
    return M.REGISTRY.snapshot()["counters"].get("asr_windows_total", 0.0)


# ---------------------------------------------------------------- recorder


def test_off_path_is_one_shared_noop(monkeypatch):
    """Off: every call returns the same no-op object; no clock is read, no
    CUDA event made, nothing kept."""
    reg = M.Registry()

    def boom(*a, **k):
        raise AssertionError("made a CUDA event with spans off")

    monkeypatch.setattr(torch.cuda, "Event", boom)
    monkeypatch.setattr(M, "time", types.SimpleNamespace())      # no clock to read
    first = reg.span("a")
    for _ in range(3):
        with reg.span("b", device=torch.device("cuda"), step=1) as s:
            assert s is first
    assert reg.drain_spans() == [] and reg.spans_dropped == 0
    assert "spans" not in reg.snapshot()


def test_nesting_and_parents_per_thread(tracing):
    """Parents come from the thread's own stack: two threads interleaving
    their spans never adopt each other's."""
    inner_open = threading.Barrier(2)

    def work(tag):
        with tracing.span(f"{tag}.outer", tag=tag):
            with tracing.span(f"{tag}.inner"):
                inner_open.wait()
            with tracing.span(f"{tag}.second"):
                pass

    threads = [threading.Thread(target=work, args=(t,), name=f"t{t}") for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    with tracing.span("root"):
        pass
    spans = {s["name"]: s for s in tracing.drain_spans()}
    assert len(spans) == 7 and len({s["id"] for s in spans.values()}) == 7
    for tag in "ab":
        outer = spans[f"{tag}.outer"]
        assert outer["parent"] is None and outer["attrs"] == {"tag": tag}
        assert outer["thread"] == f"t{tag}"
        for child in ("inner", "second"):
            s = spans[f"{tag}.{child}"]
            assert s["parent"] == outer["id"] and s["thread"] == f"t{tag}"
    assert spans["root"]["parent"] is None
    assert spans["root"]["thread"] == threading.current_thread().name


def test_drain_clears_and_capacity_counts_drops(monkeypatch):
    reg = M.Registry()
    reg.trace_spans(True)
    monkeypatch.setattr(M, "SPAN_CAPACITY", 3)
    for i in range(5):
        with reg.span("s", i=i):
            pass
    kept = reg.drain_spans()
    assert [s["attrs"]["i"] for s in kept] == [0, 1, 2] and reg.spans_dropped == 2
    assert reg.drain_spans() == []
    with reg.span("again"):
        pass
    assert [s["name"] for s in reg.drain_spans()] == ["again"] and reg.spans_dropped == 2
    reg.trace_spans(False)
    with reg.span("off"):
        pass
    assert reg.drain_spans() == []


def test_times_are_on_time_ns():
    """A span's start and end lie between `time.time_ns()` readings taken
    around them, the clock the device trace is stamped with."""
    reg = M.Registry()
    reg.trace_spans(True)
    before = time.time_ns()
    with reg.span("outer"):
        mid0 = time.time_ns()
        with reg.span("inner"):
            time.sleep(0.002)
        mid1 = time.time_ns()
    after = time.time_ns()
    inner, outer = reg.drain_spans()
    assert before <= outer["start_ns"] <= mid0 <= inner["start_ns"]
    assert inner["end_ns"] - inner["start_ns"] >= 2_000_000
    assert inner["end_ns"] <= mid1 <= outer["end_ns"] <= after


def test_device_span_records_an_event_pair(monkeypatch):
    """A span given a CUDA device records one event at entry and one at
    exit on the device's current stream, and the drain reads them as ms
    after the drain's first device span; a CPU device records none."""
    made, clock = [], iter(range(1, 100))

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing
            self.t, self.stream = None, None
            made.append(self)

        def record(self, stream):
            self.stream, self.t = stream, 1.5 * next(clock)

        def synchronize(self):
            pass

        def elapsed_time(self, other):
            return other.t - self.t

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: f"stream of {device}")
    reg = M.Registry()
    reg.trace_spans(True)
    cuda = torch.device("cuda", 0)
    with reg.span("cpu", device=torch.device("cpu")):
        pass
    with reg.span("first", device=cuda):
        assert len(made) == 2 and made[0].t is not None and made[1].t is None
    with reg.span("second", device=cuda):
        pass
    assert len(made) == 4 and all(e.stream == "stream of cuda:0" for e in made)
    cpu, first, second = reg.drain_spans()
    assert "device_start_ms" not in cpu
    assert first["device"] == second["device"] == "cuda:0"
    assert first["device_start_ms"] == 0.0
    assert first["device_end_ms"] == made[1].t - made[0].t
    assert second["device_start_ms"] == made[2].t - made[0].t
    assert second["device_end_ms"] == made[3].t - made[0].t


# ------------------------------------------------------------- window path


def _steps_run(tokens_sampled: list[int]) -> int:
    """Decode steps a batch ran: to the longest row's end-of-text, or the cap."""
    return min(MAX_NEW, max(tokens_sampled) + 1)


def test_batched_engine_span_tree(engine, mels, tracing):
    """Per batch, the window path's spans form the tree of `TREE`; the
    batch number is `batches_run`'s; one `decode.step` per step run and one
    `decode.sync` per step that ends with the host's read."""
    serving = BatchedEngine(engine, max_batch=2, max_wait_ms=50.0)
    try:
        futures = [serving.submit_window(m, "en", "transcribe", False) for m in mels]
        results = [f.result(timeout=120) for f in futures]
        batches = serving.batches_run
    finally:
        serving.stop()
    spans = tracing.drain_spans()
    by_id = {s["id"]: s for s in spans}
    roots = [s for s in spans if s["name"] == "batcher.batch"]
    assert sorted(s["attrs"]["batch"] for s in roots) == list(range(1, batches + 1))
    assert sum(s["attrs"]["rows"] for s in roots) == len(mels)
    assert all(s["attrs"]["rows"] + s["attrs"]["pad"] == 2 for s in roots)
    assert Counter(s["name"] for s in spans)["engine.mel"] == 0   # made before tracing

    def batch_of(s):
        while s["name"] != "batcher.batch":
            s = by_id[s["parent"]]
        return s["attrs"]["batch"]

    tree = [s for s in spans if s["name"] != "batcher.batch"]
    for s in tree:
        assert s["thread"] == "batch-engine"
        assert by_id[s["parent"]]["name"] == TREE[s["name"]], s["name"]
        assert by_id[s["parent"]]["start_ns"] <= s["start_ns"] <= s["end_ns"]
        assert s["end_ns"] <= by_id[s["parent"]]["end_ns"]
    once = [n for n in TREE if n not in ("decode.step", "decode.sync")]
    # batches take the queue's windows in order, so the answers follow the batches
    first = 0
    for root in sorted(roots, key=lambda s: s["start_ns"]):
        b, rows = root["attrs"]["batch"], root["attrs"]["rows"]
        names = Counter(s["name"] for s in tree if batch_of(s) == b)
        assert {n: names[n] for n in once} == dict.fromkeys(once, 1)
        steps = [s["attrs"]["step"] for s in tree if s["name"] == "decode.step"
                 and batch_of(s) == b]
        assert steps == list(range(_steps_run([r["n_sampled"]
                                               for r in results[first:first + rows]])))
        assert names["decode.sync"] == (len(steps) if len(steps) < MAX_NEW else MAX_NEW - 1)
        first += rows


def test_failed_batch_is_marked(engine, mels, tracing, monkeypatch):
    """A batch whose decode raises keeps the number the next batch takes,
    and is marked `failed`; the next batch is not."""
    real = engine.decode_windows
    calls = []

    def fail_first(*a, **k):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("planted")
        return real(*a, **k)

    monkeypatch.setattr(engine, "decode_windows", fail_first)
    serving = BatchedEngine(engine, max_batch=2, max_wait_ms=1.0)
    try:
        first = serving.submit_window(mels[0], "en", "transcribe", False)
        with pytest.raises(RuntimeError, match="planted"):
            first.result(timeout=120)
        serving.submit_window(mels[1], "en", "transcribe", False).result(timeout=120)
    finally:
        serving.stop()
    roots = sorted((s for s in tracing.drain_spans() if s["name"] == "batcher.batch"),
                   key=lambda s: s["start_ns"])
    assert [s["attrs"]["batch"] for s in roots] == [1, 1] and serving.batches_run == 1
    assert roots[0]["attrs"]["failed"] is True and "failed" not in roots[1]["attrs"]


def test_tokens_equal_with_spans_on_and_off(engine, mels):
    off = engine.decode_windows(mels, "en")
    M.REGISTRY.trace_spans(True)
    try:
        on = engine.decode_windows(mels, "en")
    finally:
        M.REGISTRY.trace_spans(False)
    assert len(M.REGISTRY.drain_spans()) > 0
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        assert a["text"] == b["text"] and a["avg_logprob"] == b["avg_logprob"]


def test_windows_total_counts_real_windows(engine, mels):
    """A batch padded to `max_batch` counts its real windows only; a direct
    caller of `decode_windows` counts every row it passes."""
    serving = BatchedEngine(engine, max_batch=4, max_wait_ms=1.0)
    before = _windows_total()
    try:
        serving.submit_window(mels[0], "en", "transcribe", False).result(timeout=120)
    finally:
        serving.stop()
    assert serving.windows_run == 1 and _windows_total() - before == 1
    before = _windows_total()
    engine.decode_windows(mels[:2], "en")
    assert _windows_total() - before == 2
