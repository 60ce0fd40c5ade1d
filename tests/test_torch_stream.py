"""The port's streaming slice as a whole: the port's `StreamSession` over the
port's pooled `BatchedEngine` against the JAX `StreamSession` over the JAX one,
the pooled fallback ladder's structure, and the engine's stream surface
(pipelined submission, oversized chunks, the padded tail flush, silence
suppression, conditioning). Tiny shared weights, float32, on the CPU."""

import base64
import contextlib
import dataclasses

import numpy as np
import pytest

from speaksense_tpu.asr import AsrParams
from speaksense_tpu.asr.engine import WhisperEngine as JEngine
from speaksense_tpu.config import EngineConfig
from speaksense_tpu.models import whisper as JW
from speaksense_tpu.models.tokenizer import Tokenizer as JTokenizer
from speaksense_tpu.runtime.batcher import BatchedEngine as JBatched
from speaksense_tpu.serving.stream import StreamSession as JSession
from speaksense_tpu.utils.metrics import REGISTRY as JMETRICS
from speaksense_tpu_torch.asr.engine import WhisperEngine as TEngine
from speaksense_tpu_torch.models import whisper as TW
from speaksense_tpu_torch.models.tokenizer import Tokenizer
from speaksense_tpu_torch.runtime.batcher import BatchedEngine as TBatched
from speaksense_tpu_torch.serving.stream import StreamSession as TSession
from speaksense_tpu_torch.utils.metrics import REGISTRY as TMETRICS

DIMS = JW.WhisperDims(n_mels=80, n_vocab=51865, n_audio_ctx=1500, n_audio_state=64,
                      n_audio_head=4, n_audio_layer=2, n_text_ctx=448, n_text_state=64,
                      n_text_head=4, n_text_layer=2)
TDIMS = TW.WhisperDims(**DIMS.__dict__)
# the ladder neutralized: every chunk is one greedy pool job
NEVER = dict(compression_ratio_thold=1e9, logprob_thold=-1e9, entropy_thold=-1.0)
# every candidate fails the logprob gate and none is silent: every chunk
# climbs the whole ladder
ALWAYS = dict(logprob_thold=1e9, no_speech_thold=2.0)
STREAM = AsrParams(language="en", stream_mode=True)
POOL = dict(n_slots=4, t_mel=512, max_new=12, max_prompt=64)


@pytest.fixture(scope="module")
def engines():
    """A JAX and a port engine on the same weights, each with a
    conditioning-capable slot pool."""
    np_params = JW.init_params_np(DIMS, seed=0)
    cfg = EngineConfig(compute_dtype="float32", best_of=2, **NEVER)
    jeng = JEngine(np_params, DIMS, JTokenizer.synthetic(DIMS.n_vocab), config=cfg)
    teng = TEngine.from_jax_params(np_params, TDIMS, Tokenizer.synthetic(DIMS.n_vocab),
                                   config=dataclasses.replace(cfg), device="cpu")
    for eng in (jeng, teng):
        eng.enable_slot_serving(**POOL)
    yield jeng, teng
    for eng in (jeng, teng):
        eng.disable_slot_serving()


@contextlib.contextmanager
def _thresholds(engs, **kw):
    saved = [eng.config for eng in engs]
    for eng in engs:
        eng.config = dataclasses.replace(eng.config, **kw)
    try:
        yield
    finally:
        for eng, cfg in zip(engs, saved):
            eng.config = cfg


def _counter(name: str, metrics=TMETRICS) -> float:
    """A counter of the port's registry, or of `metrics` (each package
    counts in its own)."""
    return metrics.snapshot()["counters"].get(name, 0.0)


def _speech(seconds: float, seed: int = 3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000
    f0 = 140 + 30 * np.sin(2 * np.pi * 0.3 * t)
    voiced = sum(np.sin(2 * np.pi * k * np.cumsum(f0) / 16000) / k for k in range(1, 6))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 4 * t) ** 2
    return (0.2 * voiced * env + 0.02 * rng.standard_normal(t.size)).astype(np.float32)


def _session_events(engine, pcm: np.ndarray, session_cls=TSession) -> list:
    """ingest 1 s packets, settle in order, finish: the gRPC handler's use."""
    session = session_cls(engine, language="en", denoise=True)
    pendings = []
    for i in range(0, pcm.size, 16000):
        pendings += session.ingest(base64.standard_b64encode(pcm[i:i + 16000].tobytes()))
    events = [ev for p in pendings for ev in session.settle(p)]
    return [dataclasses.asdict(ev) for ev in events + session.finish()]


def test_stream_session_matches_jax(engines):
    """10 s in 1 s packets with device denoise: two 5 s chunks (0.5 s
    overlap) and a 1 s tail, three pool jobs on each side, the same
    events."""
    jeng, teng = engines
    pcm = (_speech(10.0) * 32767).astype(np.int16)
    out = []
    for eng, batched, session_cls in ((jeng, JBatched, JSession), (teng, TBatched, TSession)):
        wrapper = batched(eng, max_batch=2, max_wait_ms=1.0)
        rows = eng._slot_server.pool.admit_rows
        try:
            assert wrapper.device_denoise
            out.append(_session_events(wrapper, pcm, session_cls))
        finally:
            wrapper.stop()
        assert eng._slot_server.pool.admit_rows - rows == 3
    want, got = out
    assert got == want
    assert got[-1]["end"] == 1 and sum(ev["end"] for ev in got) == 1


def test_pooled_ladder_structure_matches_jax(engines):
    """Trip-everything thresholds: on both packages a pooled chunk retries
    at 0.2 .. 1.0 with best_of resubmissions per rung, counts 5 pool retries,
    keeps its t = 1.0 attempt and resets the conditioning context (hot
    retry). Sampled tokens differ (two RNGs), so only the structure is
    compared."""
    jeng, teng = engines
    audio = _speech(3.0)
    seen = []
    for eng, metrics in ((jeng, JMETRICS), (teng, TMETRICS)):
        server = eng._slot_server
        temps = []
        real = server.submit_audio

        def spy(a, temperature=0.0, **kw):
            temps.append(float(temperature))
            return real(a, temperature=temperature, **kw)

        server.submit_audio = spy
        finals = []
        real_gate = eng._pool_quality_gate

        def gate(raw, retry):
            cand = real_gate(raw, retry)
            finals.append((cand["temperature"], "compression_ratio" in cand))
            return cand

        eng._pool_quality_gate = gate
        state = eng.create_state()
        state.context_tokens = [101, 102]
        b_pool = _counter("asr_pool_fallback_retries_total", metrics)
        b_all = _counter("asr_fallback_retries_total", metrics)
        try:
            with _thresholds([eng], **ALWAYS):
                res = eng.transcribe_with_state(state, audio, STREAM)
        finally:
            del server.submit_audio
            del eng._pool_quality_gate
        seen.append((temps, _counter("asr_pool_fallback_retries_total", metrics) - b_pool,
                     _counter("asr_fallback_retries_total", metrics) - b_all,
                     state.context_tokens, res.language, finals))
    assert seen[0] == seen[1]
    temps, pool_retries, all_retries, ctx, lang, finals = seen[1]
    assert temps == [0.0, 0.2, 0.2, 0.4, 0.4, 0.6, 0.6, 0.8, 0.8, 1.0, 1.0]
    assert pool_retries == all_retries == 5.0
    assert ctx == [] and lang == "en"
    assert finals == [(1.0, True)]


def test_silence_suppressed_and_short_circuits_the_ladder(engines):
    """no_speech_prob over its threshold and a poor logprob: no text, the
    suppression counter moves, and no fallback retry is paid."""
    _, teng = engines
    with _thresholds([teng], no_speech_thold=-1.0, logprob_thold=1e9):
        b_sup = _counter("asr_no_speech_suppressed_total")
        b_retry = _counter("asr_fallback_retries_total")
        res = teng.transcribe_with_state(teng.create_state(), _speech(3.0), STREAM)
    assert res.full_text == "" and res.segments == []
    assert _counter("asr_no_speech_suppressed_total") == b_sup + 1
    assert _counter("asr_fallback_retries_total") == b_retry


def test_oversized_chunk_rides_the_pool(engines):
    """A 12.8 s chunk against the 512-frame pool rides as three concurrent
    sub-windows, pipelined or sequential alike, with the JAX package's
    merged result and no window-path trip."""
    jeng, teng = engines
    audio = _speech(12.8, seed=5)
    before = _counter("asr_slot_bucket_fallbacks_total")
    want = jeng.transcribe_with_state(jeng.create_state(), audio, STREAM)
    rows = teng._slot_server.pool.admit_rows
    seq = teng.transcribe_with_state(teng.create_state(), audio, STREAM)
    pending = teng.submit_stream_chunk(teng.create_state(), audio, STREAM)
    assert pending is not None and len(pending.futures) == 3
    assert pending.settle() == seq
    # the two packages' results are instances of two classes: compare fields
    assert dataclasses.asdict(seq) == dataclasses.asdict(want)
    assert teng._slot_server.pool.admit_rows - rows == 6
    assert _counter("asr_slot_bucket_fallbacks_total") == before
    for s in seq.segments:
        assert 0.0 <= s.start <= s.end <= audio.size / 16000 + 1e-6


def test_tail_flush_rides_the_pool_with_pad_to_bucket(teng_1024):
    """On a 1024-frame pool a 3 s chunk is sub-bucket: declined without
    pad_to_bucket, admitted zero-padded with it (the tail flush's path)."""
    audio = _speech(3.0)
    assert teng_1024.submit_stream_chunk(teng_1024.create_state(), audio, STREAM) is None
    rows = teng_1024._slot_server.pool.admit_rows
    pending = teng_1024.submit_stream_chunk(None, audio, STREAM, pad_to_bucket=True)
    assert pending is not None and pending.settle().language == "en"
    assert teng_1024._slot_server.pool.admit_rows == rows + 1


def test_sub_bucket_chunk_on_a_larger_pool_takes_the_window_path(teng_1024):
    before = _counter("asr_slot_bucket_fallbacks_total")
    rows = teng_1024._slot_server.pool.admit_rows
    res = teng_1024.transcribe_with_state(
        teng_1024.create_state(), _speech(3.0), dataclasses.replace(STREAM, denoise=True))
    assert res.language == "en"
    assert _counter("asr_slot_bucket_fallbacks_total") == before + 1
    assert teng_1024._slot_server.pool.admit_rows == rows


@pytest.fixture(scope="module")
def teng_1024(engines):
    _, teng = engines
    eng = TEngine(teng.model, teng.tokenizer, config=teng.config)
    eng.enable_slot_serving(n_slots=2, t_mel=1024, max_new=8)
    yield eng
    eng.disable_slot_serving()


def test_submit_stream_chunk_gating_and_conditioned_bound(engines):
    """Bounded conditioned pipelining: a conditioning-capable pool takes at
    most two conditioned chunks of one stream in flight, each prompt
    carrying the context snapshot of its submit time; past the bound the
    chunk takes the sequential path (None)."""
    _, teng = engines
    audio = _speech(3.0)
    assert teng.submit_stream_chunk(teng.create_state(), audio,
                                    AsrParams(language="en")) is None
    server = teng._slot_server
    contexts = []
    real = server.submit_audio

    def spy(a, context=None, **kw):
        contexts.append(list(context) if context else None)
        return real(a, context=context, **kw)

    server.submit_audio = spy
    try:
        state = teng.create_state()
        state.context_tokens = [101, 102]
        p1 = teng.submit_stream_chunk(state, audio, STREAM)
        p2 = teng.submit_stream_chunk(state, audio, STREAM)
        assert p1 is not None and p2 is not None and state.inflight_conditioned == 2
        assert teng.submit_stream_chunk(state, audio, STREAM) is None
        assert contexts == [[101, 102], [101, 102]]
        p1.settle()
        assert state.inflight_conditioned == 1
        p2.settle()
        assert state.inflight_conditioned == 0
        assert len(state.context_tokens) <= server.pool.max_prompt
        p3 = teng.submit_stream_chunk(state, audio, STREAM)
        assert p3 is not None
        p3.settle()
    finally:
        del server.submit_audio


def test_sequential_conditioned_chunks_match_jax(engines):
    """Chunks settled one after another through a conditioning-capable
    pool: the context grows from each chunk's text, with the JAX package's
    results and context."""
    out = []
    chunks = [_speech(3.0, seed=s) for s in (1, 2, 3)]
    for eng in engines:
        state = eng.create_state()
        res = [eng.transcribe_with_state(state, c, STREAM) for c in chunks]
        out.append(([r.full_text for r in res], list(state.context_tokens)))
    assert out[0] == out[1]
