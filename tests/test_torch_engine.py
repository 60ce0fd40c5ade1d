"""The port's window-transcription slice as a whole, against the JAX package
on shared tiny weights (both in float32 on the CPU): the window batcher's
`transcribe`, language detection, the temperature-fallback ladder, word
timestamps and VAD segmentation, the REST task processor driving the port
(with VAD segmentation and emotion labels), and the port's import boundary
(no jax and nothing of the JAX package)."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from speaksense_tpu.asr import AsrParams, TranscribeResult
from speaksense_tpu.asr.engine import WhisperEngine as JEngine
from speaksense_tpu.config import Config, EngineConfig
from speaksense_tpu.models import whisper as JW
from speaksense_tpu.models.tokenizer import Tokenizer as JTokenizer
from speaksense_tpu.runtime.batcher import BatchedEngine as JBatched
from speaksense_tpu.utils.metrics import REGISTRY as JMETRICS
from speaksense_tpu_torch import main as TMAIN
from speaksense_tpu_torch.asr import TranscribeResult as TResult
from speaksense_tpu_torch.asr.engine import WhisperEngine as TEngine
from speaksense_tpu_torch.audio import mel as TMEL
from speaksense_tpu_torch.ckpt import ggml as TG
from speaksense_tpu_torch.models import whisper as TW
from speaksense_tpu_torch.models.tokenizer import Tokenizer
from speaksense_tpu_torch.runtime.batcher import BatchedEngine as TBatched
from speaksense_tpu_torch.utils.metrics import REGISTRY as TMETRICS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU ops: the parallel test run
    puts several workers on the cores, and torch's thread pool then spins
    against them, slowing these small ops tenfold or more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = Path(__file__).resolve().parent.parent

DIMS = JW.WhisperDims(n_mels=80, n_vocab=51865, n_audio_ctx=1500, n_audio_state=128,
                      n_audio_head=2, n_audio_layer=2, n_text_ctx=448, n_text_state=128,
                      n_text_head=2, n_text_layer=2)
TDIMS = TW.WhisperDims(**DIMS.__dict__)

# no fallback can fire: t > 0 sampling draws from different RNGs in the two
# packages, so only the greedy ladder rung is compared token for token
NO_FALLBACK = dict(compute_dtype="float32", max_decode_len=128, best_of=1,
                   logprob_thold=-1e9, entropy_thold=-1.0, compression_ratio_thold=1e9)
# every candidate fails the logprob gate, so every row climbs the whole ladder
ALWAYS_FALLBACK = dict(compute_dtype="float32", max_decode_len=32, best_of=2,
                       logprob_thold=1e9, no_speech_thold=1.0)


@pytest.fixture(scope="module")
def np_params():
    return JW.init_params_np(DIMS, seed=2)


def _engines(np_params, **cfg):
    config = EngineConfig(**cfg)
    jeng = JEngine(np_params, DIMS, JTokenizer.synthetic(DIMS.n_vocab), config=config)
    teng = TEngine.from_jax_params(np_params, TDIMS, Tokenizer.synthetic(DIMS.n_vocab),
                                   config=config, device="cpu")
    return jeng, teng


@pytest.fixture(scope="module")
def engines(np_params):
    return _engines(np_params, **NO_FALLBACK)


@pytest.fixture(scope="module")
def speech():
    """40 s of seeded pseudo-speech: voiced harmonics under a syllable-rate
    envelope plus noise, so the seek loop spans two windows."""
    rng = np.random.default_rng(40)
    t = np.arange(16000 * 40) / 16000
    f0 = 140 + 30 * np.sin(2 * np.pi * 0.3 * t)
    voiced = sum(np.sin(2 * np.pi * k * np.cumsum(f0) / 16000) / k for k in range(1, 6))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 4 * t) ** 2
    return (0.2 * voiced * env + 0.02 * rng.standard_normal(t.size)).astype(np.float32)


def _compare(want: TranscribeResult, got: TranscribeResult):
    assert got.language == want.language
    assert got.n_tokens == want.n_tokens
    assert got.full_text == want.full_text
    assert [s.to_dict() for s in got.segments] == [s.to_dict() for s in want.segments]


@pytest.mark.parametrize("language", ["en", None])
def test_batched_transcribe_matches_jax(engines, speech, language):
    jeng, teng = engines
    params = AsrParams(language=language)
    jb, tb = JBatched(jeng, max_batch=2, max_wait_ms=1.0), TBatched(teng, max_batch=2,
                                                                    max_wait_ms=1.0)
    try:
        want = jb.transcribe(speech, params)
        got = tb.transcribe(speech, params)
    finally:
        jb.stop()
        tb.stop()
    _compare(want, got)
    assert got.n_tokens > 0 and got.segments
    # 40 s: the seek loop decoded at least two windows through the batcher
    assert tb.windows_run == jb.windows_run >= 2


def test_detect_language_matches_jax(engines, speech):
    jeng, teng = engines
    for seg in (speech[:16000 * 30], speech[16000 * 10: 16000 * 17]):
        assert teng.detect_language(seg) == jeng.detect_language(seg)


def test_transcribe_with_state_keeps_language(engines, speech):
    _, teng = engines
    state = teng.create_state()
    res = teng.transcribe_with_state(state, speech[:16000 * 8], AsrParams())
    assert state.language == res.language is not None


def test_fallback_ladder_structure_matches_jax(np_params, speech):
    jeng, teng = _engines(np_params, **ALWAYS_FALLBACK)
    mels = np.concatenate([np.asarray(jeng.compute_mel(speech[:16000 * 5])),
                           np.asarray(jeng.compute_mel(speech[16000 * 5:16000 * 12]))])
    counts = []
    # each package counts in its own metrics registry
    for eng, metrics in ((jeng, JMETRICS), (teng, TMETRICS)):
        before = metrics.snapshot()["counters"].get("asr_fallback_retries_total", 0.0)
        res = eng.decode_windows(mels, "en")
        after = metrics.snapshot()["counters"]["asr_fallback_retries_total"]
        counts.append((after - before, [r["temperature"] for r in res]))
    # 2 rows x 5 retries each, ending at the top of the ladder
    assert counts[0] == counts[1] == (10.0, [1.0, 1.0])


def test_empty_audio_and_not_ported_options(engines, speech, np_params):
    jeng, teng = engines
    assert teng.transcribe(np.zeros(0, np.float32), AsrParams()).full_text == ""
    # a sub-bucket stream chunk without a pool takes the window path, with
    # the JAX engine's result
    params = AsrParams(language="en", stream_mode=True)
    chunk = speech[:16000 * 3]
    got = teng.transcribe_with_state(teng.create_state(), chunk, params)
    want = jeng.transcribe_with_state(jeng.create_state(), chunk, params)
    _compare(want, got)
    assert got.n_tokens > 0 and len(got.segments) <= 1
    # word timestamps now run (held against JAX in
    # test_word_timestamps_match_jax): the same chunk as a long-form call
    # gives the segments it gives without them, each with its list of words
    # (empty here: the synthetic vocab makes the window one word, which
    # starts at the path's first frame, before the first segment)
    plain = teng.transcribe(chunk, AsrParams(language="en"))
    got = teng.transcribe(chunk, AsrParams(language="en", word_timestamps=True))
    assert got.segments and all(s.words is not None for s in got.segments)
    assert [(s.text, s.start, s.end) for s in got.segments] == [
        (s.text, s.start, s.end) for s in plain.segments]
    # beam search and the int8 options now run (held against JAX in
    # test_torch_beam*.py and test_torch_int8.py)
    mel = np.zeros((1, 3000, 80), np.float32)
    beam = teng.decode_windows(mel, "en", beam_size=4, max_new_tokens=4)[0]
    assert beam["temperature"] == 0.0 and beam["n_sampled"] <= 4
    q8 = TEngine.from_jax_params(np_params, TDIMS, teng.tokenizer, device="cpu",
                                 config=EngineConfig(**{**NO_FALLBACK, "cross_kv_int8": True,
                                                        "self_kv_int8": True,
                                                        "weights_int8": True}))
    assert TW.weights_are_int8(q8.model)
    assert q8.decode_windows(mel, "en", max_new_tokens=4)[0]["n_sampled"] <= 4
    # a missing checkpoint raises; there is no fallback to random weights
    with pytest.raises(FileNotFoundError, match="model.bin"):
        TEngine.from_ggml("model.bin")
    for kwargs in (dict(int8_kv=True), dict(beam_size=5)):
        teng.enable_slot_serving(n_slots=2, max_new=4, **kwargs)
        try:
            assert teng._slot_server.submit_audio(np.zeros(16000, np.float32)).result(
                timeout=300)["n_sampled"] <= 4
        finally:
            teng.disable_slot_serving()
        assert teng._slot_server is None


def test_rest_task_processor_runs_on_the_port(engines, speech, tmp_path):
    """The shared TranscribeProcessor (the REST task workers' path) drives the
    port's BatchedEngine end to end, as tests/test_schedule.py drives it with
    the fake engine."""
    from speaksense_tpu.audio.io import write_wav
    from speaksense_tpu.schedule import (
        CallbackType, PathType, TaskConfig, TaskManager, TaskParams, TaskStatus, TaskType,
        TranscribeParams,
    )
    from speaksense_tpu.schedule.processors import TranscribeProcessor
    from speaksense_tpu.storage.sqlite import SqliteTaskStorage

    _, teng = engines
    path = tmp_path / "in.wav"
    write_wav(path, speech[:16000 * 12])
    tb = TBatched(teng, max_batch=2, max_wait_ms=1.0)
    storage = SqliteTaskStorage(tmp_path / "tasks.db")
    try:
        manager = TaskManager(storage)
        manager.register_processor(TranscribeProcessor(tb, audio_dir=str(tmp_path)))
        task = manager.create_task(TaskConfig(
            task_type=TaskType.TRANSCRIBE, input_path=str(path), path_type=PathType.LOCAL,
            callback_type=CallbackType.none(),
            params=TaskParams.transcribe(TranscribeParams(language="en"))))
        claimed = manager.get_next_task()
        manager.complete_task(claimed, manager.process_task(claimed))
        stored = manager.get_task(task.id)
        assert stored.status.kind == TaskStatus.COMPLETED
        direct = teng.transcribe(speech[:16000 * 12], AsrParams(language="en"))
        assert stored.result.result.text == direct.full_text
        assert len(stored.result.result.segments) == len(direct.segments) > 0
    finally:
        tb.stop()
        storage.close()


# a vocab whose pieces start with a space, so that each text token is a
# word (the synthetic vocab has none: one word per window); the
# special-token layout is the synthetic one's, so decoding is unchanged
VOCAB = [b" w%d" % i for i in range(50257)]
VOCAB += [b""] * (DIMS.n_vocab - len(VOCAB))


@pytest.fixture()
def spaced(engines, monkeypatch):
    jeng, teng = engines
    monkeypatch.setattr(jeng, "tokenizer", JTokenizer.from_vocab(VOCAB))
    monkeypatch.setattr(teng, "tokenizer", Tokenizer.from_vocab(VOCAB))
    return jeng, teng


@pytest.fixture(scope="module")
def gapped(speech):
    """Speech, 3 s of silence, speech: two VAD spans of one window each."""
    return np.concatenate([speech[:16000 * 8], np.zeros(16000 * 3, np.float32),
                           speech[16000 * 20:16000 * 26]])


def _words_copied(jeng, monkeypatch):
    """Give each segment of the JAX engine its own copy of its words, as the
    port's `_attach_words` does. Unpatched, the JAX engine shares one dict
    between the segments that hold a word, and `transcribe_audio_vad` then
    shifts that word once per segment (a fault of the reference)."""
    real = jeng._attach_words

    def copying(segs, *args, **kwargs):
        real(segs, *args, **kwargs)
        for s in segs:
            s["words"] = [dict(w) for w in s["words"]]

    monkeypatch.setattr(jeng, "_attach_words", copying)


@pytest.mark.parametrize("entry", ["transcribe", "transcribe_audio_vad"])
def test_word_timestamps_match_jax(spaced, gapped, entry, monkeypatch):
    """Long-form transcription with word timestamps, and VAD-segmented
    (the language detected on the first span and kept for the second):
    the JAX engine's segments, texts and word times, exactly, once the
    reference shifts each word once (`_words_copied`)."""
    from speaksense_tpu_torch.audio.vad import speech_segments

    jeng, teng = spaced
    params = AsrParams(language="en" if entry == "transcribe" else None,
                       word_timestamps=True)
    got = getattr(teng, entry)(gapped, params)
    if entry == "transcribe_audio_vad":
        # the reference's fault shows here: a word shared by segments of
        # the second span is shifted by that span's offset more than once
        faulty = jeng.transcribe_audio_vad(gapped, params)
        assert max(w["end"] for s in faulty.segments for w in s.words) > gapped.size / 16000
    _words_copied(jeng, monkeypatch)
    want = getattr(jeng, entry)(gapped, params)
    _compare(want, got)
    assert all(s.words is not None for s in got.segments)
    words = [w for s in got.segments for w in s.words]
    assert len(words) >= 4
    assert all(0.0 <= w["start"] <= w["end"] <= gapped.size / 16000 for w in words)
    if entry == "transcribe_audio_vad":
        spans = [(a / 16000, b / 16000) for a, b in speech_segments(gapped)]
        assert len(spans) == 2
        for s in got.segments:
            lo, hi = next(span for span in spans if span[0] <= s.start <= span[1])
            assert all(lo <= w["start"] <= w["end"] <= hi + 1e-6 for w in s.words)
        assert {s.start < spans[1][0] for s in got.segments} == {True, False}
        silence = np.zeros(16000 * 2, np.float32)
        empty = teng.transcribe_audio_vad(silence, AsrParams(language="de"))
        assert (empty.segments, empty.full_text, empty.language) == ([], "", "de")


def test_rest_task_processor_vad_and_emotion_match_jax(engines, gapped, tmp_path):
    """The shared TranscribeProcessor with VAD segmentation and emotion
    labels: the JAX engine and the port's window batcher give the same
    stored task result (texts, times, emotion labels, token count)."""
    from speaksense_tpu.audio.io import write_wav
    from speaksense_tpu.schedule import (
        CallbackType, PathType, TaskConfig, TaskManager, TaskParams, TaskStatus, TaskType,
        TranscribeParams,
    )
    from speaksense_tpu.schedule.processors import TranscribeProcessor
    from speaksense_tpu.storage.sqlite import SqliteTaskStorage

    jeng, teng = engines
    path = tmp_path / "in.wav"
    write_wav(path, gapped)
    tb = TBatched(teng, max_batch=2, max_wait_ms=1.0)
    results = []
    try:
        for i, eng in enumerate((jeng, tb)):
            storage = SqliteTaskStorage(tmp_path / f"tasks{i}.db")
            try:
                manager = TaskManager(storage)
                manager.register_processor(TranscribeProcessor(
                    eng, audio_dir=str(tmp_path), vad_segmentation=True))
                task = manager.create_task(TaskConfig(
                    task_type=TaskType.TRANSCRIBE, input_path=str(path),
                    path_type=PathType.LOCAL, callback_type=CallbackType.none(),
                    params=TaskParams.transcribe(TranscribeParams(
                        language="en", emotion_recognition=True))))
                claimed = manager.get_next_task()
                manager.complete_task(claimed, manager.process_task(claimed))
                stored = manager.get_task(task.id)
                assert stored.status.kind == TaskStatus.COMPLETED
                results.append(stored.result.result)
            finally:
                storage.close()
    finally:
        tb.stop()
    want, got = results
    assert tb.windows_run == 2
    assert got.text == want.text and got.n_tokens == want.n_tokens > 0
    assert [s.__dict__ for s in got.segments] == [s.__dict__ for s in want.segments]
    assert any(s.emotion for s in got.segments)


def test_build_engine_composes_a_batched_random_engine():
    config = Config()
    # bf16 on the CPU is slow: a short token budget and no fallback retries
    config.engine = EngineConfig(max_decode_len=16, max_batch_size=2, logprob_thold=-1e9,
                                 entropy_thold=-1.0, compression_ratio_thold=1e9)
    eng = TMAIN.build_engine(config, model="tiny", device="cpu", seed=1)
    try:
        assert isinstance(eng, TBatched) and eng.max_batch == 2
        assert eng.engine.model.dtype == torch.bfloat16
        assert eng.engine.dims == TW.MODEL_DIMS["tiny"]
        res = eng.transcribe(np.zeros(16000 * 2, np.float32), AsrParams(language="en"))
        assert isinstance(res, TResult) and eng.windows_run == 1
    finally:
        eng.stop()


def _write_tiny_ggml(path, ftype=TG.F16, seed=2):
    """A tiny whisper ggml checkpoint of DIMS from seeded weights, with the
    real 80-bin mel filterbank and a vocab of 50,257 text pieces (the
    loader pads the rest)."""
    tensors = TG.ggml_tensors_from_params(JW.init_params_np(DIMS, seed=seed), TDIMS)
    vocab = [b" w%d" % i for i in range(50257)]
    TG.write_ggml(TG.GgmlModel(dims=TDIMS, ftype=ftype, filters=TMEL.mel_filter_bank(80),
                               vocab=vocab, tensors=tensors), str(path), ftype=ftype)


_POOLED_SESSION = """
import base64, importlib, pkgutil, sys
from pathlib import Path
import numpy as np
import speaksense_tpu_torch

# every module of the port, the CLI, the loaders and the session included
names = [m.name for m in pkgutil.walk_packages(speaksense_tpu_torch.__path__,
                                               "speaksense_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert {"speaksense_tpu_torch.cli", "speaksense_tpu_torch.ckpt.ggml",
        "speaksense_tpu_torch.ckpt.cache", "speaksense_tpu_torch.ckpt.hf_dir",
        "speaksense_tpu_torch.serving.stream", "speaksense_tpu_torch.models.beam",
        "speaksense_tpu_torch.runtime.beam_slots",
        "speaksense_tpu_torch.tools.microbench_encattn", "speaksense_tpu_torch.models.align",
        "speaksense_tpu_torch.audio.vad", "speaksense_tpu_torch.audio.quality",
        "speaksense_tpu_torch.audio.emotion", "speaksense_tpu_torch.audio.voiceprint",
        "speaksense_tpu_torch.audio.stream", "speaksense_tpu_torch.asr.fake",
        "speaksense_tpu_torch.auth.service", "speaksense_tpu_torch.auth.ratelimit",
        "speaksense_tpu_torch.storage.sqlite", "speaksense_tpu_torch.schedule.manager",
        "speaksense_tpu_torch.schedule.scheduler", "speaksense_tpu_torch.schedule.processors",
        "speaksense_tpu_torch.schedule.callback", "speaksense_tpu_torch.serving.rest",
        "speaksense_tpu_torch.serving.grpc_server", "speaksense_tpu_torch.serving.pb.asr_pb2",
        "speaksense_tpu_torch.registry.etcd", "speaksense_tpu_torch.utils.http",
        "speaksense_tpu_torch.utils.timeutil",
        "speaksense_tpu_torch.utils.logging", "speaksense_tpu_torch.parallel.mesh",
        "speaksense_tpu_torch.parallel.multihost", "speaksense_tpu_torch.parallel.workers",
        "speaksense_tpu_torch.native.build", "speaksense_tpu_torch.native.loader",
        "speaksense_tpu_torch.tools.bench", "speaksense_tpu_torch.tools.measure",
        "speaksense_tpu_torch.tools.microbench_slots",
        "speaksense_tpu_torch.tools.microbench_decode", "speaksense_tpu_torch.tools.probe_slots",
        "speaksense_tpu_torch.tools.wer_check",
        "speaksense_tpu_torch.tools.golden"} <= set(names), names

from speaksense_tpu_torch.asr import AsrParams

from speaksense_tpu_torch.config import Config, EngineConfig
from speaksense_tpu_torch.main import build_engine
from speaksense_tpu_torch.serving.stream import StreamSession

config = Config(model_path=sys.argv[1])
config.engine = EngineConfig(compute_dtype="float32", logprob_thold=-1e9,
                             entropy_thold=-1.0, compression_ratio_thold=1e9,
                             max_decode_len=16, weight_cache_dir=sys.argv[2])
eng = build_engine(config, device="cpu", slot_serving=True, slots=2, slot_tokens=4)
try:
    assert eng.engine.name == sys.argv[1] and eng.engine.dims.n_audio_state == 128
    session = StreamSession(eng, language="en", denoise=True)
    pcm = (np.random.default_rng(0).standard_normal(16000 * 6) * 3000).astype(np.int16)
    pendings = []
    for i in range(0, pcm.size, 16000):
        pendings += session.ingest(base64.standard_b64encode(pcm[i:i + 16000].tobytes()))
    for p in pendings:
        session.settle(p)
    events = session.finish()
    assert events[-1].end == 1, events
    # VAD segmentation and word timestamps through the window batcher
    gapped = np.concatenate([pcm[:16000 * 2], np.zeros(16000 * 2, np.int16),
                             pcm[16000 * 2:16000 * 3]]).astype(np.float32) / 32768
    res = eng.transcribe_audio_vad(gapped, AsrParams(language="en", word_timestamps=True))
    assert res.segments and all(s.words is not None for s in res.segments), res
    assert eng.engine._slot_server.pool.admit_rows == 2
    # the same session through a beam pool with int8 self pages
    eng.engine.disable_slot_serving()
    eng.engine.enable_slot_serving(n_slots=2, max_new=4, beam_size=2)
    assert type(eng.engine._slot_server.pool).__name__ == "BeamSlotPool"
    session = StreamSession(eng, language="en", denoise=True)
    for p in session.ingest(base64.standard_b64encode(pcm[:16000 * 6].tobytes())):
        session.settle(p)
    assert session.finish()[-1].end == 1
finally:
    eng.engine.disable_slot_serving()
    eng.stop()
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "speaksense_tpu"))
assert not leaked, leaked
jax_package = (Path(speaksense_tpu_torch.__file__).resolve().parent.parent
               / "speaksense_tpu")
read = sorted(str(m.__file__) for m in list(sys.modules.values())
              if getattr(m, "__file__", None)
              and Path(m.__file__).resolve().is_relative_to(jax_package))
assert not read, read
print("ok")
"""


def test_port_imports_no_jax(tmp_path):
    """Every module of the port imports, the beam search, beam pool,
    alignment and host-DSP modules, the serving stack (task queue, stores,
    auth, REST, gRPC, registry), multi-GPU serving (`parallel/`), the
    native dequant (`native/`) and the measurement tools (`tools/`)
    included, and a ggml checkpoint loads
    through `build_engine(config)` and serves a pooled StreamSession with
    device denoise end to end (ingest, settle, finish), a VAD-segmented
    call with word timestamps, then the session through a beam pool,
    without importing jax or anything of the JAX package, by name or by
    file."""
    ckpt = tmp_path / "tiny.bin"
    _write_tiny_ggml(ckpt)
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", _POOLED_SESSION, str(ckpt),
                          str(tmp_path / "cache")], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
    assert (tmp_path / "cache" / "tiny.cache.npz").is_file()


def test_profile_trace_writes_a_trace(engines, tmp_path):
    """`WhisperEngine.profile_trace(log_dir)`, the JAX engine's: a
    torch.profiler trace of the calls inside, written to log_dir."""
    _, teng = engines
    with teng.profile_trace(str(tmp_path / "trace")):
        teng.detect_language(np.zeros(16000, np.float32))
    traces = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(traces) == 1
    import json

    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("detect_language" in e.get("name", "") or "aten::" in e.get("name", "")
               for e in events)
