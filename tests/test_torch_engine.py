"""The port's window-transcription slice as a whole, against the JAX package
on shared tiny weights (both in float32 on the CPU): the window batcher's
`transcribe`, language detection, the temperature-fallback ladder, the REST
task processor driving the port, and the port's import boundary (no jax and
nothing of the JAX package)."""

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


def test_empty_audio_and_not_ported_options(engines, speech):
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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        teng.transcribe(np.zeros(16000, np.float32), AsrParams(word_timestamps=True))
    with pytest.raises(NotImplementedError, match="beam"):
        teng.decode_windows(np.zeros((1, 3000, 80), np.float32), "en", beam_size=4)
    with pytest.raises(NotImplementedError, match="int8"):
        TEngine(teng.model, teng.tokenizer, config=EngineConfig(cross_kv_int8=True))
    # a missing checkpoint raises; there is no fallback to random weights
    with pytest.raises(FileNotFoundError, match="model.bin"):
        TEngine.from_ggml("model.bin")
    for kwargs, match in ((dict(int8_kv=True), "int8"), (dict(beam_size=5), "beam")):
        with pytest.raises(NotImplementedError, match=match):
            teng.enable_slot_serving(n_slots=2, **kwargs)
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
        "speaksense_tpu_torch.serving.stream"} <= set(names), names

from speaksense_tpu_torch.config import Config, EngineConfig
from speaksense_tpu_torch.main import build_engine
from speaksense_tpu_torch.serving.stream import StreamSession

config = Config(model_path=sys.argv[1])
config.engine = EngineConfig(compute_dtype="float32", logprob_thold=-1e9,
                             entropy_thold=-1.0, compression_ratio_thold=1e9,
                             weight_cache_dir=sys.argv[2])
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
    assert eng.engine._slot_server.pool.admit_rows == 2
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
    """Every module of the port imports, and a ggml checkpoint loads through
    `build_engine(config)` and serves a pooled StreamSession with device
    denoise end to end (ingest, settle, finish), without importing jax or
    anything of the JAX package, by name or by file."""
    ckpt = tmp_path / "tiny.bin"
    _write_tiny_ggml(ckpt)
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", _POOLED_SESSION, str(ckpt),
                          str(tmp_path / "cache")], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
    assert (tmp_path / "cache" / "tiny.cache.npz").is_file()
