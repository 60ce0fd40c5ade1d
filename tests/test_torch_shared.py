"""The port stands alone: its own copies of the JAX package's jax-free
modules (config, the AsrEngine types, postprocess, metrics, tokenizer, the
numpy DSP, StreamSession and its helpers, audio file input) against the
originals on the same inputs, and the port's StreamSession over the port's
engine against the JAX session over the JAX engine."""

import base64
import dataclasses
import wave

import numpy as np
import pytest
import torch

from speaksense_tpu import config as JC
from speaksense_tpu.asr import postprocess as JPP
from speaksense_tpu.asr.engine import WhisperEngine as JEngine
from speaksense_tpu.audio import dsp as JDSP
from speaksense_tpu.audio import io as JIO
from speaksense_tpu.models import whisper as JW
from speaksense_tpu.models.tokenizer import Tokenizer as JTokenizer
from speaksense_tpu.serving import stream as JS
from speaksense_tpu.utils import metrics as JM
from speaksense_tpu_torch import config as TC
from speaksense_tpu_torch.asr import AsrParams, TranscribeResult, TranscribeSegment
from speaksense_tpu_torch.asr import postprocess as TPP
from speaksense_tpu_torch.asr.engine import WhisperEngine as TEngine
from speaksense_tpu_torch.audio import dsp as TDSP
from speaksense_tpu_torch.audio import io as TIO
from speaksense_tpu_torch.models import whisper as TW
from speaksense_tpu_torch.models.tokenizer import Tokenizer
from speaksense_tpu_torch.serving import stream as TS
from speaksense_tpu_torch.utils import metrics as TM


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU ops: the parallel test run
    puts several workers on the cores, and torch's thread pool then spins
    against them, slowing these small ops tenfold or more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_config_copies_match_jax(monkeypatch, tmp_path):
    assert dataclasses.asdict(TC.EngineConfig()) == dataclasses.asdict(JC.EngineConfig())
    assert dataclasses.asdict(TC.Config()) == dataclasses.asdict(JC.Config())
    assert TC.DEFAULT_MODEL_PATH == JC.DEFAULT_MODEL_PATH == "./models/ggml-large-v3.bin"
    monkeypatch.chdir(tmp_path)
    (tmp_path / ".env").write_text('ASR_AUDIO_PATH="./audio-from-dotenv/"\n')
    monkeypatch.setenv("ASR_MODEL_PATH", str(tmp_path / "m.bin"))
    monkeypatch.setenv("SPEAKSENSE_GRPC_AUTH", "Optional")
    t, j = TC.Config.from_env(), JC.Config.from_env()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.model_path == str(tmp_path / "m.bin") and t.audio_path == "./audio-from-dotenv/"
    assert t.sqlite_file == j.sqlite_file
    t.init_dirs()
    assert (tmp_path / "audio-from-dotenv").is_dir()
    assert (tmp_path / "asr_data" / "weights_cache").is_dir()
    monkeypatch.setenv("SPEAKSENSE_GRPC_AUTH", "on")
    with pytest.raises(ValueError, match="GRPC_AUTH"):
        TC.Config.from_env()


def test_asr_types_match_jax():
    from speaksense_tpu import asr as JA

    assert dataclasses.asdict(AsrParams()) == dataclasses.asdict(JA.AsrParams())
    seg = dict(text="hi", speaker_id=1, start=0.5, end=1.0, words=[{"word": "hi"}])
    r = TranscribeResult(segments=[TranscribeSegment(**seg)], full_text="hi", language="en")
    jr = JA.TranscribeResult(segments=[JA.TranscribeSegment(**seg)], full_text="hi",
                             language="en")
    assert r.to_dict() == jr.to_dict()


TEXTS = ["", "hello world", "你好吗", "真是太好了", "好的。", "请不吝点赞 订阅",
         "what the fuck is this shit", "他妈的混蛋", "aaaa aaaa aaaa aaaa aaaa aaaa"]


@pytest.mark.parametrize("text", TEXTS)
def test_postprocess_matches_jax(text, monkeypatch):
    monkeypatch.setenv("SPEAKSENSE_DIRTY_WORDS", "world,太好")
    assert TPP.is_promotional_text(text) == JPP.is_promotional_text(text)
    if text:
        assert TPP.add_punctuation(text) == JPP.add_punctuation(text)
    assert TPP.compression_ratio(text) == JPP.compression_ratio(text)
    toks = [ord(c) % 7 for c in text] * 5
    assert TPP.token_entropy(toks) == JPP.token_entropy(toks)
    assert TPP.filter_dirty_words(text) == JPP.filter_dirty_words(text)


def _bpe_vocab() -> list[bytes]:
    """Single bytes, then merges in priority order, padded to the
    multilingual size: a vocab whose id order is its merge order."""
    merges = [b"th", b"he", b"the", b" the", b"in", b"ing", b" s", b"ll", b"llo",
              b"hello", b" w", b" wor", b"ld", b" world", b" -", b" [", b"\xe4\xbd"]
    vocab = [bytes([i]) for i in range(256)] + merges + [b" "]
    return vocab + [b"<%d>" % i for i in range(len(vocab), 50257)] + [b""] * (51866 - 50257)


@pytest.mark.parametrize("vocab", ["synthetic", "bpe"])
def test_tokenizer_matches_jax(vocab):
    if vocab == "synthetic":
        t, j = Tokenizer.synthetic(51865), JTokenizer.synthetic(51865)
    else:
        t, j = Tokenizer.from_vocab(_bpe_vocab()), JTokenizer.from_vocab(_bpe_vocab())
    fields = [f.name for f in dataclasses.fields(JTokenizer) if f.name != "vocab"]
    assert [getattr(t, f) for f in fields] == [getattr(j, f) for f in fields]
    for text in ("hello world", "the thing is singing", "你好 [x] - ok", ""):
        ids = t.encode_text(text)
        assert ids == j.encode_text(text)
        assert t.decode(ids) == j.decode(ids)
    ids = list(range(0, 51865, 97))
    assert t.decode(ids, skip_special=False) == j.decode(ids, skip_special=False)
    assert t.decode_bytes(ids) == j.decode_bytes(ids)
    for lang, task, ts in (("en", "transcribe", True), ("zh", "translate", False)):
        assert t.sot_sequence(lang, task, ts) == j.sot_sequence(lang, task, ts)
    for sns in (True, False):
        for turn in (True, False):
            np.testing.assert_array_equal(t.suppress_mask(sns, turn), j.suppress_mask(sns, turn))
    assert t.non_speech_tokens() == j.non_speech_tokens()
    assert t.blank_token() == j.blank_token()


@pytest.fixture(scope="module")
def noisy():
    """Three seeded signals the noise classifier sorts differently."""
    rng = np.random.default_rng(3)
    t = np.arange(16000 * 3) / 16000
    tone = 0.2 * np.sin(2 * np.pi * 220 * t) + 0.01 * rng.standard_normal(t.size)
    bursts = rng.standard_normal(t.size) * (np.sin(2 * np.pi * 1.5 * t) > 0.6)
    return [tone.astype(np.float32), bursts.astype(np.float32),
            (0.2 * bursts).astype(np.float32)]


def test_numpy_dsp_matches_jax(noisy):
    for x in noisy:
        assert TDSP.classify_noise(x) == JDSP.classify_noise(x)
        for cfg in (TDSP.DenoiseConfig(), TDSP.DenoiseConfig(post_gain=1.0, strength=0.5)):
            jcfg = JDSP.DenoiseConfig(**dataclasses.asdict(cfg))
            np.testing.assert_array_equal(TDSP.denoise_audio(x, cfg), JDSP.denoise_audio(x, jcfg))
        np.testing.assert_array_equal(TDSP.preemphasis(x), JDSP.preemphasis(x))
        np.testing.assert_array_equal(TDSP.normalize_audio(x), JDSP.normalize_audio(x))
        np.testing.assert_array_equal(TDSP.apply_noise_gate(x, 0.003),
                                      JDSP.apply_noise_gate(x, 0.003))
        assert TDSP.estimate_noise_floor(x) == JDSP.estimate_noise_floor(x)
        np.testing.assert_array_equal(TDSP.convert_to_mono(x, 2), JDSP.convert_to_mono(x, 2))
    assert {TDSP.classify_noise(x) for x in noisy} == {"spectral", "wiener", "mixed"}
    np.testing.assert_array_equal(TDSP._hann(2048), JDSP._hann(2048))


def test_stream_helpers_match_jax():
    segs = [TranscribeSegment(text="world")]
    jsegs = [JS.TranscribeSegment(text="world")]
    for new, last in (("hello world", "hello"), ("a. b. c.", "a. b."), ("x", ""),
                      ("same", "same"), ("hello", "hello world and more")):
        assert TS.process_text(new, last, segs) == JS.process_text(new, last, jsegs)
        assert TS.process_text(new, last, []) == JS.process_text(new, last, [])
    data = np.random.default_rng(1).integers(-32768, 32767, 1001).astype("<i2").tobytes()
    np.testing.assert_array_equal(TS.pcm16le_to_f32(data + b"\x01"),
                                  JS.pcm16le_to_f32(data + b"\x01"))
    tc, jc = TS.StreamContext(5.0), JS.StreamContext(5.0)
    for start, end in ((0.0, 1.2), (0.5, 2.0), (3.0, 4.0)):
        assert tc.calculate_segment_time(start, end) == jc.calculate_segment_time(start, end)
        tc.next_block()
        jc.next_block()
    header = (b"RIFF" + (36).to_bytes(4, "little") + b"WAVEfmt " + (16).to_bytes(4, "little")
              + (1).to_bytes(2, "little") + (1).to_bytes(2, "little")
              + (16000).to_bytes(4, "little") + (32000).to_bytes(4, "little")
              + (2).to_bytes(2, "little") + (16).to_bytes(2, "little")
              + b"data" + (4).to_bytes(4, "little") + b"\x01\x02\x03\x04")
    assert TS._strip_wav_header(header) == JS._strip_wav_header(header) == b"\x01\x02\x03\x04"
    with pytest.raises(TS.UnsupportedStreamFormat):
        TS._strip_wav_header(header.replace((16000).to_bytes(4, "little"),
                                            (8000).to_bytes(4, "little"), 1))


def test_metrics_registry_is_the_ports_own():
    assert TM.REGISTRY is not JM.REGISTRY
    t, j = TM.Registry(), JM.Registry()
    for reg in (t, j):
        reg.inc("asr_windows_total", 3)
        reg.set_gauge("asr_batch_occupancy", 0.5)
        for s in (0.004, 0.3, 12.0):
            reg.observe("asr_decode_window_seconds", s)
    assert t.snapshot() == j.snapshot()
    assert t.render_prometheus() == j.render_prometheus()


def _write_wav_raw(path, pcm: np.ndarray, rate: int, channels: int, width: int):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


def test_audio_file_input_matches_jax(tmp_path):
    """load_audio on 16 kHz mono (exactly the JAX result) and on 44.1 kHz
    stereo 8-bit and 16-bit (the port's numpy polyphase resampler against
    scipy's, within a few f32 ulps)."""
    rng = np.random.default_rng(5)
    mono = (rng.standard_normal(16000) * 3000).astype("<i2")
    stereo = (rng.standard_normal(44100 * 2) * 3000).astype("<i2")
    stereo8 = rng.integers(0, 256, 44100 * 2).astype(np.uint8)
    _write_wav_raw(tmp_path / "m.wav", mono, 16000, 1, 2)
    _write_wav_raw(tmp_path / "s.wav", stereo, 44100, 2, 2)
    _write_wav_raw(tmp_path / "s8.wav", stereo8, 44100, 2, 1)
    np.testing.assert_array_equal(TIO.load_audio(tmp_path / "m.wav"),
                                  JIO.load_audio(tmp_path / "m.wav"))
    for name in ("s.wav", "s8.wav"):
        x, ch, rate = TIO.read_wav(tmp_path / name)
        jx, jch, jrate = JIO.read_wav(tmp_path / name)
        np.testing.assert_array_equal(x, jx)
        assert (ch, rate) == (jch, jrate) == (2, 44100)
        got, want = TIO.load_audio(tmp_path / name), JIO.load_audio(tmp_path / name)
        assert got.shape == want.shape == (16000,)
        # f32 ulps of O(0.1) samples: scipy filters in float32, the port in
        # float64 before its rounding
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    TIO.write_wav(tmp_path / "w.wav", mono.astype(np.float32) / 32768.0)
    JIO.write_wav(tmp_path / "j.wav", mono.astype(np.float32) / 32768.0)
    assert (tmp_path / "w.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    # non-WAV input goes through ffmpeg; without it, or on a failed
    # conversion, the load raises
    with pytest.raises(TIO.FfmpegError):
        TIO.load_audio(tmp_path / "missing.mp3")


DIMS = JW.WhisperDims(n_mels=80, n_vocab=51865, n_audio_ctx=1500, n_audio_state=64,
                      n_audio_head=4, n_audio_layer=2, n_text_ctx=448, n_text_state=64,
                      n_text_head=4, n_text_layer=2)
NEVER = dict(compute_dtype="float32", max_decode_len=64, compression_ratio_thold=1e9,
             logprob_thold=-1e9, entropy_thold=-1.0)


def test_stream_session_window_path_matches_jax():
    """Without a slot pool each chunk takes the window path and the session
    denoises on the host: the port's StreamSession over the port's engine
    (its own numpy denoise) gives the JAX session's events over the JAX
    engine, on the same tiny weights."""
    np_params = JW.init_params_np(DIMS, seed=0)
    jeng = JEngine(np_params, DIMS, JTokenizer.synthetic(DIMS.n_vocab),
                   config=JC.EngineConfig(**NEVER))
    teng = TEngine.from_jax_params(np_params, TW.WhisperDims(**dataclasses.asdict(DIMS)),
                                   Tokenizer.synthetic(DIMS.n_vocab),
                                   config=TC.EngineConfig(**NEVER), device="cpu")
    assert not teng.device_denoise
    rng = np.random.default_rng(9)
    t = np.arange(16000 * 10) / 16000
    pcm = ((0.2 * np.sin(2 * np.pi * 180 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t) ** 2)
            + 0.02 * rng.standard_normal(t.size)) * 32767).astype(np.int16)
    out = []
    for session in (JS.StreamSession(jeng, language="en", denoise=True),
                    TS.StreamSession(teng, language="en", denoise=True)):
        events = []
        for i in range(0, pcm.size, 16000):
            events += session.feed(base64.standard_b64encode(pcm[i:i + 16000].tobytes()))
        events += session.finish()
        out.append(([dataclasses.asdict(e) for e in events], session.usage_tokens,
                    session.usage_audio_seconds))
    assert out[0] == out[1]
    assert out[1][0][-1]["end"] == 1 and out[1][1] > 0
