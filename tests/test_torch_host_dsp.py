"""The port's host-DSP copies against the JAX package's originals, on the
CPU: VAD (`audio/vad.py`), quality (`audio/quality.py`), emotion
(`audio/emotion.py`), voiceprint (`audio/voiceprint.py`, over the port's
mel filterbank), the stream processor (`audio/stream.py`), the chunk
resampler and the streaming file parser (`audio/resample.py`,
`audio/io.py`)."""

import wave

import numpy as np
import pytest

from speaksense_tpu.audio import emotion as JEMO
from speaksense_tpu.audio import io as JIO
from speaksense_tpu.audio import mel as JMEL
from speaksense_tpu.audio import quality as JQ
from speaksense_tpu.audio import resample as JRS
from speaksense_tpu.audio import stream as JST
from speaksense_tpu.audio import vad as JVAD
from speaksense_tpu.audio import voiceprint as JVP
from speaksense_tpu.audio.dsp import DenoiseConfig as JDenoiseConfig
from speaksense_tpu_torch.audio import emotion as TEMO
from speaksense_tpu_torch.audio import io as TIO
from speaksense_tpu_torch.audio import mel as TMEL
from speaksense_tpu_torch.audio import quality as TQ
from speaksense_tpu_torch.audio import resample as TRS
from speaksense_tpu_torch.audio import stream as TST
from speaksense_tpu_torch.audio import vad as TVAD
from speaksense_tpu_torch.audio import voiceprint as TVP
from speaksense_tpu_torch.audio.dsp import DenoiseConfig

# The copies run the same numpy code as the originals, so quality,
# emotion and voiceprint results are held equal, not within a tolerance.
# The port's polyphase resampler sums in float64, scipy's in float32: a few
# f32 ulps of O(0.1) samples (measured worst 1.5e-7 through the chunk
# resampler) ...
RESAMPLED_ATOL = 1e-6
# ... which the stream DSP after it (per-chunk normalization, gain, spectral
# denoise) scales up (measured worst 7.7e-7 through the file parser)
PARSED_ATOL = 5e-6


def _speech(seconds: float, seed: int, f0: float = 140.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000
    f = f0 + 30 * np.sin(2 * np.pi * 0.3 * t)
    voiced = sum(np.sin(2 * np.pi * k * np.cumsum(f) / 16000) / k for k in range(1, 6))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 4 * t) ** 2
    return (0.2 * voiced * env + 0.02 * rng.standard_normal(t.size)).astype(np.float32)


@pytest.fixture(scope="module")
def gapped():
    """Speech, 3 s of silence, speech, 1.5 s of faint noise, speech."""
    rng = np.random.default_rng(2)
    return np.concatenate([_speech(4, 0), np.zeros(16000 * 3, np.float32), _speech(2.5, 1),
                           (1e-4 * rng.standard_normal(24000)).astype(np.float32),
                           _speech(3, 2, f0=230.0)])


def test_vad_matches_jax(gapped):
    spans = TVAD.speech_segments(gapped)
    assert spans == JVAD.speech_segments(gapped)
    assert len(spans) == 3
    assert TVAD.speech_segments(np.zeros(0, np.float32)) == []
    for fn in ("voice_activity_detection", "adaptive_gain"):
        got = getattr(TVAD, fn)(gapped)
        np.testing.assert_array_equal(got, getattr(JVAD, fn)(gapped))
        assert got.dtype == np.float32
    np.testing.assert_array_equal(TVAD.voice_activity_detection(gapped, 256, 0.01),
                                  JVAD.voice_activity_detection(gapped, 256, 0.01))


def test_quality_emotion_voiceprint_match_jax(gapped):
    clips = [gapped, _speech(2, 5, f0=260.0) * 3, 0.01 * _speech(1, 6), np.zeros(0, np.float32)]
    for x in clips:
        assert TQ.evaluate_audio_quality(x).to_dict() == JQ.evaluate_audio_quality(x).to_dict()
        label, feats = TEMO.classify_emotion(x)
        jlabel, jfeats = JEMO.classify_emotion(x)
        assert (label, feats.to_dict()) == (jlabel, jfeats.to_dict())
    labels = {TEMO.classify_emotion(x)[0] for x in clips[:3]}
    assert len(labels) >= 2, labels
    a, b = gapped[:16000 * 4], _speech(3, 7, f0=210.0)
    for x in (a, b):
        np.testing.assert_array_equal(TVP.voiceprint_embedding(x), JVP.voiceprint_embedding(x))
    sim = TVP.cosine_similarity(TVP.voiceprint_embedding(a), TVP.voiceprint_embedding(b))
    want = JVP.cosine_similarity(JVP.voiceprint_embedding(a), JVP.voiceprint_embedding(b))
    assert sim == want < 1.0


@pytest.mark.parametrize("n_mels,n_fft", [(64, 400), (80, 400), (128, 400), (64, 512)])
def test_mel_filter_bank_equal_to_jax(n_mels, n_fft):
    np.testing.assert_array_equal(TMEL.mel_filter_bank(n_mels, n_fft=n_fft),
                                  JMEL.mel_filter_bank(n_mels, n_fft=n_fft))


def test_stream_processor_and_chunk_resampler_match_jax(gapped):
    """StreamAudioProcessor over 16 kHz chunks of uneven sizes (exact), and
    ChunkResampler from 44.1 kHz over the same chunking against the JAX one
    and against the port's own one-shot resample."""
    cuts = np.cumsum(np.random.default_rng(4).integers(300, 6000, 200))
    cuts = cuts[cuts < gapped.size]
    out = []
    for mod, cfg in ((TST, DenoiseConfig()), (JST, JDenoiseConfig())):
        frames = []
        proc = mod.StreamAudioProcessor(cfg, frames.append)
        for chunk in np.split(gapped, cuts):
            proc.process_chunk(chunk)
        proc.finish()
        out.append(np.stack(frames))
    np.testing.assert_array_equal(out[0], out[1])
    assert out[0].shape == (-(-gapped.size // 2048), 2048)

    x = _speech(3, 9)
    x44 = JRS.resample(x, 16000, 44100)
    res = []
    for mod in (TRS, JRS):
        rs = mod.ChunkResampler(44100, 16000)
        pieces = [rs.process(c) for c in np.split(x44, cuts[cuts < x44.size])]
        res.append(np.concatenate(pieces + [rs.finish()]))
    assert res[0].shape == res[1].shape == TRS.resample(x44, 44100, 16000).shape
    np.testing.assert_allclose(res[0], res[1], rtol=0, atol=RESAMPLED_ATOL)
    # away from the stream's start, the chunked output is the one-shot one
    np.testing.assert_allclose(res[0][512:], TRS.resample(x44, 44100, 16000)[512:],
                               rtol=0, atol=RESAMPLED_ATOL)
    same = TRS.ChunkResampler(16000, 16000)
    np.testing.assert_array_equal(same.process(x[:100]), x[:100])
    assert same.finish().size == 0


@pytest.mark.parametrize("rate,channels", [(44100, 2), (16000, 1)])
def test_parse_audio_file_stream_matches_jax(tmp_path, rate, channels):
    rng = np.random.default_rng(rate)
    left = JRS.resample(_speech(4, 3), 16000, rate)
    pcm = np.stack([left, 0.5 * left + 0.01 * rng.standard_normal(left.size)][:channels], 1)
    path = tmp_path / "in.wav"
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((np.clip(pcm, -1, 1) * 32767).astype("<i2").tobytes())
    got, want = [], []
    TIO.parse_audio_file_stream(path, DenoiseConfig(), got.append, chunk_size=3000)
    JIO.parse_audio_file_stream(path, JDenoiseConfig(), want.append, chunk_size=3000)
    assert len(got) == len(want) == -(-16000 * 4 // 2048)
    if rate == 16000:
        np.testing.assert_array_equal(np.stack(got), np.stack(want))
    else:
        np.testing.assert_allclose(np.stack(got), np.stack(want), rtol=0, atol=PARSED_ATOL)
    bad = tmp_path / "s8.wav"
    with wave.open(str(bad), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(1)
        w.setframerate(16000)
        w.writeframes(bytes(100))
    with pytest.raises(TIO.UnsupportedFormatError):
        TIO.parse_audio_file_stream(bad)
