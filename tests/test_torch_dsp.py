"""The port's device denoise (speaksense_tpu_torch.audio.dsp) and admission
audio against the JAX package's `denoise_audio_jax` and log-mel, on the
CPU."""

import numpy as np
import pytest
import torch

from speaksense_tpu.audio import dsp as JDSP
from speaksense_tpu.audio import mel as JMEL
from speaksense_tpu.serving.stream import pcm_i16_to_f32
from speaksense_tpu_torch.audio import dsp as TDSP
from speaksense_tpu_torch.audio import mel as TMEL

# f32 on both sides; the FFTs (pocketfft here, ducc in XLA) sum in different
# orders, so the outputs of O(0.1) audio agree to a few f32 ulps (measured
# worst 9e-8)
DENOISE_ATOL = 1e-6


@pytest.fixture(scope="module")
def audio():
    """Two 5.12 s rows: a voiced tone under an envelope plus light noise,
    and white noise, so the classifier picks different branches."""
    rng = np.random.default_rng(7)
    t = np.arange(512 * 160) / 16000
    voiced = 0.2 * np.sin(2 * np.pi * 200 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t) ** 2)
    return np.stack([voiced + 0.02 * rng.standard_normal(t.size),
                     0.1 * rng.standard_normal(t.size)]).astype(np.float32)


@pytest.mark.parametrize("branch", TDSP.BRANCHES)
def test_denoise_branch_matches_jax(audio, branch):
    cfg = TDSP.DenoiseConfig(post_gain=1.0)
    want = np.asarray(JDSP.denoise_audio_jax(audio, JDSP.DenoiseConfig(post_gain=1.0),
                                             branch=branch))
    got = TDSP.denoise_audio_torch(torch.from_numpy(audio), cfg, branch=branch).numpy()
    assert got.shape == want.shape == audio.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=DENOISE_ATOL)
    one = TDSP.denoise_audio_torch(torch.from_numpy(audio[1]), cfg, branch=branch).numpy()
    np.testing.assert_allclose(one, got[1], rtol=0, atol=DENOISE_ATOL)


def test_denoise_short_input_and_bad_branch():
    x = torch.ones(2, 1000)
    assert torch.equal(TDSP.denoise_audio_torch(x, branch="wiener"), x)
    with pytest.raises(ValueError, match="branch"):
        TDSP.denoise_audio_torch(x, branch=None)


def test_classifier_is_the_shared_numpy_one(audio):
    assert [TDSP.classify_noise(r) for r in audio] == [JDSP.classify_noise(r) for r in audio]


def test_s16_admission_audio_matches_host_dequant_and_jax_mel(audio):
    """s16 PCM dequantized on the device equals the shared host dequant,
    and its log-mel at the pool's 512 frames matches the JAX log-mel."""
    pcm = np.clip(audio * 20000, -32768, 32767).astype(np.int16)
    f32 = TMEL.pcm_to_f32(torch.from_numpy(pcm)).numpy()
    np.testing.assert_array_equal(f32, pcm_i16_to_f32(pcm))
    got = TMEL.log_mel_spectrogram(torch.from_numpy(f32), n_mels=80, pad_to_chunk=False).numpy()
    want = np.asarray(JMEL.log_mel_spectrogram(f32, n_mels=80, pad_to_chunk=False))
    assert got.shape == want.shape == (2, 512, 80)
    # the two-tier mel bound of tests/test_torch_mel.py
    err = np.abs(got - want)
    assert err.max() < 1e-4 and (err > 1e-5).mean() < 1e-3
