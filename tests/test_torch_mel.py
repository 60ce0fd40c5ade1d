"""Parity of the port's log-mel (speaksense_tpu_torch.audio.mel) with the JAX
reference, both in true f32 on the CPU."""

import numpy as np
import pytest

from speaksense_tpu.audio import mel as JM
from speaksense_tpu_torch.audio import mel as TM

# (x + 4) / 4 of a log10 power: both sides compute the same f32 matmul DFT in
# a different summation order. Almost every feature agrees to a few f32 ulps
# (ATOL). The log10 amplifies the relative rounding of the 400-tap sums at
# mel bins whose power is ~1e-5 of the window's peak: there even a float64
# DFT differs from the JAX f32 result by 1.2e-5, and the two f32 sides by up
# to 7.3e-5. So: every element within WORST_ATOL, and no more than one in
# 10^3 elements outside ATOL (the worst case here, 30 s at 128 mels, has 70
# of 384,000, about 1.8 in 10^4).
ATOL = 1e-5
WORST_ATOL = 1e-4
OUTLIER_SHARE = 1e-3


def _assert_mel_close(got, want):
    err = np.abs(got - want)
    assert err.max() <= WORST_ATOL, err.max()
    assert np.mean(err > ATOL) <= OUTLIER_SHARE, np.mean(err > ATOL)


@pytest.mark.parametrize("seconds", [7, 30])
@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_matches_jax(seconds, n_mels):
    rng = np.random.default_rng(seconds)
    t = np.arange(16000 * seconds) / 16000
    audio = (0.3 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
    want = np.asarray(JM.log_mel_spectrogram(audio, n_mels=n_mels))
    got = TM.log_mel_spectrogram(audio, n_mels=n_mels).numpy()
    assert got.shape == want.shape == (1, 3000, n_mels)
    _assert_mel_close(got, want)


def test_log_mel_batch_without_chunk_padding():
    audio = np.random.default_rng(1).standard_normal((2, 16000 * 5)).astype(np.float32) * 0.1
    want = np.asarray(JM.log_mel_spectrogram(audio, n_mels=80, pad_to_chunk=False))
    got = TM.log_mel_spectrogram(audio, n_mels=80, pad_to_chunk=False).numpy()
    assert got.shape == (2, 500, 80)
    _assert_mel_close(got, want)


def test_filters_and_basis_equal_jax():
    np.testing.assert_array_equal(TM.mel_filter_bank(128), JM.mel_filter_bank(128))
    for a, b in zip(TM._dft_basis(), JM._dft_basis()):
        np.testing.assert_array_equal(a, b)
