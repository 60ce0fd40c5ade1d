"""Speaker voiceprint embeddings (VoiceprintRecognition tasks and the CLI's
`voiceprint`): the port's own copy of `speaksense_tpu/audio/voiceprint.py`,
with the same names and behaviour.

    16 kHz mono f32 -> framed STFT -> mel (the port's `audio/mel.py`
    filterbank, equal to the JAX package's) -> MFCC (DCT-II) -> drop c0
    (gain) -> mean ++ std of the static and delta coefficients ->
    L2-normalized fixed-dimension embedding.

Gain invariance comes from dropping c0, not from cepstral mean
subtraction, which would also remove the spectral envelope that carries
the speaker. MFCC statistics are the classical pre-neural speaker
representation: deterministic, and far weaker than a trained x-vector.
Host numpy: a minute of audio is about 6k frames x 64 bins.
"""

from __future__ import annotations

import numpy as np

from speaksense_tpu_torch.audio.mel import mel_filter_bank

SAMPLE_RATE = 16000
N_FFT = 400
HOP = 160
N_MELS = 64
N_MFCC = 20
# embedding = mean++std over (static ++ delta) MFCCs
EMBED_DIM = 4 * N_MFCC

# Cosine-similarity acceptance threshold for "same speaker". Tuned on the
# synthetic-speaker fixtures of tests/test_voiceprint.py: same-speaker pairs
# score > 0.9 there, different-speaker pairs < 0.6. Real-speech thresholds
# must be calibrated on real data; expose it as a knob, not a constant.
DEFAULT_THRESHOLD = 0.75


def _dct_ii(n_out: int, n_in: int) -> np.ndarray:
    """Orthonormal DCT-II basis (n_out, n_in)."""
    k = np.arange(n_out)[:, None]
    n = np.arange(n_in)[None, :]
    basis = np.cos(np.pi * k * (2 * n + 1) / (2 * n_in))
    basis *= np.sqrt(2.0 / n_in)
    basis[0] *= np.sqrt(0.5)
    return basis.astype(np.float32)


def mfcc(audio: np.ndarray, sample_rate: int = SAMPLE_RATE,
         n_mfcc: int = N_MFCC) -> np.ndarray:
    """(T, n_mfcc) MFCC matrix of a mono f32 waveform.

    Framing matches the Whisper front end's hop so timestamps line up
    (HOP=160 => 10 ms frames); the filterbank comes from audio/mel.py so
    the mel warping is identical to what the encoder sees.
    """
    x = np.asarray(audio, np.float32)
    if x.size < N_FFT:
        x = np.pad(x, (0, N_FFT - x.size))
    n_frames = 1 + (x.size - N_FFT) // HOP
    idx = np.arange(N_FFT)[None, :] + HOP * np.arange(n_frames)[:, None]
    frames = x[idx] * np.hanning(N_FFT).astype(np.float32)[None, :]
    spec = np.abs(np.fft.rfft(frames, axis=-1)) ** 2          # (T, n_fft//2+1)
    filters = mel_filter_bank(N_MELS, n_fft=N_FFT, sample_rate=sample_rate)
    mels = spec @ filters.T                                    # (T, N_MELS)
    logmels = np.log(np.maximum(mels, 1e-10))
    return logmels @ _dct_ii(n_mfcc, N_MELS).T                 # (T, n_mfcc)


def voiceprint_embedding(audio: np.ndarray,
                         sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """L2-normalized (EMBED_DIM,) float32 speaker embedding.

    c0 (log gain) is used only to drop low-energy frames (crude VAD so
    silence doesn't wash out the speaker statistics), then discarded for
    gain invariance; the remaining coefficients carry the spectral
    envelope (formant structure) and their deltas the speaking dynamics.
    """
    c = mfcc(audio, sample_rate, n_mfcc=N_MFCC + 1)
    if len(c) >= 8:
        # energy proxy: c0 tracks log frame energy
        keep = c[:, 0] >= np.percentile(c[:, 0], 5.0)
        c = c[keep] if keep.any() else c
    c = c[:, 1:]                      # drop c0 -> gain invariance
    delta = np.diff(c, axis=0, prepend=c[:1])
    emb = np.concatenate([c.mean(0), c.std(0), delta.mean(0), delta.std(0)])
    norm = float(np.linalg.norm(emb))
    return (emb / (norm + 1e-12)).astype(np.float32)


def cosine_similarity(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float32).ravel()
    b = np.asarray(b, np.float32).ravel()
    denom = float(np.linalg.norm(a)) * float(np.linalg.norm(b))
    return float(np.dot(a, b) / (denom + 1e-12))
