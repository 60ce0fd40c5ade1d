"""Heuristic speech-emotion classification (the ``emotion_recognition``
flag of a REST transcribe task): the port's own copy of
`speaksense_tpu/audio/emotion.py`, with the same names and behaviour.

A deterministic prosodic classifier, not a trained model: energy (RMS of
the span), pitch (FFT autocorrelation F0 per voiced frame, mean and std)
and rate (voiced-frame ratio) map to "neutral" | "calm" | "excited" |
"agitated" as `classify_emotion` documents. Host numpy.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

SAMPLE_RATE = 16000
FRAME = 512          # 32 ms
HOP = 256
F0_MIN, F0_MAX = 60.0, 400.0

LABELS = ("neutral", "calm", "excited", "agitated")


@dataclass
class EmotionFeatures:
    energy_rms: float
    pitch_mean_hz: float
    pitch_std_hz: float
    voiced_ratio: float

    def to_dict(self) -> dict:
        return {"energy_rms": self.energy_rms,
                "pitch_mean_hz": self.pitch_mean_hz,
                "pitch_std_hz": self.pitch_std_hz,
                "voiced_ratio": self.voiced_ratio}


def _frames(x: np.ndarray) -> np.ndarray:
    if x.size < FRAME:
        x = np.pad(x, (0, FRAME - x.size))
    n = 1 + (x.size - FRAME) // HOP
    idx = np.arange(FRAME)[None, :] + HOP * np.arange(n)[:, None]
    return x[idx]


def _pitch_per_frame(frames: np.ndarray, sr: int) -> np.ndarray:
    """F0 in Hz per frame via FFT-based autocorrelation; 0 = unvoiced.

    Vectorized over frames (one rfft/irfft pair for the whole matrix —
    the rayon-per-frame loops of the reference DSP map to batched host
    vectorization here, the same trade documented in audio/dsp.py).
    """
    n = frames.shape[1]
    spec = np.fft.rfft(frames - frames.mean(1, keepdims=True), n=2 * n, axis=1)
    ac = np.fft.irfft(np.abs(spec) ** 2, axis=1)[:, :n]
    ac0 = np.maximum(ac[:, :1], 1e-12)
    lag_lo = max(2, int(sr / F0_MAX))
    lag_hi = min(n - 1, int(sr / F0_MIN))
    window = ac[:, lag_lo:lag_hi]
    best = np.argmax(window, axis=1)
    peak = np.take_along_axis(window, best[:, None], axis=1)[:, 0] / ac0[:, 0]
    f0 = sr / (best + lag_lo).astype(np.float64)
    # voicing: periodic peak must carry >40% of zero-lag energy
    return np.where(peak > 0.4, f0, 0.0)


def extract_features(audio: np.ndarray, sample_rate: int = SAMPLE_RATE) -> EmotionFeatures:
    x = np.asarray(audio, np.float32)
    if x.size == 0:
        return EmotionFeatures(0.0, 0.0, 0.0, 0.0)
    frames = _frames(x)
    # consider only frames with audible energy for voicing statistics
    frame_rms = np.sqrt(np.mean(frames**2, axis=1))
    audible = frame_rms > max(1e-4, 0.1 * float(frame_rms.max()))
    f0 = _pitch_per_frame(frames, sample_rate)
    voiced = (f0 > 0) & audible
    pitches = f0[voiced]
    return EmotionFeatures(
        energy_rms=float(np.sqrt(np.mean(x**2))),
        pitch_mean_hz=float(pitches.mean()) if pitches.size else 0.0,
        pitch_std_hz=float(pitches.std()) if pitches.size else 0.0,
        voiced_ratio=float(voiced.mean()),
    )


def classify_emotion(audio: np.ndarray,
                     sample_rate: int = SAMPLE_RATE) -> tuple[str, EmotionFeatures]:
    """(label, features) for a speech span.

    Mapping (arousal-oriented; tests/test_emotion.py pins these thresholds
    on the JAX original):
      - agitated: loud AND highly variable pitch (std > 55 Hz)
      - excited:  loud OR high-pitched (mean > 220 Hz) with dense voicing
      - calm:     quiet, low/steady pitch, sparse voicing
      - neutral:  everything else
    """
    f = extract_features(audio, sample_rate)
    loud = f.energy_rms > 0.08
    quiet = f.energy_rms < 0.02
    variable = f.pitch_std_hz > 55.0
    high = f.pitch_mean_hz > 220.0
    dense = f.voiced_ratio > 0.5
    if loud and variable:
        return "agitated", f
    if (loud or high) and dense:
        return "excited", f
    if quiet and not variable:
        return "calm", f
    return "neutral", f
