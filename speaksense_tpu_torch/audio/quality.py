"""Audio quality metrics: the port's own copy of
`speaksense_tpu/audio/quality.py`, with the same names and behaviour (the
reference's audio/mod.rs): noise floor, SNR, zero-crossing and
energy-variance speech features, the composite 0-100 quality score and the
conservative needs-denoising decision. Host numpy."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from speaksense_tpu_torch.audio.dsp import estimate_noise_floor


@dataclass
class AudioQualityMetrics:
    snr: float
    noise_level: float
    signal_level: float
    quality_score: float
    needs_denoising: bool

    def to_dict(self) -> dict:
        return self.__dict__.copy()


def calculate_snr(x: np.ndarray, noise_floor: float) -> float:
    """10*log10(signal_power / noise_floor), capped at 100 dB for ~zero noise
    (mod.rs:770-786)."""
    signal_power = float((np.asarray(x, np.float32) ** 2).mean()) if x.size else 0.0
    if noise_floor < 1e-10:
        return 100.0
    return 10.0 * float(np.log10(max(signal_power, 1e-30) / noise_floor))


def calculate_speech_features(x: np.ndarray, frame_size: int = 512) -> float:
    """0..1 score: zero-crossing rate + short-term energy variance (mod.rs:846-869)."""
    x = np.asarray(x, np.float32)
    if x.size < 2:
        return 0.0
    zc = float(np.count_nonzero(np.sign(x[:-1]) != np.sign(x[1:]))) / x.size
    n = int(np.ceil(x.size / frame_size))
    pad = n * frame_size - x.size
    fr = np.pad(x, (0, pad)).reshape(n, frame_size)
    energies = (fr**2).mean(axis=1)
    variance = float(((energies - energies.mean()) ** 2).mean())
    zc_score = min(zc * 1000.0, 1.0)
    ev_score = min(variance * 100.0, 1.0)
    return (zc_score + ev_score) / 2.0


def evaluate_audio_quality(x: np.ndarray) -> AudioQualityMetrics:
    """Composite 0-100 score: SNR 40pts + speech features 35pts + dynamic
    range 25pts; denoise only when SNR<10 and score<50 (mod.rs:804-844)."""
    x = np.asarray(x, np.float32)
    noise_floor = estimate_noise_floor(x)
    signal_level = float((x**2).mean()) if x.size else 0.0
    snr = calculate_snr(x, noise_floor)
    snr_score = min(snr, 30.0) / 30.0 * 40.0
    speech_score = calculate_speech_features(x) * 35.0
    if x.size:
        mx = float(np.abs(x).max())
        mn = float(np.abs(x).min())
        dr_score = min(np.log10(mx / (mn + 1e-6) + 1e-30) * 8.0, 25.0)
    else:
        dr_score = 0.0
    quality = snr_score + speech_score + max(dr_score, 0.0)
    return AudioQualityMetrics(
        snr=snr, noise_level=noise_floor, signal_level=signal_level,
        quality_score=float(quality),
        needs_denoising=bool(snr < 10.0 and quality < 50.0),
    )
