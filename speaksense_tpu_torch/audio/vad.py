"""Voice activity detection: the port's own copy of
`speaksense_tpu/audio/vad.py`, with the same names and behaviour.

`voice_activity_detection` (frame-energy thresholding with one frame of
hangover) and `adaptive_gain` (rolling noise floor, 0.95/0.05 EMA, soft
gain floor 0.1) mirror the reference's audio/mod.rs; `speech_segments`
finds the speech spans that `WhisperEngine.transcribe_audio_vad` sends to
the encoder, so silence never reaches the card. Host numpy.
"""

from __future__ import annotations

import numpy as np

from speaksense_tpu_torch.audio.dsp import estimate_noise_floor


def _frame_energies(x: np.ndarray, frame_size: int) -> np.ndarray:
    n = int(np.ceil(x.size / frame_size))
    pad = n * frame_size - x.size
    xp = np.pad(x.astype(np.float32), (0, pad))
    return (xp.reshape(n, frame_size) ** 2).mean(axis=1)


def voice_activity_detection(x: np.ndarray, frame_size: int = 512,
                             threshold: float = 0.002) -> np.ndarray:
    """Zero out frames whose energy (and their predecessor's) is below
    threshold; a frame directly after an active frame is kept (hangover)."""
    x = np.asarray(x, np.float32)
    if x.size == 0:
        return x
    energy = _frame_energies(x, frame_size)
    active = energy > threshold
    keep = active.copy()
    keep[1:] |= active[:-1]
    mask = np.repeat(keep, frame_size)[: x.size]
    return np.where(mask, x, 0.0).astype(np.float32)


def adaptive_gain(x: np.ndarray, frame_size: int = 2048) -> np.ndarray:
    """Rolling-noise-floor soft gating: full gain above the adaptive
    threshold, ratio-based gain (floor 0.1) below."""
    x = np.asarray(x, np.float32)
    if x.size == 0:
        return x
    noise_floor = estimate_noise_floor(x)
    prev_energy = 0.0
    out = np.empty_like(x)
    for i in range(0, x.size, frame_size):
        chunk = x[i : i + frame_size]
        energy = float((chunk**2).mean())
        threshold = noise_floor * 1.2 + prev_energy * 0.1
        gain = 1.0 if energy > threshold else max(energy / max(threshold, 1e-12), 0.1)
        out[i : i + frame_size] = chunk * gain
        prev_energy = energy
        noise_floor = noise_floor * 0.95 + min(energy, noise_floor) * 0.05
    return out


def speech_segments(x: np.ndarray, sample_rate: int = 16000,
                    frame_ms: float = 30.0, threshold_db: float = -40.0,
                    min_speech_s: float = 0.25, min_gap_s: float = 0.5,
                    pad_s: float = 0.2) -> list[tuple[int, int]]:
    """Energy-based speech spans as (start_sample, end_sample), merged over
    short gaps and padded — drives windowing for batch transcription so
    silence never reaches the encoder."""
    x = np.asarray(x, np.float32)
    if x.size == 0:
        return []
    frame = max(1, int(sample_rate * frame_ms / 1000))
    energy_db = 10.0 * np.log10(_frame_energies(x, frame) + 1e-10)
    # adaptive threshold relative to the noise floor
    floor = np.percentile(energy_db, 10)
    thr = max(threshold_db, floor + 6.0)
    active = energy_db > thr

    spans: list[list[int]] = []
    for i, a in enumerate(active):
        if a:
            if spans and i * frame - spans[-1][1] <= int(min_gap_s * sample_rate):
                spans[-1][1] = (i + 1) * frame
            else:
                spans.append([i * frame, (i + 1) * frame])
    pad = int(pad_s * sample_rate)
    out = []
    for s, e in spans:
        if e - s < int(min_speech_s * sample_rate):
            continue
        out.append((max(0, s - pad), min(x.size, e + pad)))
    # merge overlapping after padding
    merged: list[tuple[int, int]] = []
    for s, e in out:
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return merged
