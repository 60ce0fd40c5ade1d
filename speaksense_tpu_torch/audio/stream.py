"""StreamAudioProcessor, incremental chunk DSP for live streams: the port's
own copy of `speaksense_tpu/audio/stream.py`, with the same names and
behaviour (the reference's audio/mod.rs): a 2048-sample frame buffer; each
chunk normalized; per frame the noise-floor init, preemphasis for the
energy estimate, the adaptive VAD gain (threshold = floor*1.2 +
prev_energy*0.1, soft floor 0.1, EMA floor update 0.95/0.05), the optional
denoise and the noise gate, then the callback."""

from __future__ import annotations

from typing import Callable

import numpy as np

from speaksense_tpu_torch.audio.dsp import (
    DenoiseConfig,
    apply_noise_gate,
    denoise_audio,
    estimate_noise_floor,
    normalize_audio,
    preemphasis,
)


class StreamAudioProcessor:
    def __init__(self, config: DenoiseConfig | None = None,
                 callback: Callable[[np.ndarray], None] | None = None,
                 frame_size: int = 2048, sample_rate: int = 16_000):
        self.config = config or DenoiseConfig()
        self.callback = callback or (lambda _: None)
        self.frame_size = frame_size
        self.sample_rate = sample_rate
        self._buffer = np.zeros((0,), np.float32)
        self._prev_energy = 0.0
        self._noise_floor = 0.0

    def process_chunk(self, chunk: np.ndarray) -> None:
        chunk = normalize_audio(np.asarray(chunk, np.float32))
        self._buffer = np.concatenate([self._buffer, chunk])
        while self._buffer.size >= self.frame_size:
            frame, self._buffer = (self._buffer[: self.frame_size],
                                   self._buffer[self.frame_size :])
            if self._noise_floor == 0.0:
                self._noise_floor = estimate_noise_floor(frame)
            self.callback(self._process_frame(frame))

    def _process_frame(self, frame: np.ndarray) -> np.ndarray:
        emphasized = preemphasis(frame, 0.97)
        energy = float((emphasized**2).mean())
        threshold = self._noise_floor * 1.2 + self._prev_energy * 0.1
        gain = 1.0 if energy > threshold else max(energy / max(threshold, 1e-12), 0.1)
        self._prev_energy = energy
        self._noise_floor = self._noise_floor * 0.95 + min(energy, self._noise_floor) * 0.05

        processed = frame * gain
        if self.config.enable_noise_reduction:
            processed = denoise_audio(processed, self.config)
        return apply_noise_gate(processed, self.config.noise_gate)

    def finish(self) -> None:
        if self._buffer.size:
            frame = np.pad(self._buffer, (0, self.frame_size - self._buffer.size))
            self._buffer = np.zeros((0,), np.float32)
            if self._noise_floor == 0.0:
                self._noise_floor = estimate_noise_floor(frame)
            self.callback(self._process_frame(frame))
