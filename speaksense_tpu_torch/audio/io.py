"""Audio file input: the port's own copy of the file half of
`speaksense_tpu/audio/io.py` (`read_wav`, `write_wav`, `ensure_wav_format`,
`load_audio`, the streaming parser `parse_audio_file_stream` and their
errors), with the same names and behaviour.

WAV is read and written with the standard library's `wave` module and
numpy; any other format is converted by spawning `ffmpeg -acodec pcm_s16le
-ar 44100`, as the reference does (codecs are not reimplemented).
"""

from __future__ import annotations

import logging
import shutil
import subprocess
import wave
from pathlib import Path
from typing import Callable

import numpy as np

from speaksense_tpu_torch.audio.dsp import DenoiseConfig, convert_to_mono
from speaksense_tpu_torch.audio.resample import ChunkResampler, resample
from speaksense_tpu_torch.audio.stream import StreamAudioProcessor

log = logging.getLogger(__name__)

TARGET_RATE = 16_000


class AudioError(Exception):
    """Audio pipeline failure (reference AudioError enum, mod.rs:12-25)."""


class UnsupportedFormatError(AudioError):
    pass


class FfmpegError(AudioError):
    pass


def read_wav(path: str | Path) -> tuple[np.ndarray, int, int]:
    """Read a WAV file -> (interleaved f32 samples in [-1,1], channels, rate).
    Supports 8/16/24/32-bit integer PCM."""
    with wave.open(str(path), "rb") as w:
        channels = w.getnchannels()
        rate = w.getframerate()
        width = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if width == 2:
        x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif width == 1:
        x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 3:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        vals = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16))
        vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
        x = vals.astype(np.float32) / float(1 << 23)
    elif width == 4:
        # stdlib wave only handles PCM; 32-bit is int PCM
        x = np.frombuffer(raw, "<i4").astype(np.float32) / float(1 << 31)
    else:
        raise UnsupportedFormatError(f"unsupported sample width {width}")
    return x, channels, rate


def write_wav(path: str | Path, samples: np.ndarray, rate: int = TARGET_RATE,
              channels: int = 1) -> None:
    """Write f32 [-1,1] samples as 16-bit PCM (test fixtures, debug dumps)."""
    s = np.clip(np.asarray(samples, np.float32), -1.0, 1.0)
    pcm = (s * 32767.0).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def ensure_wav_format(path: str | Path) -> Path:
    """Return a WAV path for `path`, converting via ffmpeg if needed
    (pcm_s16le @ 44.1 kHz, the reference's invocation). The caller removes
    the converted file when it differs from the input."""
    path = Path(path)
    if path.suffix.lower() == ".wav":
        return path
    if not ffmpeg_available():
        raise FfmpegError("ffmpeg not found on PATH; cannot convert non-WAV input")
    out_path = path.with_suffix(".wav")
    proc = subprocess.run(
        ["ffmpeg", "-y", "-i", str(path), "-acodec", "pcm_s16le", "-ar", "44100", str(out_path)],
        capture_output=True,
    )
    if proc.returncode != 0:
        raise FfmpegError(f"ffmpeg conversion failed: {proc.stderr[-400:].decode(errors='replace')}")
    return out_path


def load_audio(path: str | Path, target_rate: int = TARGET_RATE) -> np.ndarray:
    """File -> mono f32 @ target_rate in one call (the non-streaming path)."""
    path = Path(path)
    wav_path = ensure_wav_format(path)
    try:
        x, channels, rate = read_wav(wav_path)
        mono = convert_to_mono(x, channels)
        return resample(mono, rate, target_rate)
    finally:
        if wav_path != path:
            wav_path.unlink(missing_ok=True)


def parse_audio_file_stream(
    path: str | Path,
    config: DenoiseConfig | None = None,
    callback: Callable[[np.ndarray], None] | None = None,
    chunk_size: int = 4096,
) -> None:
    """Streaming parse: read `chunk_size` samples at a time, downmix,
    resample to 16 kHz, run the stream DSP, and invoke `callback` with each
    processed frame (the reference's audio/mod.rs streaming parser)."""
    config = config or DenoiseConfig()
    path = Path(path)
    wav_path = ensure_wav_format(path)
    try:
        with wave.open(str(wav_path), "rb") as w:
            channels = w.getnchannels()
            rate = w.getframerate()
            width = w.getsampwidth()
            if width != 2:
                raise UnsupportedFormatError("streaming parser expects 16-bit PCM")
            resampler = ChunkResampler(rate, TARGET_RATE) if rate != TARGET_RATE else None
            processor = StreamAudioProcessor(config, callback or (lambda _: None))
            frames_per_chunk = max(1, chunk_size // max(channels, 1))
            while True:
                raw = w.readframes(frames_per_chunk)
                if not raw:
                    break
                x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
                mono = convert_to_mono(x, channels)
                if resampler is not None:
                    mono = resampler.process(mono)
                processor.process_chunk(mono)
            if resampler is not None:
                tail = resampler.finish()
                if tail.size:
                    processor.process_chunk(tail)
            processor.finish()
    finally:
        if wav_path != path:
            wav_path.unlink(missing_ok=True)
