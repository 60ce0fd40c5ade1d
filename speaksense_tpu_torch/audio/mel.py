"""Log-mel spectrogram in PyTorch: the counterpart of
`speaksense_tpu/audio/mel.py`.

The STFT is the same framed-matmul DFT as the reference: reflect-pad,
frame, multiply by the Hann-windowed [cos | sin] basis, power, Slaney mel
projection, log10 clamped at 1e-10, dynamic-range clamp to (max - 8) over
each row's (T, mels) block, and (x + 4) / 4. Everything runs in true f32:
on a GPU the f32 matmuls must not round through TF32, so
`log_mel_spectrogram` sets `torch.backends.cuda.matmul.allow_tf32 = False`
and `torch.backends.cudnn.allow_tf32 = False` before it runs on a CUDA
tensor. There is no kernel here to port (the reference's Pallas mel kernel
was deleted); `torch.matmul` is the plain version.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16_000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH = 30  # seconds per window
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE  # 480_000
N_FRAMES = N_SAMPLES // HOP_LENGTH  # 3000


def _hz_to_mel(freq):
    """Slaney-scale Hz -> mel (linear below 1 kHz, log above)."""
    freq = np.asarray(freq, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    mel = freq / f_sp
    return np.where(freq >= min_log_hz,
                    min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hz) / logstep, mel)


def _mel_to_hz(mel):
    mel = np.asarray(mel, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    hz = f_sp * mel
    return np.where(mel >= min_log_mel, min_log_hz * np.exp(logstep * (mel - min_log_mel)), hz)


@functools.lru_cache(maxsize=8)
def mel_filter_bank(n_mels: int, n_fft: int = N_FFT, sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, shape (n_mels, n_fft//2+1)
    (librosa.filters.mel(norm="slaney", htk=False))."""
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0, sample_rate / 2, n_freqs)
    mel_pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sample_rate / 2), n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1][:, None]
    upper = ramps[2:] / fdiff[1:][:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2: n_mels + 2] - mel_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=2)
def _dft_basis(n_fft: int = N_FFT) -> tuple[np.ndarray, np.ndarray]:
    """Windowed real-DFT basis (cos, sin), each (n_fft, n_fft//2+1), already
    multiplied by the periodic Hann window."""
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft))
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_fft // 2 + 1)[None, :]
    angle = -2.0 * np.pi * n * k / n_fft
    cos_b = (np.cos(angle) * window[:, None]).astype(np.float32)
    sin_b = (np.sin(angle) * window[:, None]).astype(np.float32)
    return cos_b, sin_b


def log_mel_spectrogram(audio, n_mels: int = 80, filters: np.ndarray | None = None,
                        pad_to_chunk: bool = True, device=None) -> torch.Tensor:
    """(B, n_frames, n_mels) f32 log-mel features on `device` (default: the
    audio tensor's device, or the CPU for numpy input).

    audio: f32 PCM at 16 kHz, shape (n,) or (B, n). pad_to_chunk zero-pads
    to a whole number of 30 s windows."""
    a = torch.as_tensor(audio, dtype=torch.float32, device=device)
    if a.dim() == 1:
        a = a[None, :]
    if a.device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    n = a.shape[-1]
    if pad_to_chunk:
        target = ((max(n, 1) + N_SAMPLES - 1) // N_SAMPLES) * N_SAMPLES
        if target != n:
            a = F.pad(a, (0, target - n))
        n = target
    num_frames = n // HOP_LENGTH
    if filters is None:
        filters = mel_filter_bank(n_mels)
    pad = N_FFT // 2
    x = F.pad(a[:, None, :], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(-1, N_FFT, HOP_LENGTH)[:, :num_frames]    # (B, T, n_fft)
    cos_b, sin_b = (torch.from_numpy(b).to(a.device) for b in _dft_basis())
    re = torch.matmul(frames, cos_b)
    im = torch.matmul(frames, sin_b)
    power = re * re + im * im
    mel = torch.matmul(power, torch.as_tensor(filters, dtype=torch.float32, device=a.device).T)
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    max_val = log_spec.amax(dim=(1, 2), keepdim=True)
    log_spec = torch.maximum(log_spec, max_val - 8.0)
    return (log_spec + 4.0) / 4.0
