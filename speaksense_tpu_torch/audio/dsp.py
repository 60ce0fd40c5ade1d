"""Device denoise in PyTorch: the counterpart of
`speaksense_tpu/audio/dsp.py::denoise_audio_jax`.

The slot pool's admission runs the reference's denoise chain on the card,
on (B, n) f32 tensors with `torch.fft`: Hann-windowed framing, the noise
spectrum of the first 20 non-overlapping frames (and the mean signal
spectrum for Wiener), the spectral-subtraction or Wiener gains, and a
windowed overlap-add normalised by the summed squared window, floored at
0.5. The branch is picked on the host by the shared numpy classifier
(`classify_noise`) and pinned per call, as the JAX admission pins it: only
one DSP path runs. There is no kernel here to port (the reference's denoise
is XLA-fused jnp, not Pallas).

The numpy chain and classifier come from `speaksense_tpu/audio/dsp.py`,
loaded by file path (`speaksense_tpu_torch._shared`) so that no jax is
imported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from speaksense_tpu_torch._shared import np_dsp

DenoiseConfig = np_dsp.DenoiseConfig
classify_noise = np_dsp.classify_noise
denoise_audio = np_dsp.denoise_audio     # host numpy chain (window-path fallback)

BRANCHES = ("spectral", "wiener", "mixed")


def denoise_audio_torch(x: torch.Tensor, config: DenoiseConfig | None = None,
                        branch: str = "spectral") -> torch.Tensor:
    """x (n,) or (B, n) f32 -> same shape, on x's device. branch is one of
    BRANCHES (from `classify_noise`); 'mixed' runs spectral subtraction
    then the Wiener filter."""
    if branch not in BRANCHES:
        raise ValueError(f"denoise branch must be one of {BRANCHES}, got {branch!r}")
    config = config or DenoiseConfig()
    x = x.float()
    if x.dim() == 1:
        return denoise_audio_torch(x[None], config, branch)[0]
    n = x.shape[-1]
    frame = config.frame_size
    if n < frame:  # too short to frame: the reference returns the input
        return x
    step = max(1, int(frame * (1.0 - config.overlap)))
    window = torch.from_numpy(np_dsp._hann(frame)).to(x.device)

    def power_frames(sig):
        nf = n // frame
        fr = sig[:, : nf * frame].reshape(sig.shape[0], nf, frame) * window
        spec = torch.fft.fft(fr, dim=-1)
        return spec.real ** 2 + spec.imag ** 2            # (B, nf, frame)

    def noise_spectrum(sig, num_frames: int = 20):
        return power_frames(sig)[:, :num_frames].sum(dim=1) / num_frames

    def stft(sig):
        return torch.fft.fft(sig.unfold(-1, frame, step) * window, dim=-1)

    def overlap_add(td):
        # td (B, nf, frame): windowed frames summed at hop `step`
        nf = td.shape[1]
        span = (nf - 1) * step + frame
        fold = dict(output_size=(1, span), kernel_size=(1, frame), stride=(1, step))
        out = F.fold((td * window).transpose(1, 2), **fold)[:, 0, 0]
        w2 = (window * window)[None, :, None].expand(1, frame, nf)
        norm = F.fold(w2, **fold)[:, 0, 0]
        y = out / torch.clamp(norm, min=0.5) * config.post_gain
        return F.pad(y, (0, n - span))

    def spectral(sig):
        noise = noise_spectrum(sig)
        spec = stft(sig)
        power = spec.real ** 2 + spec.imag ** 2
        freq_factor = torch.clamp(torch.arange(frame, dtype=torch.float32,
                                               device=x.device) / frame, max=1.0)
        freq_strength = config.strength * (1.0 - 0.3 * freq_factor)
        ratio = noise[:, None, :] / (power + 1e-6)
        alpha, beta = 1.0, 0.1
        gain = torch.sqrt(torch.clamp(1.0 - alpha * torch.pow(ratio, freq_strength), min=beta))
        return overlap_add(torch.fft.ifft(spec * gain, dim=-1).real)

    def wiener(sig):
        noise = noise_spectrum(sig)
        signal = power_frames(sig).mean(dim=1)
        snr = signal / (noise + 1e-6)
        gain = torch.pow(snr / (1.0 + snr), config.strength * 0.7)
        return overlap_add(torch.fft.ifft(stft(sig) * gain[:, None, :], dim=-1).real)

    if branch == "spectral":
        return spectral(x)
    if branch == "wiener":
        return wiener(x)
    return wiener(spectral(x))
