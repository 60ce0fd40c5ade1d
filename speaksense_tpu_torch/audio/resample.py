"""Sample-rate conversion to whisper's 16 kHz: the counterpart of
`speaksense_tpu/audio/resample.py` (`resample` and `ChunkResampler`).

The JAX package calls scipy's polyphase `resample_poly`; the port computes
the same polyphase filter in numpy, so it needs no scipy: a Kaiser-windowed
sinc low-pass (beta 5, ten zero crossings of the slower rate on each side,
unit DC gain times the up factor), applied to the zero-stuffed input and
decimated, with scipy's padding so the output grid is centred the same way.
The sums run in float64 and the result is rounded to float32; scipy filters
a float32 input in float32, so the two agree to a few float32 ulps.
"""

from __future__ import annotations

import math

import numpy as np

_CHUNK = 1 << 16     # output samples per vectorised block


def _lowpass(up: int, down: int) -> tuple[np.ndarray, int]:
    """scipy's `firwin(2 * half_len + 1, 1 / max(up, down),
    window=("kaiser", 5.0)) * up`, and half_len."""
    max_rate = max(up, down)
    half_len = 10 * max_rate
    cutoff = 1.0 / max_rate
    m = np.arange(2 * half_len + 1) - half_len
    h = cutoff * np.sinc(cutoff * m) * np.kaiser(2 * half_len + 1, 5.0)
    return h / h.sum() * up, half_len


def resample(x: np.ndarray, from_rate: int, to_rate: int) -> np.ndarray:
    """Whole-signal polyphase resample, f32 in and out."""
    x = np.asarray(x, np.float32)
    if from_rate == to_rate or x.size == 0:
        return x
    g = math.gcd(from_rate, to_rate)
    up, down = to_rate // g, from_rate // g
    h, half_len = _lowpass(up, down)
    n_in = x.size
    n_out = -(-n_in * up // down)
    # scipy's padding: the filter's centre lands on output sample 0
    pre_pad = down - half_len % down
    pre_remove = (half_len + pre_pad) // down
    h = np.concatenate([np.zeros(pre_pad), h])
    # upfirdn: y[k] = sum_i x[i] h[k * down - i * up]; for output k the taps
    # are h[r], h[r + up], ... with r = (k * down) % up, against x[k * down //
    # up], x[k * down // up - 1], ...
    n_taps = -(-h.size // up)
    h = np.concatenate([h, np.zeros(n_taps * up - h.size)])
    j = np.arange(n_taps)
    xd = x.astype(np.float64)
    out = np.empty(n_out, np.float32)
    for k0 in range(0, n_out, _CHUNK):
        t = (np.arange(k0, min(k0 + _CHUNK, n_out)) + pre_remove) * down
        src = (t // up)[:, None] - j[None, :]
        taps = h[(t % up)[:, None] + up * j[None, :]]
        valid = (src >= 0) & (src < n_in)
        out[k0:k0 + t.size] = (np.where(valid, xd[np.clip(src, 0, n_in - 1)], 0.0)
                               * taps).sum(axis=1)
    return out


class ChunkResampler:
    """Stateful streaming resampler, boundary-exact with the whole-signal
    `resample` (the JAX `ChunkResampler`, with the same names and
    behaviour; the reference's SincFixedIn is likewise stateful across
    calls).

    Outputs are only finalized once `context` samples of lookahead exist,
    and the retained buffer always starts on a multiple of the polyphase
    decimation factor, so every call's output grid aligns with the global
    one: finalized outputs equal a one-shot resample except for the
    filter's start-up at the stream's edges.
    """

    def __init__(self, from_rate: int, to_rate: int, context: int = 512):
        g = math.gcd(from_rate, to_rate)
        self.from_rate = from_rate
        self.to_rate = to_rate
        self.up = to_rate // g
        self.down = from_rate // g
        # align context up to a whole number of decimation blocks
        self.context = ((context + self.down - 1) // self.down) * self.down
        self._buf = np.zeros((0,), np.float32)
        self._in_start = 0        # global index of _buf[0]; always % down == 0
        self._emitted = 0         # global output samples emitted

    def _out_of_in(self, global_in: int) -> int:
        return global_in * self.up // self.down

    def process(self, chunk: np.ndarray) -> np.ndarray:
        chunk = np.asarray(chunk, np.float32)
        if self.from_rate == self.to_rate:
            return chunk
        self._buf = np.concatenate([self._buf, chunk])
        fin = ((self._buf.size - self.context) // self.down) * self.down
        if fin <= 0:
            return np.zeros((0,), np.float32)
        res = resample(self._buf, self.from_rate, self.to_rate)
        lo = self._emitted - self._out_of_in(self._in_start)
        hi = self._out_of_in(self._in_start + fin) - self._out_of_in(self._in_start)
        out = res[lo:hi]
        self._emitted += out.size
        drop = max(0, fin - self.context)
        self._buf = self._buf[drop:]
        self._in_start += drop
        return out

    def finish(self) -> np.ndarray:
        """Flush the outputs held back for lookahead."""
        if self.from_rate == self.to_rate or self._buf.size == 0:
            return np.zeros((0,), np.float32)
        res = resample(self._buf, self.from_rate, self.to_rate)
        lo = self._emitted - self._out_of_in(self._in_start)
        out = res[lo:]
        self._emitted += out.size
        self._buf = np.zeros((0,), np.float32)
        return out
