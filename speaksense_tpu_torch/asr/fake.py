"""Deterministic fake engine for API/serving tests.

The port's own copy of `speaksense_tpu/asr/fake.py`,
with the same names and behaviour.

SURVEY.md §4 calls out that the reference has no fake backend and every test
needs a 3 GB model + live services; this fills that gap: transcripts are a
pure function of the audio content, so gRPC/REST/scheduler tests are hermetic
and fast.
"""

from __future__ import annotations

import hashlib

import numpy as np

from speaksense_tpu_torch.asr import AsrEngine, AsrParams, TranscribeResult, TranscribeSegment


class FakeAsrEngine(AsrEngine):
    """Emits one segment per ~`segment_seconds` of audio with text derived
    from a content hash (stable across runs, distinct across inputs)."""

    def __init__(self, segment_seconds: float = 5.0, sample_rate: int = 16000):
        self.segment_seconds = segment_seconds
        self.sample_rate = sample_rate
        self.calls: list[AsrParams] = []  # test introspection

    def create_state(self):
        return {}

    def transcribe_with_state(self, state, audio, params: AsrParams) -> TranscribeResult:
        self.calls.append(params)
        audio = np.asarray(audio).reshape(-1)
        if audio.dtype == np.int16:
            # engines accept wire-dtype s16 (the pipelined submit path keeps
            # PCM unscaled until the device); normalize so transcripts hash
            # identically across both representations
            audio = audio.astype(np.float32) / 32767.0
        audio = audio.astype(np.float32)
        dur = audio.size / self.sample_rate
        n_seg = max(1, int(np.ceil(dur / self.segment_seconds))) if audio.size else 0
        segments = []
        for i in range(n_seg):
            start = i * self.segment_seconds
            end = min(dur, start + self.segment_seconds)
            chunk = audio[int(start * self.sample_rate) : int(end * self.sample_rate)]
            digest = hashlib.sha1(chunk.tobytes()).hexdigest()[:8]
            segments.append(TranscribeSegment(
                text=f"seg{i}-{digest} ", speaker_id=0, start=start, end=end))
        n_tokens = 2 * len(segments)  # deterministic usage-accounting stand-in
        if params.stream_mode and segments:
            segments = [segments[-1]]
        return TranscribeResult(
            segments=segments,
            full_text="".join(s.text for s in segments),
            language=params.language or "en",
            n_tokens=n_tokens,
        )
