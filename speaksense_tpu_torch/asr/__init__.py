"""The ASR interface of the port: the port's own copy of
`speaksense_tpu/asr/__init__.py`, with the same names and behaviour.

`AsrParams`, `TranscribeSegment`, `TranscribeResult` and the `AsrEngine`
interface (create_state / transcribe_with_state / transcribe). The PyTorch
implementation lives in asr/engine.py. The JAX package's serving layer still
takes the port's engines by duck typing: they have the same methods and
return values with the same fields.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field


@dataclass
class AsrParams:
    """User-facing knobs (reference src/asr/mod.rs:10-15 + defaults :17-26)."""

    language: str | None = None
    speaker_diarization: bool = False
    stream_mode: bool = False
    min_segment_length: int = 10
    task: str = "transcribe"
    # extensions over the reference (it hardcodes these in build_params)
    temperature: float = 0.0
    condition_on_previous_text: bool = True
    suppress_non_speech: bool = False   # reference disables suppression (whisper.rs:152)
    word_timestamps: bool = False
    denoise: bool = False  # device-side DSP denoise for stream chunks (set by
    #                        StreamSession when the engine supports it)


@dataclass
class TranscribeSegment:
    text: str
    speaker_id: int = 0
    start: float = 0.0   # seconds
    end: float = 0.0     # seconds
    words: list | None = None  # [{word,start,end}] when word_timestamps on

    def to_dict(self) -> dict:
        d = {"text": self.text, "speaker_id": self.speaker_id,
             "start": self.start, "end": self.end}
        if self.words is not None:
            d["words"] = self.words
        return d


@dataclass
class TranscribeResult:
    segments: list[TranscribeSegment] = field(default_factory=list)
    full_text: str = ""
    language: str | None = None
    # decoder tokens sampled to produce this result (usage accounting)
    n_tokens: int = 0

    def to_dict(self) -> dict:
        return {"segments": [s.to_dict() for s in self.segments], "full_text": self.full_text}


class AsrEngine(abc.ABC):
    """Engine interface (reference trait at src/asr/mod.rs:58-73).

    A *state* is the per-stream decode context: a lightweight host handle
    (conditioning text and bookkeeping); the device KV lives in the engine's
    batched slot pool, so many states share one decode batch.
    """

    @abc.abstractmethod
    def create_state(self): ...

    @abc.abstractmethod
    def transcribe_with_state(self, state, audio, params: AsrParams) -> TranscribeResult: ...

    def transcribe(self, audio, params: AsrParams) -> TranscribeResult:
        return self.transcribe_with_state(self.create_state(), audio, params)
