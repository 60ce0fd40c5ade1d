"""Task processors.

The port's own copy of `speaksense_tpu/schedule/processors.py`,
with the same names and behaviour.

Mirror of the reference's src/schedule/processors/: the TaskProcessor
interface (mod.rs:10-16) and TranscribeProcessor (transcribe.rs), which
downloads/locates the input, runs the audio pipeline + ASR engine, and
returns a TranscribeTaskResult.

Difference from the reference: it pipes 30 s buffers one at a time through
a mutex'd whisper state (transcribe.rs:102-142); ours hands the whole audio
to the engine's `transcribe` (or `transcribe_audio_vad`), which windows with
timestamp-seek and batches the windows of many tasks on the card
(`runtime/batcher.py`). Every module it calls is the port's own: the
engine, `audio/{io,dsp,emotion,voiceprint}.py`, `asr/postprocess.py` and
`utils/http.py`.
"""

from __future__ import annotations

import abc
import logging
import os
from pathlib import Path

import numpy as np

from speaksense_tpu_torch.asr import AsrEngine, AsrParams
from speaksense_tpu_torch.schedule.types import (
    PathType, ResultSegment, Task, TaskConfig, TaskResult, TaskType,
    TranscribeTaskResult,
)

log = logging.getLogger(__name__)

SUPPORTED_LANGUAGES = ("zh", "en", "ja")  # transcribe.rs:196-217


class TaskProcessor(abc.ABC):
    @property
    @abc.abstractmethod
    def task_type(self) -> TaskType: ...

    @abc.abstractmethod
    def process(self, task: Task) -> TaskResult: ...

    def validate_params(self, config: TaskConfig) -> None:
        """Raise ValueError on invalid params."""

    def cancel(self, task: Task) -> None:
        raise NotImplementedError("cancel not supported")  # transcribe.rs:219-223

    def cleanup(self, task: Task) -> None:
        """Remove task-local artifacts."""


class TranscribeProcessor(TaskProcessor):
    def __init__(self, engine: AsrEngine, audio_dir: str = "./asr_data/audio/",
                 denoise: bool = False, vad_segmentation: bool = False):
        self.engine = engine
        self.audio_dir = audio_dir
        self.denoise = denoise
        # VAD-driven segmentation: only voiced spans reach the card
        self.vad_segmentation = vad_segmentation

    @property
    def task_type(self) -> TaskType:
        return TaskType.TRANSCRIBE

    def validate_params(self, config: TaskConfig) -> None:
        if config.task_type is not TaskType.TRANSCRIBE:
            raise ValueError("TranscribeProcessor only handles Transcribe tasks")
        params = config.params.params
        lang = getattr(params, "language", None)
        if lang is not None and lang not in SUPPORTED_LANGUAGES:
            raise ValueError(
                f"unsupported language {lang!r}; supported: {', '.join(SUPPORTED_LANGUAGES)}")
        if not config.input_path:
            raise ValueError("input_path is required")

    def _resolve_input(self, task: Task) -> tuple[Path, bool]:
        """URL -> download into audio_dir (utils/http.rs:21); Local -> as-is.
        Returns (path, should_delete_after)."""
        cfg = task.config
        if cfg.path_type is PathType.URL:
            from speaksense_tpu_torch.utils.http import download_audio

            # task-id prefix: concurrent workers downloading same-basename
            # URLs must not overwrite/delete each other's files
            return download_audio(cfg.input_path, self.audio_dir,
                                  prefix=task.id), True
        path = Path(cfg.input_path)
        if not path.is_file():
            raise FileNotFoundError(f"input audio not found: {path}")
        # the reference deletes even local inputs after processing
        # (transcribe.rs:153-156); we only delete files we downloaded
        return path, False

    def process(self, task: Task) -> TaskResult:
        from speaksense_tpu_torch.audio.io import load_audio

        path, delete_after = self._resolve_input(task)
        try:
            audio = load_audio(path)
            if self.denoise:
                from speaksense_tpu_torch.audio.dsp import DenoiseConfig, denoise_audio

                audio = denoise_audio(audio, DenoiseConfig(post_gain=1.0))
            p = task.config.params.params
            asr_params = AsrParams(
                language=getattr(p, "language", None),
                speaker_diarization=getattr(p, "speaker_diarization", False),
            )
            if self.vad_segmentation and hasattr(self.engine, "transcribe_audio_vad"):
                result = self.engine.transcribe_audio_vad(
                    np.asarray(audio, np.float32), asr_params)
            else:
                result = self.engine.transcribe(np.asarray(audio, np.float32), asr_params)
            segments = [
                ResultSegment(
                    text=s.text,
                    speaker_id=s.speaker_id if asr_params.speaker_diarization else None,
                    start_time=s.start, end_time=s.end)
                for s in result.segments
            ]
            full_text = result.full_text
            if getattr(p, "filter_dirty_words", False):
                # functional filter_dirty_words (the reference accepts the
                # flag at web/handlers/asr.rs:36-46 but never reads it)
                from speaksense_tpu_torch.asr.postprocess import filter_dirty_words

                full_text = filter_dirty_words(full_text)
                for seg in segments:
                    seg.text = filter_dirty_words(seg.text)
            if getattr(p, "emotion_recognition", False):
                # functional emotion_recognition (the reference accepts the
                # flag at web/handlers/asr.rs:36-46 but never reads it):
                # classify each segment's audio span prosodically
                from speaksense_tpu_torch.audio.emotion import classify_emotion

                sr = 16000
                for seg in segments:
                    lo = max(0, int(seg.start_time * sr))
                    hi = min(audio.size, int(seg.end_time * sr))
                    if hi > lo:
                        seg.emotion, _ = classify_emotion(audio[lo:hi], sr)
            return TaskResult.transcribe(
                TranscribeTaskResult(text=full_text, segments=segments,
                                     n_tokens=result.n_tokens,
                                     audio_seconds=audio.size / 16000.0))
        finally:
            if delete_after:
                try:
                    os.remove(path)
                except OSError as e:
                    log.warning("failed to remove %s: %s", path, e)

    def cleanup(self, task: Task) -> None:
        if task.config.path_type is PathType.URL:
            name = task.config.input_path.rstrip("/").rsplit("/", 1)[-1]
            p = Path(self.audio_dir) / f"{task.id}_{name}"
            if p.is_file():
                p.unlink(missing_ok=True)


class NoiseReductionProcessor(TaskProcessor):
    """Functional NoiseReduction task (the reference declares the TaskType at
    types.rs:11 but never implements a processor): denoise the input with the
    DSP pipeline and write <name>.denoised.wav next to the audio dir."""

    def __init__(self, audio_dir: str = "./asr_data/audio/"):
        self.audio_dir = audio_dir

    @property
    def task_type(self) -> TaskType:
        return TaskType.NOISE_REDUCTION

    def validate_params(self, config: TaskConfig) -> None:
        if not config.input_path:
            raise ValueError("input_path is required")

    def process(self, task: Task) -> TaskResult:
        from speaksense_tpu_torch.audio.dsp import DenoiseConfig, denoise_audio
        from speaksense_tpu_torch.audio.io import load_audio, write_wav

        cfg = task.config
        if cfg.path_type is PathType.URL:
            from speaksense_tpu_torch.utils.http import download_audio

            path = download_audio(cfg.input_path, self.audio_dir,
                                  prefix=task.id)
        else:
            path = Path(cfg.input_path)
        audio = load_audio(path)
        cleaned = denoise_audio(audio, DenoiseConfig(post_gain=1.0))
        out_path = Path(self.audio_dir) / (path.stem + ".denoised.wav")
        write_wav(out_path, cleaned)
        return TaskResult(TaskType.NOISE_REDUCTION, {"output_path": str(out_path)})


class VoiceprintProcessor(TaskProcessor):
    """Functional VoiceprintRecognition task (the reference declares the
    TaskType at types.rs:8-13 but never implements a processor): compute a
    deterministic MFCC-statistics speaker embedding (audio/voiceprint.py)
    and optionally verify it against a reference.

    Params (plain dict, like the reference's untyped variants):
      - ``compare_with``: path of a second audio file — result carries the
        cosine similarity and a match verdict;
      - ``reference_print``: a previously returned embedding (list[float])
        to verify against instead;
      - ``threshold``: similarity acceptance threshold (default
        voiceprint.DEFAULT_THRESHOLD).
    """

    def __init__(self, audio_dir: str = "./asr_data/audio/"):
        self.audio_dir = audio_dir

    @property
    def task_type(self) -> TaskType:
        return TaskType.VOICEPRINT_RECOGNITION

    def validate_params(self, config: TaskConfig) -> None:
        if not config.input_path:
            raise ValueError("input_path is required")
        p = config.params.params if config.params else {}
        ref = p.get("reference_print") if isinstance(p, dict) else None
        if ref is not None:
            from speaksense_tpu_torch.audio.voiceprint import EMBED_DIM

            if (isinstance(ref, (str, bytes)) or not hasattr(ref, "__len__")
                    or len(ref) != EMBED_DIM
                    or not all(isinstance(v, (int, float)) for v in ref)):
                raise ValueError(
                    f"reference_print must be a list of {EMBED_DIM} floats")

    def _load(self, path_str: str, path_type: PathType,
              prefix: str = "") -> np.ndarray:
        from speaksense_tpu_torch.audio.io import load_audio

        if path_type is PathType.URL:
            from speaksense_tpu_torch.utils.http import download_audio

            return load_audio(download_audio(path_str, self.audio_dir,
                                             prefix=prefix))
        path = Path(path_str)
        if not path.is_file():
            raise FileNotFoundError(f"input audio not found: {path}")
        return load_audio(path)

    def process(self, task: Task) -> TaskResult:
        from speaksense_tpu_torch.audio.voiceprint import (
            DEFAULT_THRESHOLD, cosine_similarity, voiceprint_embedding,
        )

        cfg = task.config
        p = cfg.params.params if cfg.params else {}
        if not isinstance(p, dict):
            p = {}
        emb = voiceprint_embedding(
            self._load(cfg.input_path, cfg.path_type, prefix=task.id))
        out: dict = {"embedding": [round(float(v), 6) for v in emb],
                     "dim": int(emb.size)}
        ref = None
        if p.get("reference_print") is not None:
            ref = np.asarray(p["reference_print"], np.float32)
        elif p.get("compare_with"):
            ref = voiceprint_embedding(
                self._load(str(p["compare_with"]), PathType.LOCAL))
        if ref is not None:
            thr = float(p.get("threshold", DEFAULT_THRESHOLD))
            sim = cosine_similarity(emb, ref)
            out.update(similarity=round(sim, 6), threshold=thr,
                       match=bool(sim >= thr))
        return TaskResult(TaskType.VOICEPRINT_RECOGNITION, out)
