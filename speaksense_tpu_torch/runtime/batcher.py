"""BatchedEngine: cross-request window batching, the counterpart of
`speaksense_tpu/runtime/batcher.py`.

Callers (REST task workers, the CLI, non-pooled stream chunks) submit mel
windows; a collector thread drains the queue, groups compatible windows
(same mel length / task / suppression mode / diarization), pads the group to
`max_batch` by replicating row 0, and runs one `decode_windows` call for all
of them. BatchedEngine implements the port's AsrEngine interface.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np
import torch

from speaksense_tpu_torch.asr import AsrEngine, AsrParams, TranscribeResult
from speaksense_tpu_torch.asr.engine import WhisperEngine
from speaksense_tpu_torch.utils.metrics import REGISTRY as METRICS

log = logging.getLogger(__name__)


@dataclass
class _WindowJob:
    mel: torch.Tensor            # (T_mel, n_mels)
    language: str | None
    task: str
    suppress_non_speech: bool
    context: list | None = None  # previous-text conditioning tokens
    speaker_diarization: bool = False
    temperature: float = 0.0     # user-requested initial sampling temp
    future: Future = field(default_factory=Future)

    @property
    def group_key(self):
        return (self.mel.shape[0], self.task, self.suppress_non_speech,
                self.speaker_diarization)


class BatchedEngine(AsrEngine):
    def __init__(self, engine: WhisperEngine, max_batch: int | None = None,
                 max_wait_ms: float = 5.0):
        self.engine = engine
        self.max_batch = max_batch or engine.config.max_batch_size
        self.max_wait_s = max_wait_ms / 1000.0
        self._queue: "queue.Queue[_WindowJob]" = queue.Queue()
        self._stop = threading.Event()
        # telemetry
        self.batches_run = 0
        self.windows_run = 0
        self._thread = threading.Thread(target=self._loop, name="batch-engine", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- batching

    def submit_window(self, mel, language: str | None, task: str,
                      suppress_non_speech: bool, context: list | None = None,
                      speaker_diarization: bool = False,
                      temperature: float = 0.0) -> Future:
        """mel: (T_mel, n_mels), numpy or tensor (kept on its device)."""
        job = _WindowJob(torch.as_tensor(mel), language, task, suppress_non_speech,
                         context, speaker_diarization, temperature)
        self._queue.put(job)
        return job.future

    def _decode_window(self, mel, language, task, suppress_non_speech,
                       context=None, speaker_diarization=False, temperature=0.0) -> dict:
        """decode_window hook for WhisperEngine.transcribe_audio: one window
        through the shared batch."""
        if mel.ndim == 3:
            mel = mel[0]
        return self.submit_window(mel, language, task, suppress_non_speech, context,
                                  speaker_diarization, temperature).result()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            # max_wait is a total deadline for collecting one batch
            deadline = time.monotonic() + self.max_wait_s
            leftovers: list[_WindowJob] = []
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                try:
                    job = (self._queue.get(timeout=remaining) if remaining > 0
                           else self._queue.get_nowait())
                except queue.Empty:
                    break
                if job.group_key == first.group_key:
                    batch.append(job)
                else:
                    leftovers.append(job)
            for job in leftovers:  # different group: requeue for the next round
                self._queue.put(job)
            self._run_batch(batch)

    def _run_batch(self, batch: list[_WindowJob]) -> None:
        try:
            dev = self.engine.device
            mels = torch.stack([j.mel.to(dev) for j in batch])
            # pad rows replicate row 0 (same mel and language), so they follow
            # row 0's own accept/retry behaviour instead of decoding garbage
            pad = self.max_batch - len(batch)
            if pad > 0:
                mels = torch.cat([mels, mels[:1].expand(pad, *mels.shape[1:])])
            langs = [j.language for j in batch] + [batch[0].language] * pad
            contexts = [j.context or [] for j in batch] + [[]] * pad
            temps = [j.temperature for j in batch] + [batch[0].temperature] * pad
            results = self.engine.decode_windows(
                mels, langs, task=batch[0].task,
                suppress_non_speech=batch[0].suppress_non_speech,
                speaker_diarization=batch[0].speaker_diarization,
                temperatures=temps if any(temps) else None,
                context_tokens=contexts if any(contexts) else None)
            self.batches_run += 1
            self.windows_run += len(batch)
            METRICS.inc("asr_batches_total")
            METRICS.set_gauge("asr_batch_occupancy", len(batch) / self.max_batch)
            for job, res in zip(batch, results):
                job.future.set_result(res)
        except Exception as e:
            # the collector thread must keep serving: fail this batch's
            # callers with the error and go on
            log.error("batched decode failed: %s", e, exc_info=True)
            for job in batch:
                if not job.future.done():
                    job.future.set_exception(e)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
        # resolve abandoned jobs so no caller blocks forever
        err = RuntimeError("batch engine stopped")
        while True:
            try:
                job = self._queue.get_nowait()
            except queue.Empty:
                break
            if not job.future.done():
                job.future.set_exception(err)

    # ------------------------------------------------------- AsrEngine API

    def create_state(self):
        return self.engine.create_state()

    def transcribe_with_state(self, state, audio, params: AsrParams) -> TranscribeResult:
        return self.engine.transcribe_with_state(state, audio, params,
                                                 decode_window=self._decode_window)

    def transcribe_audio(self, audio, params: AsrParams) -> TranscribeResult:
        return self.engine.transcribe_audio(np.asarray(audio, np.float32), params,
                                            decode_window=self._decode_window)

    def transcribe_audio_vad(self, audio, params: AsrParams) -> TranscribeResult:
        return self.engine.transcribe_audio_vad(np.asarray(audio, np.float32), params,
                                                decode_window=self._decode_window)

    def detect_language(self, audio) -> str:
        return self.engine.detect_language(audio)

    # ---------------------------------------------- slot-pool fast paths
    # StreamSession probes its engine for these (serving/stream.py). Without
    # them a session over this wrapper would denoise on the host and decode
    # every chunk sequentially.

    @property
    def device_denoise(self) -> bool:
        return self.engine.device_denoise

    def submit_stream_chunk(self, state, audio, params: AsrParams,
                            pad_to_bucket: bool = False):
        """None (no pool, an off-bucket chunk, the conditioning bound) sends
        the caller to the sequential path, transcribe_with_state, which
        routes window-path chunks through this batcher."""
        return self.engine.submit_stream_chunk(state, audio, params,
                                               pad_to_bucket=pad_to_bucket)
