"""Token-level continuous batching on the card: the slot-pool decode server,
the counterpart of `speaksense_tpu/runtime/slots.py`.

A pool of S decode slots shares one decode step. Windows join free slots
between steps while other slots are mid-decode, and a slot frees the moment
its window emits EOT or reaches the token budget, so streams never wait for
each other's windows.

KV memory: the pages are preallocated, one row per slot (`D.PoolState`,
`W.init_pool_pages`): self-KV (L, S, H, t_text, Dh) sized to the prompt and
generation budget, and cross-KV (L, S, H, A, Dh). Admission writes a
window's prefilled KV into its slot's row in place (`W.prefill_into_pool`);
retirement only marks the slot free. Each slot decodes at its own position
and writes its own column (`D.pool_step`), so the reference's ring buffer,
circular pages, k-steps-per-dispatch scan and select-form writes, which
work around XLA on the TPU, have no counterpart here.

Admission takes raw 16 kHz PCM (s16 as it came off the wire, or f32) or a
log-mel: s16 dequantization, the denoise branch the host classifier picked,
the log-mel, the encoder (the hand-written flash kernel on the card),
cross-KV and prompt prefill all run on the device. Retirement reads one
packed copy of the per-slot results after every step; admission and
retirement both run on the server thread between steps, so a recycled slot
can never be retired with its previous occupant's values.
"""

from __future__ import annotations

import logging
import queue
import threading
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np
import torch

from speaksense_tpu_torch.audio import dsp as DSP
from speaksense_tpu_torch.audio import mel as MEL
from speaksense_tpu_torch.models import decode as D
from speaksense_tpu_torch.models import whisper as W

log = logging.getLogger(__name__)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to speaksense_tpu_torch yet (ROADMAP.md Queue 1, "
        f"remaining: {item})")


_INT8 = "int8 paths (int8 weights, int8 cross-KV, int8 self-KV)"
_BEAM = "beam search and the beam pool"
_MULTI = "multi-GPU"


@dataclass
class _StreamJob:
    mel: np.ndarray                  # (T_mel, n_mels) log-mel, or
    #                                  (t_mel*HOP,) s16 or f32 PCM when is_audio
    prompt: list[int]
    future: Future = field(default_factory=Future)
    slot: int = -1
    is_audio: bool = False
    denoise: str | None = None       # device denoise branch, or None
    sot_index: int = 0               # position of <|sot|> in prompt: the
    #                                  no-speech probability reads the
    #                                  prefill logits at this row
    temperature: float = 0.0         # > 0 on quality-fallback retries
    admit_tstep: int = 0             # pool.total_steps when admitted


class SlotPool:
    """Device-resident decode state for S slots, and host-side occupancy."""

    # rows per admission: the reference's largest admission bucket (eager
    # PyTorch needs no padding of a smaller batch to a bucket)
    ADMIT_BUCKET = 8

    def __init__(self, engine, n_slots: int, t_mel: int, max_new: int,
                 max_prompt: int = 16):
        self.engine = engine
        self.model = engine.model
        self.dims = engine.dims
        self.device = engine.device
        self.S = n_slots
        self.t_mel = t_mel
        self.n_audio_ctx = min(t_mel // 2, self.dims.n_audio_ctx)
        self.max_new = max_new
        self.max_prompt = max_prompt
        self.cfg = D.RuleConfig.from_tokenizer(
            engine.tokenizer, max_initial_ts=engine.config.max_initial_ts,
            max_new_tokens=max_new)
        self.suppress = engine._suppress[(False, False)]
        # self-KV columns per slot: the padded prompt plus the generation
        # budget, rounded up to 128 as the reference sizes its pages
        if max_prompt + max_new > self.dims.n_text_ctx:
            raise ValueError(f"max_prompt + max_new = {max_prompt + max_new} exceeds "
                             f"the decoder context of {self.dims.n_text_ctx}")
        self.t_text = min(self.dims.n_text_ctx, (max_prompt + max_new + 127) // 128 * 128)
        # telemetry: admission batching and occupancy
        self.admit_calls = 0
        self.admit_rows = 0
        self.step_calls = 0
        self.occupancy_sum = 0
        self.total_steps = 0
        self._init_state()

    def _init_state(self) -> None:
        """(Re)build the device state and its host mirrors. Ends with a read
        from the device, so a sticky CUDA error raises here."""
        self.state = None  # let the old pages go before allocating new ones
        self.state = D.PoolState.empty(self.model, self.S, self.max_new, self.t_text,
                                       self.n_audio_ctx, self.cfg.eot, self.device)
        self.free: list[int] = list(range(self.S))
        self.jobs: dict[int, _StreamJob] = {}
        # host mirror of "some slot samples at t > 0": the all-greedy step
        # then never waits for the device to find out
        self._hot: set[int] = set()
        bool(self.state.active.any())

    def reset(self, error: Exception | None = None) -> None:
        """Fail every registered job and rebuild the pool from fresh state:
        the recovery path after a failed step or admission."""
        err = error or RuntimeError("slot pool reset")
        for job in self.jobs.values():
            if not job.future.done():
                job.future.set_exception(err)
        self.jobs.clear()
        self._init_state()

    def state_healthy(self) -> bool:
        """False when the device cannot be read, e.g. after a sticky CUDA
        error."""
        try:
            bool(self.state.active.any())
            return True
        except Exception:
            return False

    # ------------------------------------------------------------- admission

    def _prompt_buckets(self) -> tuple[int, ...]:
        """Padded-prompt width buckets: 4 covers plain SOT sequences, 16 the
        timestamped ones, max_prompt the conditioned rows."""
        return tuple(sorted({b for b in (4, 16, self.max_prompt) if b <= self.max_prompt}))

    def _encode_batch(self, batch: list[_StreamJob]) -> torch.Tensor:
        """Stacked job inputs -> f32 encoder states (n, n_audio_ctx, d)."""
        if batch[0].is_audio:
            want = (self.t_mel * MEL.HOP_LENGTH,)
        else:
            want = (self.t_mel, self.dims.n_mels)
        for job in batch:
            if job.mel.shape != want:
                raise ValueError(f"pool input shape {job.mel.shape} != {want}")
        x = torch.as_tensor(np.stack([j.mel for j in batch]), device=self.device)
        if batch[0].is_audio:
            x = MEL.pcm_to_f32(x)
            if batch[0].denoise:
                x = DSP.denoise_audio_torch(x, DSP.DenoiseConfig(post_gain=1.0),
                                            branch=batch[0].denoise)
            x = MEL.log_mel_spectrogram(x, n_mels=self.dims.n_mels,
                                        filters=self.engine.mel_filters, pad_to_chunk=False)
        return W.encode(self.model, x, n_ctx_out=self.n_audio_ctx)

    @torch.no_grad()
    def admit_many(self, jobs: list[_StreamJob]) -> int:
        """Admit up to one bucket's worth of jobs in a single admission.
        Returns how many were admitted (0 if the pool is full)."""
        take = min(len(jobs), len(self.free), self.ADMIT_BUCKET)
        if take == 0:
            return 0
        # one admission per input kind: the leading run of jobs with the
        # same input kind, denoise branch and dtype
        kind = (jobs[0].is_audio, jobs[0].denoise, jobs[0].mel.dtype)
        batch = []
        for j in jobs[:take]:
            if (j.is_audio, j.denoise, j.mel.dtype) != kind:
                break
            batch.append(j)
        take = len(batch)
        try:
            P = max(len(j.prompt) for j in batch)
            if P > self.max_prompt:
                raise ValueError(f"pool prompt of {P} tokens exceeds "
                                 f"max_prompt={self.max_prompt}")
            P = next(b for b in self._prompt_buckets() if b >= P)
            prompts = np.full((take, P), self.cfg.eot, np.int64)
            for i, job in enumerate(batch):
                job.slot = self.free.pop()
                job.admit_tstep = self.total_steps
                prompts[i, :len(job.prompt)] = job.prompt
                self.jobs[job.slot] = job

            dev = self.device
            st = self.state
            slots = torch.as_tensor([j.slot for j in batch], dtype=torch.long, device=dev)
            plen = torch.as_tensor([len(j.prompt) for j in batch], dtype=torch.long, device=dev)
            sot = torch.as_tensor([j.sot_index for j in batch], dtype=torch.long, device=dev)
            rows = torch.arange(take, device=dev)
            enc = self._encode_batch(batch)
            logits = W.prefill_into_pool(self.model, enc, torch.as_tensor(prompts, device=dev),
                                         st.pages, slots)
            st.last_logits[slots] = logits[rows, plen - 1]
            # no-speech probability at the SOT position (openai's
            # probs_at_sot), read at settle against no_speech_thold
            st.ns_prob[slots] = torch.softmax(logits[rows, sot], dim=-1)[:, self.cfg.no_speech]
            st.temp[slots] = torch.as_tensor([j.temperature for j in batch],
                                             dtype=torch.float32, device=dev)
            st.plen[slots] = plen
            st.ppad[slots] = P
            st.tokens[slots] = self.cfg.eot
            for t in (st.n_sampled, st.last, st.penult, st.last_ts, st.sum_lp):
                t[slots] = 0
            st.active[slots] = True   # last: a failure above leaves the slots inactive
        except Exception as e:
            # roll the batch back: a failed admission must not kill the
            # server thread or strand these futures; the other slots'
            # rows were not written
            for job in batch:
                if job.slot >= 0 and self.jobs.get(job.slot) is job:
                    del self.jobs[job.slot]
                    self.free.append(job.slot)
                    job.slot = -1
                if not job.future.done():
                    job.future.set_exception(e)
            del jobs[:take]          # the caller must not resubmit the batch
            raise
        self._hot.update(j.slot for j in batch if j.temperature > 0.0)
        self.admit_calls += 1
        self.admit_rows += take
        return take

    # ------------------------------------------------------------ decoding

    def step(self) -> list[_StreamJob]:
        """One pool-wide decode step; returns the jobs that finished."""
        finished = D.pool_step(self.model, self.cfg, self.suppress, self.state,
                               self.engine._rng, hot=bool(self._hot))
        self.step_calls += 1
        self.total_steps += 1
        self.occupancy_sum += len(self.jobs)
        return self._retire(finished)

    def _retire(self, finished: torch.Tensor) -> list[_StreamJob]:
        """Complete the futures of the slots that finished at this step and
        recycle the slots. One packed device-to-host copy per step."""
        st = self.state
        S = self.S
        meta = torch.cat([finished.int(), st.n_sampled.int(),
                          st.sum_lp.view(torch.int32), st.ns_prob.view(torch.int32),
                          st.tokens.int().reshape(-1)]).cpu().numpy()
        fin = meta[:S] != 0
        if not fin.any():
            return []
        n_sampled = meta[S:2 * S]
        sum_lp = meta[2 * S:3 * S].view(np.float32)
        ns_prob = meta[3 * S:4 * S].view(np.float32)
        tokens = meta[4 * S:].reshape(S, self.max_new)
        done: list[_StreamJob] = []
        for slot in np.flatnonzero(fin).tolist():
            job = self.jobs.pop(slot, None)
            if job is None:      # a free row has nothing to report
                continue
            self._hot.discard(slot)
            self.free.append(slot)
            n, lp = int(n_sampled[slot]), float(sum_lp[slot])
            job.future.set_result(dict(
                tokens=tokens[slot].copy(), n_sampled=n, sum_logprob=lp,
                avg_logprob=lp / (n + 1), no_speech_prob=float(ns_prob[slot]),
                temperature=job.temperature))
            done.append(job)
        return done

    @property
    def n_active(self) -> int:
        return len(self.jobs)

    def all_jobs_at_budget(self) -> bool:
        """True iff every occupant has taken max_new steps since admission.
        Such a job has reached its cap, and `step` retires it at that same
        step, so after any `step` this is False: the invariant that no job
        outlives its token budget."""
        if not self.jobs:
            return False
        return all(self.total_steps - j.admit_tstep >= self.max_new
                   for j in self.jobs.values())


class StreamingDecodeServer:
    """Background thread driving a SlotPool: submit windows, get futures."""

    def __init__(self, engine, n_slots: int = 16, t_mel: int = 3000,
                 max_new: int = 128, int8_kv: bool = False, self_int8: bool = False,
                 max_prompt: int = 16, mesh=None, beam_size: int = 1):
        if int8_kv or self_int8:
            raise _not_ported("an int8 slot pool", _INT8)
        if beam_size and beam_size > 1:
            raise _not_ported("the beam slot pool", _BEAM)
        if mesh is not None:
            raise _not_ported("a sharded slot pool", _MULTI)
        self.engine = engine
        self.pool = SlotPool(engine, n_slots, t_mel, max_new, max_prompt=max_prompt)
        self._queue: "queue.Queue[_StreamJob]" = queue.Queue()
        self._stop = threading.Event()
        # the fatal exception once the pool could not be rebuilt: new
        # submissions are then rejected instead of queueing on a dead loop
        self._dead: Exception | None = None
        # jobs taken off the queue but not yet admitted (the pool was full);
        # stop() fails them after the loop ends
        self._pending: list[_StreamJob] = []
        self._thread = threading.Thread(target=self._loop, name="slot-server", daemon=True)
        self._thread.start()

    def _build_prompt(self, language: str | None, task: str,
                      context: list[int] | None) -> tuple[list[int], int]:
        """[<|startofprev|>] + context[-cap:] + SOT sequence within the
        pool's max_prompt budget (16-token pools carry no context). Returns
        (prompt, sot_index)."""
        tok = self.engine.tokenizer
        sot = list(tok.sot_sequence(language or "en", task=task))
        cap = self.pool.max_prompt - len(sot) - 1
        if context and cap > 0:
            prompt = [tok.sot_prev] + list(context)[-cap:] + sot
            return prompt, len(prompt) - len(sot)
        return sot, 0

    def submit(self, mel: np.ndarray, language: str | None = "en", task: str = "transcribe",
               context: list[int] | None = None, temperature: float = 0.0) -> Future:
        """A log-mel window (t_mel, n_mels). context: previous-text
        conditioning tokens; temperature > 0: a quality-fallback retry."""
        prompt, sot_index = self._build_prompt(language, task, context)
        return self._put(_StreamJob(np.asarray(mel), prompt, sot_index=sot_index,
                                    temperature=float(temperature)))

    def submit_audio(self, audio: np.ndarray, language: str | None = "en",
                     task: str = "transcribe", context: list[int] | None = None,
                     denoise: bool = False, temperature: float = 0.0) -> Future:
        """Raw 16 kHz PCM, padded or cut to the pool's t_mel bucket. s16 is
        kept as it is and dequantized on the device; other dtypes become
        f32 here. With denoise=True the host classifier picks the branch
        and the device runs it."""
        n = self.pool.t_mel * MEL.HOP_LENGTH
        a = np.asarray(audio).reshape(-1)[:n]
        if a.dtype != np.int16:
            a = a.astype(np.float32, copy=False)
        if a.size < n:
            a = np.pad(a, (0, n - a.size))
        prompt, sot_index = self._build_prompt(language, task, context)
        branch = None
        if denoise:
            # the classifier's thresholds are amplitude-absolute: it reads
            # the reference-scaled f32 view even when the upload stays s16
            branch = DSP.classify_noise(a.astype(np.float32) / 32767.0
                                        if a.dtype == np.int16 else a)
        return self._put(_StreamJob(a, prompt, is_audio=True, denoise=branch,
                                    sot_index=sot_index, temperature=float(temperature)))

    def _fatal(self, e2: Exception) -> None:
        """Declare the server dead after an unrecoverable pool failure: fail
        every registered and queued future and reject new submissions."""
        self._dead = e2
        for job in list(self.pool.jobs.values()):
            if not job.future.done():
                job.future.set_exception(e2)
        self.pool.jobs.clear()
        self._drain(e2)

    def _drain(self, err: Exception) -> None:
        while True:
            try:
                job = self._queue.get_nowait()
            except queue.Empty:
                break
            if not job.future.done():
                job.future.set_exception(err)

    def _put(self, job: _StreamJob) -> Future:
        """Enqueue a job. If the server went dead between the check and the
        put, nothing will drain the queue again: fail the job here."""
        if self._dead is not None:
            raise RuntimeError("slot server dead") from self._dead
        self._queue.put(job)
        if self._dead is not None and not job.future.done():
            try:
                job.future.set_exception(RuntimeError("slot server dead"))
            except Exception:  # already resolved by the drain
                pass
        return job.future

    def _loop(self) -> None:
        pending = self._pending
        while not self._stop.is_set():
            # drain the submit queue (block briefly only when idle), then
            # admit between steps: token-granularity continuous batching
            while True:
                try:
                    timeout = 0.0 if pending or self.pool.n_active else 0.05
                    pending.append(self._queue.get(timeout=timeout) if timeout
                                   else self._queue.get_nowait())
                except queue.Empty:
                    break
            while pending and self.pool.free:
                try:
                    n = self.pool.admit_many(pending)
                except Exception as e:
                    # admit_many failed the batch's futures and rolled its
                    # slots back; rebuild only if the device state cannot
                    # be read any more
                    log.error("admission failed: %s", e, exc_info=True)
                    if not self.pool.state_healthy():
                        try:
                            self.pool.reset(e)
                        except Exception as e2:
                            log.error("pool reset failed; slot server dead: %s", e2,
                                      exc_info=True)
                            for job in pending:
                                if not job.future.done():
                                    job.future.set_exception(e2)
                            self._fatal(e2)
                            return
                    break
                if n == 0:
                    break
                del pending[:n]
            if not self.pool.n_active:
                continue
            try:
                self.pool.step()
            except Exception as e:
                log.error("pool step failed: %s", e, exc_info=True)
                # fail the queued-but-unadmitted jobs too, then rebuild from
                # fresh pages; a sticky CUDA error makes the rebuild fail
                # and the server dead
                for job in pending:
                    if not job.future.done():
                        job.future.set_exception(e)
                pending.clear()
                try:
                    self.pool.reset(e)
                except Exception as e2:
                    log.error("pool reset failed; slot server dead: %s", e2, exc_info=True)
                    self._fatal(e2)
                    return

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
        # resolve every stranded future: settlers block on future.result()
        err = RuntimeError("slot server stopped")
        # dead before the drain, so a submit racing stop() fails in _put
        if self._dead is None:
            self._dead = err
        for job in list(self.pool.jobs.values()) + self._pending:
            if not job.future.done():
                job.future.set_exception(err)
        self.pool.jobs.clear()
        self._pending.clear()
        self._drain(err)
