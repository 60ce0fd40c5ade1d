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
and writes its own column (`D.pool_step`), so the reference's circular
pages, k-steps-per-dispatch scan and select-form writes, which work around
XLA on the TPU, have no counterpart here.

int8_kv stores the cross-KV in int8 with per-channel scales. self_int8
stores the self-KV pages in int8 with per-token scales behind a ring of
RING_WIDTH rows in the compute dtype: the pool's steps write ring row
(steps mod RING_WIDTH), and the step that fills the ring quantizes it into
each slot's own columns, so which of a slot's columns are int8 at a given
step is the reference's (its pool flushes its 16-row ring every 16 global
steps). With beam_size > 1 the server runs the beam pool
(`runtime/beam_slots.py`) instead.

Admission takes raw 16 kHz PCM (s16 as it came off the wire, or f32) or a
log-mel: s16 dequantization, the denoise branch the host classifier picked,
the log-mel, the encoder (the hand-written flash kernel on the card),
cross-KV and prompt prefill all run on the device. Retirement reads one
packed copy of the per-slot results after every step; admission and
retirement both run on the server thread between steps, so a recycled slot
can never be retired with its previous occupant's values.

On a sharded engine (`mesh`) the pool has the reference's S + 1 rows (row S
a scratch row that never activates), split over dp: each dp replica holds
(S + 1) / dp consecutive rows and the heads of its tp rank. Admission,
step and rebuild are device calls of every rank (`@collective("pool")`): a
replica admits the windows whose slots are its rows, every replica steps
its rows, and the packed results are gathered over dp, so the leader's
retirement reads every slot.
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
from speaksense_tpu_torch.parallel.workers import collective

log = logging.getLogger(__name__)


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

    spmd_target = "pool"        # how a follower finds this object (`Mesh.call`)

    # rows per admission: the reference's largest admission bucket (eager
    # PyTorch needs no padding of a smaller batch to a bucket)
    ADMIT_BUCKET = 8
    # rows of the int8 self pages' ring: the reference pool's ring_width
    RING_WIDTH = 16

    def __init__(self, engine, n_slots: int, t_mel: int, max_new: int,
                 max_prompt: int = 16, int8_kv: bool = False, self_int8: bool = False,
                 mesh=None):
        self.engine = engine
        self.int8_kv = int8_kv
        self.self_int8 = self_int8
        self.model = engine.model
        self.dims = engine.dims
        self.device = engine.device
        self.S = n_slots
        self.mesh = mesh
        dp = 1 if mesh is None else mesh.shape["dp"]
        rows = n_slots + (mesh is not None)
        if rows % dp:
            raise ValueError(f"a multi-GPU pool's S+1={rows} rows must divide the mesh's "
                             f"dp={dp} (engine.enable_slot_serving rounds the slot count)")
        # this replica's rows [base, base + R) of the pool's
        self.R = rows // dp
        self.base = 0 if mesh is None else mesh.dp_index * self.R
        # t > 0 sampling noise: the engine's generator, or one per dp
        # replica, seeded alike on its tp ranks (they sample the same rows)
        self.rng = engine._rng
        if mesh is not None:
            self.rng = torch.Generator(device=engine.device).manual_seed(
                engine.seed + 1 + mesh.dp_index)
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
        self.state = self._empty_state()
        self.free: list[int] = list(range(self.S))
        self.jobs: dict[int, _StreamJob] = {}
        # host mirror of "some slot samples at t > 0": the all-greedy step
        # then never waits for the device to find out
        self._hot: set[int] = set()
        bool(self.state.active.any())

    def _empty_state(self) -> D.PoolState:
        return D.PoolState.empty(self.model, self.R, self.max_new, self.t_text,
                                 self.n_audio_ctx, self.cfg.eot, self.device,
                                 cross_int8=self.int8_kv, self_int8=self.self_int8,
                                 ring_width=self.RING_WIDTH)

    def reset(self, error: Exception | None = None) -> None:
        """Fail every registered job and rebuild the pool from fresh state:
        the recovery path after a failed step or admission."""
        err = error or RuntimeError("slot pool reset")
        for job in self.jobs.values():
            if not job.future.done():
                job.future.set_exception(err)
        self.jobs.clear()
        self._rebuild()

    @collective("pool")
    def _rebuild(self) -> None:
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

    def _encode(self, x: np.ndarray, is_audio: bool, denoise: str | None) -> torch.Tensor:
        """Stacked job inputs -> f32 encoder states (n, n_audio_ctx, d)."""
        x = torch.as_tensor(x, device=self.device)
        if is_audio:
            x = MEL.pcm_to_f32(x)
            if denoise:
                x = DSP.denoise_audio_torch(x, DSP.DenoiseConfig(post_gain=1.0), branch=denoise)
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
        want = ((self.t_mel * MEL.HOP_LENGTH,) if batch[0].is_audio
                else (self.t_mel, self.dims.n_mels))
        try:
            for job in batch:
                if job.mel.shape != want:
                    raise ValueError(f"pool input shape {job.mel.shape} != {want}")
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

            def col(key, dtype):
                return np.asarray([key(j) for j in batch], dtype)

            self._admit(np.stack([j.mel for j in batch]), batch[0].is_audio, batch[0].denoise,
                        prompts, col(lambda j: j.slot, np.int64),
                        col(lambda j: len(j.prompt), np.int64),
                        col(lambda j: j.sot_index, np.int64),
                        col(lambda j: j.temperature, np.float32), self.ring_n)
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

    @collective("pool")
    def _admit(self, x: np.ndarray, is_audio: bool, denoise: str | None, prompts: np.ndarray,
               slots: np.ndarray, plen: np.ndarray, sot: np.ndarray, temps: np.ndarray,
               born: int) -> None:
        """The device half of an admission of n windows (inputs x, padded
        prompts (n, P), pool slots, true prompt lengths, SOT positions,
        temperatures; born: the ring row of the step to come): the rows of
        this replica are encoded and written (`_admit_rows`)."""
        mine = (slots >= self.base) & (slots < self.base + self.R)
        if not mine.any():
            return
        if not mine.all():
            x, prompts, slots, plen, sot, temps = (a[mine] for a in
                                                   (x, prompts, slots, plen, sot, temps))
        dev = self.device

        def t(a):
            return torch.as_tensor(a, device=dev)

        self._admit_rows(self._encode(x, is_audio, denoise), t(prompts), t(slots - self.base),
                         t(plen), t(sot), t(temps), born)

    def _admit_rows(self, enc: torch.Tensor, prompts: torch.Tensor, slots: torch.Tensor,
                    plen: torch.Tensor, sot: torch.Tensor, temps: torch.Tensor,
                    born: int) -> None:
        """Cross-KV and prefill into this replica's rows `slots`, and their
        decode state reset. Activates the rows last, so a failure leaves
        them inactive."""
        st = self.state
        P = prompts.shape[1]
        rows = torch.arange(len(slots), device=prompts.device)
        logits = W.prefill_into_pool(self.model, enc, prompts, st.pages, slots)
        st.last_logits[slots] = logits[rows, plen - 1]
        # no-speech probability at the SOT position (openai's probs_at_sot),
        # read at settle against no_speech_thold
        st.ns_prob[slots] = torch.softmax(logits[rows, sot], dim=-1)[:, self.cfg.no_speech]
        st.temp[slots] = temps
        st.plen[slots] = plen
        st.ppad[slots] = P
        st.fcol[slots] = P
        st.born[slots] = born
        st.tokens[slots] = self.cfg.eot
        for t in (st.n_sampled, st.last, st.penult, st.last_ts, st.sum_lp):
            t[slots] = 0
        st.active[slots] = True

    # ------------------------------------------------------------ decoding

    @property
    def ring_n(self) -> int:
        """The ring row the next step writes: the pool's steps modulo the
        ring's width (the reference's in-chunk step index)."""
        return self.total_steps % self.RING_WIDTH

    def step(self) -> list[_StreamJob]:
        """One pool-wide decode step; returns the jobs that finished."""
        meta = self._step_meta(bool(self._hot), self.ring_n)
        self.step_calls += 1
        self.total_steps += 1
        self.occupancy_sum += len(self.jobs)
        return self._retire(meta)

    def _device_step(self, hot: bool, ring_n: int) -> torch.Tensor:
        return D.pool_step(self.model, self.cfg, self.suppress, self.state, self.rng, hot=hot,
                           ring_n=ring_n)

    @collective("pool")
    def _step_meta(self, hot: bool, ring_n: int) -> np.ndarray:
        """One step of this replica's rows, then the packed per-row results
        of every row of the pool (`_meta`, gathered over dp): one
        device-to-host copy per step."""
        meta = torch.cat(self._meta(self._device_step(hot, ring_n)), dim=1).cpu()
        if self.mesh is not None:
            meta = self.mesh.all_gather(meta, dim=0, axis="dp")
        return meta.numpy()

    def _meta(self, finished: torch.Tensor) -> list[torch.Tensor]:
        """What retirement reads, a row per slot: finished, n_sampled, the
        log-probability sum and the no-speech probability (f32 bits in
        int32), then the tokens (max_new columns)."""
        st = self.state
        return [finished.int()[:, None], st.n_sampled.int()[:, None],
                st.sum_lp.view(torch.int32)[:, None], st.ns_prob.view(torch.int32)[:, None],
                st.tokens.int()]

    def _retire(self, meta: np.ndarray) -> list[_StreamJob]:
        """Complete the futures of the slots that finished at this step and
        recycle the slots, from the packed results (`_step_meta`)."""
        fin = meta[:, 0] != 0
        if not fin.any():
            return []
        n_sampled = meta[:, 1]
        sum_lp = meta[:, 2].view(np.float32)
        ns_prob = meta[:, 3].view(np.float32)
        tokens = meta[:, 4:]
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
        if mesh is not engine.mesh:
            raise ValueError("a sharded pool needs the engine sharded on its mesh "
                             "(engine.shard(mesh) before the server)")
        self.engine = engine
        self.pool = engine._new_pool(beam_size, n_slots=n_slots, t_mel=t_mel, max_new=max_new,
                                     max_prompt=max_prompt, int8_kv=int8_kv,
                                     self_int8=self_int8)
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
        self._check_temperature(temperature)
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
        self._check_temperature(temperature)
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

    def _check_temperature(self, temperature: float) -> None:
        """Beam pools decode at t = 0 only: a t > 0 submission is refused
        rather than decoded greedily under a hot label. The engine routes
        a beam pool's fallback retries through the window path
        (`WhisperEngine._pool_retry_factory`)."""
        if temperature > 0.0 and getattr(self.pool, "K", 1) > 1:
            raise ValueError("beam pools are t=0 only; route t>0 retries through the "
                             "window path (see engine._pool_retry_factory)")

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
