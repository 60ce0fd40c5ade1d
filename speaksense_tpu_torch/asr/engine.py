"""WhisperEngine in PyTorch: the counterpart of `speaksense_tpu/asr/engine.py`
behind the port's `AsrEngine` interface (`speaksense_tpu_torch/asr`).

Covered: checkpoint loading (`from_pretrained`: ggml files of every quant
type whisper.cpp ships, through the convert-once weight cache, and HF
directories), random-weight and JAX-parameter construction, int8 decoder
weights and int8 cross- and self-KV (`weights_int8`, `cross_kv_int8`,
`self_kv_int8`), log-mel, batched window decoding with whisper's
temperature-fallback ladder (a greedy or, with beam_size > 1, a beam-search
attempt, then best_of sampled candidate rows per pending window), language
detection, the openai-style long-form seek loop with no-speech skipping and
previous-text conditioning, word timestamps by cross-attention DTW
(`models/align.py`, each window encoded again for the alignment, as the
reference does), VAD-segmented long-form transcription
(`transcribe_audio_vad`, spans from `audio/vad.py`), the reference's
segment post-processing, and the streaming surface: stream-mode chunks
through the greedy slot pool (`runtime/slots.py`) with device denoise,
the pooled fallback ladder, no-speech suppression, conditioning context,
session pipelining (`submit_stream_chunk`), oversized chunks split into
pool-bucket sub-windows and the padded tail flush; a sub-bucket chunk
without a pool takes the window path. With beam_size > 1 stream chunks ride the beam pool
(`runtime/beam_slots.py`), whose fallback retries go through the window
path at t > 0.

`shard(mesh)` spreads the engine over a (dp, tp) mesh of processes, one per
GPU (`parallel/`): the model tensor-parallel over tp, the slot pool's rows
over dp, and the window path replicated over dp, as the JAX engine's
unsharded window batch is. Each device call (`@collective`) runs on every
rank of the mesh; the host logic runs on the leader.
"""

from __future__ import annotations

import dataclasses
import inspect
import json
import logging
import os
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from speaksense_tpu_torch.asr import AsrEngine, AsrParams, TranscribeResult, TranscribeSegment
from speaksense_tpu_torch.asr import postprocess as PP
from speaksense_tpu_torch.audio import dsp as DSP
from speaksense_tpu_torch.audio import mel as MEL
from speaksense_tpu_torch.audio.vad import speech_segments
from speaksense_tpu_torch.models import align as A
from speaksense_tpu_torch.models import decode as D
from speaksense_tpu_torch.config import EngineConfig
from speaksense_tpu_torch.models import whisper as W
from speaksense_tpu_torch.models.tokenizer import Tokenizer
from speaksense_tpu_torch.parallel.workers import collective
from speaksense_tpu_torch.utils.metrics import REGISTRY as METRICS

log = logging.getLogger(__name__)

SAMPLE_RATE = MEL.SAMPLE_RATE
# whisper temperature fallback schedule (openai + whisper.cpp)
FALLBACK_TEMPS = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)


@dataclass
class EngineState:
    """Per-stream host-side context: the detected language, the stream's
    conditioning tokens and the per-stream lock."""

    language: str | None = None
    context_tokens: list = field(default_factory=list)  # stream conditioning
    lock: threading.Lock = field(default_factory=threading.Lock)
    # conditioned-pipelining bound: chunks of this stream submitted but not
    # yet settled with conditioning active (see submit_stream_chunk)
    inflight_conditioned: int = 0


def needs_fallback_retry(cand: dict, config: EngineConfig) -> bool:
    """Temperature-fallback quality gates on one decode candidate: zlib
    compression ratio, avg logprob and the 32-token histogram entropy
    (whisper.cpp entropy_thold, only past 32 sampled tokens). A window whose
    no-speech probability clears no_speech_thold never retries."""
    if cand.get("no_speech_prob", 0.0) > config.no_speech_thold:
        return False
    return ((cand["compression_ratio"] > config.compression_ratio_thold)
            or (cand["avg_logprob"] < config.logprob_thold)
            or (cand["n_sampled"] > 32
                and cand.get("token_entropy", 99.0) < config.entropy_thold))


def _to_host(out: dict) -> dict:
    """A window attempt's per-row outputs, read back to numpy."""
    with METRICS.span("engine.readback"):
        return {k: out[k].cpu().numpy()
                for k in ("tokens", "n_sampled", "avg_logprob", "no_speech_prob")}


class _PendingChunk:
    """Handle for one in-flight stream chunk (`submit_stream_chunk`):
    settle() blocks until the slot pool finishes the chunk's decode, then
    runs the pooled ladder and the host postprocess. Settle calls for one
    stream happen in submission order from a single thread: that order, not
    a lock, orders the conditioning-context updates."""

    __slots__ = ("engine", "state", "future", "n_samples", "params", "language",
                 "conditioned", "retry")

    def __init__(self, engine, state, future, n_samples, params, language,
                 conditioned: bool = False, retry=None):
        self.engine = engine
        self.state = state
        self.future = future
        self.n_samples = n_samples
        self.params = params
        self.language = language
        self.conditioned = conditioned
        # retry(temperature) -> list of raw candidates: resubmits the
        # chunk's audio for the temperature-fallback ladder
        self.retry = retry

    def settle(self) -> TranscribeResult:
        try:
            raw = self.engine._pool_quality_gate(self.future.result(), self.retry)
            result = self.engine._finish_slot_chunk(raw, self.n_samples, self.params,
                                                    self.language, self.state)
        finally:
            if self.conditioned and self.state is not None:
                with self.state.lock:
                    self.state.inflight_conditioned -= 1
        if self.state is not None:
            self.state.language = result.language or self.state.language
        return result


class _PendingMultiChunk:
    """Handle for one oversized in-flight stream chunk: a chunk longer than
    the pool's bucket rides the pool as pool-bucket sub-windows admitted
    concurrently, each with the pool's token budget. settle() joins them in
    order and merges their segments onto the chunk's timeline. The cuts
    have no overlap; the transport's chunk overlap heals boundary words."""

    __slots__ = ("engine", "state", "futures", "piece_samples", "n_samples",
                 "params", "language", "conditioned", "retries")

    def __init__(self, engine, state, futures, piece_samples, n_samples,
                 params, language, conditioned: bool = False, retries=None):
        self.engine = engine
        self.state = state
        self.futures = futures
        self.piece_samples = piece_samples
        self.n_samples = n_samples
        self.params = params
        self.language = language
        self.conditioned = conditioned
        self.retries = retries       # per-piece retry(temperature) closures

    def settle(self) -> TranscribeResult:
        try:
            raws = [f.result() for f in self.futures]
            retries = self.retries or [None] * len(raws)
            raws = [self.engine._pool_quality_gate(r, rt) for r, rt in zip(raws, retries)]
            result = self.engine._finish_slot_chunk_multi(
                raws, self.piece_samples, self.n_samples, self.params,
                self.language, self.state)
        finally:
            if self.conditioned and self.state is not None:
                with self.state.lock:
                    self.state.inflight_conditioned -= 1
        if self.state is not None:
            self.state.language = result.language or self.state.language
        return result


class WhisperEngine(AsrEngine):
    spmd_target = "engine"      # how a follower finds this object (`Mesh.call`)

    def __init__(self, model: W.Whisper, tokenizer: Tokenizer,
                 mel_filters: np.ndarray | None = None,
                 config: EngineConfig | None = None, name: str = "whisper", seed: int = 0):
        self.config = config or EngineConfig()
        if self.config.weights_int8 and not W.weights_are_int8(model):
            # int8 decoder block weights, per output channel (whisper.cpp
            # ships q5/q8 ggml models the same way)
            W.quantize_block_weights(model)
        self.model = model
        self.dims = model.dims
        self.device = model.device
        self.tokenizer = tokenizer
        self.name = name
        self.mel_filters = (np.asarray(mel_filters, np.float32) if mel_filters is not None
                            else MEL.mel_filter_bank(self.dims.n_mels))
        self._suppress = {
            (sns, turn): torch.as_tensor(tokenizer.suppress_mask(
                suppress_non_speech=sns, allow_speaker_turn=turn), device=self.device)
            for sns in (True, False) for turn in (True, False)
        }
        # sampling noise for the t > 0 fallback attempts (window and pool)
        self.seed = seed
        self._rng = torch.Generator(device=self.device).manual_seed(seed)
        self._slot_server = None
        # the window steps' CUDA graphs and the caches they own (`D.WindowGraphs`)
        self._window_graphs = D.WindowGraphs()
        self.mesh = None            # set by shard(): the (dp, tp) serving mesh
        self._pool = None           # the slot pool, the one a follower's calls reach

    # ------------------------------------------------------------------ load

    @staticmethod
    def _dtype(config: EngineConfig) -> torch.dtype:
        return torch.bfloat16 if config.compute_dtype == "bfloat16" else torch.float32

    @classmethod
    def from_random(cls, model: str = "large-v3", config: EngineConfig | None = None,
                    device="cuda", seed: int = 0,
                    decoder_layers: int | None = None) -> "WhisperEngine":
        """Random-weight engine (no checkpoint needed); the weights are drawn
        on `device` from a generator seeded with `seed`. `decoder_layers`
        cuts the decoder's depth (the widths and the encoder stay the
        model's)."""
        config = config or EngineConfig()
        dims = W.MODEL_DIMS[model]
        if decoder_layers is not None:
            dims = dataclasses.replace(dims, n_text_layer=decoder_layers)
            model = f"{model}-{decoder_layers}dec"
        device = torch.device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        m = W.init_random(dims, gen, device=device, dtype=cls._dtype(config))
        return cls(m, Tokenizer.synthetic(dims.n_vocab), config=config,
                   name=f"random-{model}", seed=seed)

    @classmethod
    def from_jax_params(cls, np_params: dict, dims: W.WhisperDims, tokenizer: Tokenizer,
                        config: EngineConfig | None = None, device="cuda",
                        mel_filters: np.ndarray | None = None,
                        name: str = "jax-params") -> "WhisperEngine":
        """Engine on a parameter pytree of numpy arrays in the JAX package's
        layout (what the checkpoint loaders give). q/k/v are fused on the
        host as the weights are copied to `device`: the port's blocks always
        hold one fused projection, so `config.fuse_qkv` changes nothing.
        With `config.weights_int8` the decoder blocks are quantized from the
        f32 host weights on the way."""
        config = config or EngineConfig()
        m = W.params_from_jax(np_params, dims, device=device, dtype=cls._dtype(config),
                              weights_int8=config.weights_int8)
        return cls(m, tokenizer, mel_filters=mel_filters, config=config, name=name)

    @classmethod
    def from_ggml(cls, path: str, config: EngineConfig | None = None, use_cache: bool = True,
                  device="cuda") -> "WhisperEngine":
        """Engine on a whisper.cpp ggml checkpoint, with its mel filterbank
        and vocab. With use_cache the converted weights are read from, or
        written to, `config.weight_cache_dir` (`ckpt/cache.py`)."""
        from speaksense_tpu_torch.ckpt import cache as CK
        from speaksense_tpu_torch.ckpt.ggml import load_ggml, params_from_ggml

        config = config or EngineConfig()
        path = str(path)
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no ggml checkpoint at {path}")
        t0 = time.perf_counter()
        cached = CK.load_cached(path, config.weight_cache_dir) if use_cache else None
        if cached is not None:
            params, meta = cached
            dims = W.WhisperDims(**meta["dims"])
            vocab, filters = meta["vocab"], meta["filters"]
            log.info("loaded cached weights for %s in %.1fs", path, time.perf_counter() - t0)
        else:
            model = load_ggml(path)
            params = params_from_ggml(model)
            dims, vocab, ftype = model.dims, model.vocab, model.ftype
            filters = model.filters if model.filters.size else None
            del model       # the f32 tensors: the pytree holds its own copies
            log.info("loaded ggml model %s in %.1fs (dims=%s)", path,
                     time.perf_counter() - t0, dims)
            if use_cache:
                try:
                    CK.save_cached(path, config.weight_cache_dir, params,
                                   dataclasses.asdict(dims), vocab, filters,
                                   ftype=ftype)
                except OSError as e:
                    log.warning("weight cache write failed: %s", e)
        return cls.from_jax_params(params, dims, Tokenizer.from_vocab(vocab), config=config,
                                   device=device, mel_filters=filters, name=path)

    @classmethod
    def from_hf_dir(cls, path: str, config: EngineConfig | None = None,
                    device="cuda") -> "WhisperEngine":
        """Engine on a HuggingFace checkpoint directory (config.json and
        model.safetensors, single or sharded). The vocab comes from
        speaksense_vocab.json (hex pieces) when present; otherwise the
        synthetic tokenizer stands in."""
        from speaksense_tpu_torch.ckpt.hf_dir import load_hf_dir

        config = config or EngineConfig()
        if not os.path.isdir(path):
            raise FileNotFoundError(f"no HF checkpoint directory at {path}")
        params, dims = load_hf_dir(path)
        vocab_file = os.path.join(path, "speaksense_vocab.json")
        if os.path.isfile(vocab_file):
            with open(vocab_file) as f:
                tok = Tokenizer.from_vocab([bytes.fromhex(h) for h in json.load(f)])
        else:
            log.warning("%s has no speaksense_vocab.json; using synthetic vocab "
                        "(special tokens fine, text decode needs the real vocab)", path)
            tok = Tokenizer.synthetic(dims.n_vocab)
        return cls.from_jax_params(params, dims, tok, config=config, device=device,
                                   name=str(path))

    @classmethod
    def from_pretrained(cls, path: str, config: EngineConfig | None = None,
                        device="cuda") -> "WhisperEngine":
        """Dispatch on checkpoint type: an HF directory, or else a ggml file
        (through the weight cache). A missing path raises
        FileNotFoundError; there is no fallback to random weights."""
        if os.path.isdir(path):
            return cls.from_hf_dir(path, config=config, device=device)
        return cls.from_ggml(path, config=config, device=device)

    def shard(self, mesh) -> None:
        """Keep this rank's shard of the parameters on the (dp, tp) serving
        mesh (`parallel.shard_params`, the Megatron layout: attention and
        MLP projections split over tp, all else replicated, the suppress
        masks included). Every device call after this runs on every rank of
        the mesh, the leader's and the followers' (`parallel/workers.py`).

        Call before enable_slot_serving, so the pool's pages shard too
        (slot rows on dp, heads on tp)."""
        from speaksense_tpu_torch.parallel import shard_params

        if self._slot_server is not None:
            raise RuntimeError("shard() must run before enable_slot_serving "
                               "(the pool's pages must shard with the params)")
        shard_params(self.model, mesh)
        self.mesh = mesh
        log.info("engine sharded over mesh %s (dp=%d, tp=%d), rank %d", mesh.devices.tolist(),
                 mesh.shape["dp"], mesh.shape["tp"], mesh.rank)

    def profile_trace(self, log_dir: str):
        """Context manager: a `torch.profiler` trace of everything inside,
        host and (on the card) device activity, written to `log_dir` as a
        Chrome trace (`<host>_<pid>.<time>.pt.trace.json`) that TensorBoard
        or Perfetto opens; the JAX engine's `profile_trace`."""
        from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        return profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir))

    # ------------------------------------------------------------------ audio

    def compute_mel(self, audio, pad_to: int | None = None) -> torch.Tensor:
        """audio (n,) or (B, n) f32 @16k -> (B, T_mel, n_mels) on the engine's
        device. pad_to selects a frame count (3000 for full windows)."""
        with METRICS.span("engine.mel"):
            a = np.atleast_2d(np.asarray(audio, np.float32))
            if pad_to is None:
                return MEL.log_mel_spectrogram(a, n_mels=self.dims.n_mels,
                                               filters=self.mel_filters, device=self.device)
            target = pad_to * MEL.HOP_LENGTH
            if a.shape[-1] < target:
                a = np.pad(a, ((0, 0), (0, target - a.shape[-1])))
            return MEL.log_mel_spectrogram(a[:, :target], n_mels=self.dims.n_mels,
                                           filters=self.mel_filters, pad_to_chunk=False,
                                           device=self.device)

    @staticmethod
    def _mel_bucket(t_mel: int) -> int:
        for b in (512, 1024, 3000):
            if t_mel <= b:
                return b
        return 3000

    # --------------------------------------------------------------- decoding

    def _rule_config(self, with_ts: bool, max_new: int) -> D.RuleConfig:
        return D.RuleConfig.from_tokenizer(
            self.tokenizer, with_timestamps=with_ts,
            max_initial_ts=self.config.max_initial_ts, max_new_tokens=max_new)

    @collective("window")
    def _run_window(self, mels, prompt, prompt_len, sot_index, temps, with_ts: bool,
                    max_new: int, suppress) -> dict:
        n_audio_ctx = min(mels.shape[1] // 2, self.dims.n_audio_ctx)
        # int8 self-KV pages only when the token budget spans more than one
        # 128-column page (the reference's rule: below that, its flush cost
        # offset the saving)
        self_int8 = self.config.self_kv_int8 and prompt.shape[1] + max_new > 128
        out = D.transcribe_window(
            self.model, self._rule_config(with_ts, max_new), suppress, mels, prompt,
            torch.as_tensor(temps, dtype=torch.float32, device=self.device),
            self._rng, sot_index=sot_index, n_audio_ctx=n_audio_ctx, prompt_len=prompt_len,
            cross_kv_int8=self.config.cross_kv_int8, self_kv_int8=self_int8,
            graphs=self._window_graphs)
        return _to_host(out)

    @collective("window")
    def _run_beam(self, mels, prompt, prompt_len, sot_index, with_ts: bool, max_new: int,
                  suppress, beam_size: int) -> dict:
        """The window path's beam-search attempt (the JAX `_beam_fn`)."""
        from speaksense_tpu_torch.models.beam import transcribe_window_beam

        out = transcribe_window_beam(
            self.model, self._rule_config(with_ts, max_new), suppress, mels, prompt,
            beam_size=beam_size, n_audio_ctx=min(mels.shape[1] // 2, self.dims.n_audio_ctx),
            prompt_len=prompt_len, sot_index=sot_index,
            cross_kv_int8=self.config.cross_kv_int8)
        return _to_host(out)

    def decode_windows(self, mels, language, task: str = "transcribe",
                       with_timestamps: bool = True, suppress_non_speech: bool = False,
                       max_new_tokens: int | None = None, temperatures=None,
                       beam_size: int | None = None,
                       speaker_diarization: bool = False,
                       context_tokens: list | None = None, pad_rows: int = 0) -> list[dict]:
        """Decode a batch of mel windows with per-row temperature fallback.
        mels: (B, T_mel, n_mels); language: one code or a per-row list.
        beam_size=None takes `config.beam_size`: with beam_size > 1 and no
        row starting hot, the first attempt is beam search; retries sample.
        pad_rows: the last rows only fill the batch (`asr_windows_total`
        leaves them out).
        Returns per-row dicts with tokens/text/avg_logprob/no_speech_prob/
        compression_ratio/temperature."""
        if beam_size is None:
            beam_size = self.config.beam_size
        mels = torch.as_tensor(mels, device=self.device)
        B = mels.shape[0]
        with METRICS.span("engine.prompt"):
            langs = ([language] * B if (language is None or isinstance(language, str))
                     else list(language))
            sot_rows = [self.tokenizer.sot_sequence(lang or "en", task=task,
                                                    timestamps=with_timestamps)
                        for lang in langs]
            # conditioning: [<|startofprev|>] + context + sot_seq, right-padded
            ctx = context_tokens if context_tokens is not None else [[] for _ in range(B)]
            max_ctx = self.dims.n_text_ctx // 2 - 1 - max(len(r) for r in sot_rows)
            rows, lens, sots = [], [], []
            for i in range(B):
                c = list(ctx[i] or [])[-max_ctx:]
                row = ([self.tokenizer.sot_prev] + c if c else []) + sot_rows[i]
                rows.append(row)
                lens.append(len(row))
                sots.append(len(row) - len(sot_rows[i]))
            P = max(lens)
            if P > len(sot_rows[0]):  # bucket to multiples of 32 past the base size
                P = ((P + 31) // 32) * 32
            prompt_np = np.full((B, P), self.tokenizer.eot, np.int64)
            for i, row in enumerate(rows):
                prompt_np[i, :len(row)] = row
            prompt = torch.as_tensor(prompt_np, device=self.device)
            prompt_len = torch.as_tensor(lens, dtype=torch.long, device=self.device)
            sot_index = torch.as_tensor(sots, dtype=torch.long, device=self.device)
        max_new = max_new_tokens or self.config.max_decode_len // 2
        suppress = self._suppress[(suppress_non_speech, speaker_diarization)]

        temps = (np.zeros((B,), np.float32) if temperatures is None
                 else np.asarray(temperatures, np.float32))
        schedule = list(FALLBACK_TEMPS)
        results: list[dict | None] = [None] * B
        last_attempt: list[dict | None] = [None] * B
        pending = np.ones((B,), bool)
        METRICS.inc("asr_windows_total", B - pad_rows)
        t_start = time.perf_counter()

        def _candidate(out: dict, row: int, temp) -> dict:
            n = int(out["n_sampled"][row])
            toks = out["tokens"][row].astype(np.int32)
            text = self.tokenizer.decode(toks[:n])
            return dict(
                tokens=toks, n_sampled=n, text=text,
                avg_logprob=float(out["avg_logprob"][row]),
                no_speech_prob=float(out["no_speech_prob"][row]),
                compression_ratio=PP.compression_ratio(text), temperature=float(temp),
                token_entropy=PP.token_entropy(toks[:n]),
            )

        def _settle(b: int, cand: dict) -> None:
            """Accept the row's candidate or schedule a hotter retry at the
            first ladder rung strictly above the row's current temperature."""
            last_attempt[b] = cand
            if needs_fallback_retry(cand, self.config) and temps[b] < schedule[-1]:
                temps[b] = next(t for t in schedule if t > temps[b])
                METRICS.inc("asr_fallback_retries_total")
                return
            results[b] = cand
            pending[b] = False

        # attempt 0: every row at its starting temperature (greedy by
        # default), or beam search when configured and no row starts hot
        with METRICS.span("engine.attempt", attempt=0, rows=B):
            if beam_size and beam_size > 1 and not temps.any():
                out = self._run_beam(mels, prompt, prompt_len, sot_index, with_timestamps,
                                     max_new, suppress, beam_size)
            else:
                out = self._run_window(mels, prompt, prompt_len, sot_index, temps,
                                       with_timestamps, max_new, suppress)
        with METRICS.span("engine.settle"):
            for b in range(B):
                _settle(b, _candidate(out, b, temps[b]))

        # retries: t > 0 sampling with best_of candidate rows per pending
        # window; the best avg_logprob wins (openai best_of rule)
        best_of = max(1, int(self.config.best_of))
        for attempt in range(1, len(schedule)):
            pend_idx = [b for b in range(B) if pending[b]]
            if not pend_idx:
                break
            Bc = max(B, best_of)
            per_call = max(1, Bc // best_of)
            for g0 in range(0, len(pend_idx), per_call):
                group = pend_idx[g0:g0 + per_call]
                cand_rows: list[int] = []
                for s_i in group:
                    cand_rows.extend([s_i] * best_of)
                cand_rows.extend([group[0]] * (Bc - len(cand_rows)))  # pad rows (ignored)
                idx = torch.as_tensor(cand_rows, dtype=torch.long, device=self.device)
                with METRICS.span("engine.attempt", attempt=attempt, rows=Bc):
                    out = self._run_window(mels[idx], prompt[idx], prompt_len[idx],
                                           sot_index[idx], temps[np.asarray(cand_rows)],
                                           with_timestamps, max_new, suppress)
                with METRICS.span("engine.settle"):
                    for gi, s_i in enumerate(group):
                        rows_i = range(gi * best_of, (gi + 1) * best_of)
                        best_row = max(rows_i, key=lambda r: out["avg_logprob"][r])
                        _settle(s_i, _candidate(out, best_row, temps[s_i]))
        for b in range(B):
            if results[b] is None:
                results[b] = last_attempt[b]
        METRICS.observe("asr_decode_window_seconds", time.perf_counter() - t_start)
        return results

    @collective("window")
    def first_step(self, mels, language: str = "en", task: str = "transcribe"):
        """The encoder states and the logits of the first decoded token of
        a batch of mel windows (B, T_mel, n_mels), the first step of
        `decode_windows` (SOT prompt, no conditioning): f32 (B, A, d) and
        (B, V) on the host. A device call of every rank of a sharded
        engine, so the two can be held against an unsharded one."""
        mels = torch.as_tensor(mels, device=self.device)
        enc = W.encode(self.model, mels, n_ctx_out=min(mels.shape[1] // 2, self.dims.n_audio_ctx))
        sot = self.tokenizer.sot_sequence(language, task=task)
        prompt = torch.as_tensor([sot] * mels.shape[0], dtype=torch.long, device=self.device)
        logits = W.decode_prefill(self.model, prompt, W.init_cache(self.model, enc, len(sot)))
        return enc.cpu(), logits[:, -1].cpu()

    @collective("window")
    def detect_language(self, audio: np.ndarray) -> str:
        mel = self.compute_mel(np.asarray(audio, np.float32)[:MEL.N_SAMPLES])
        enc = W.encode(self.model, mel, n_ctx_out=min(mel.shape[1] // 2, self.dims.n_audio_ctx))
        lang_ids, _ = D.detect_language(self.model, enc, self.tokenizer)
        return self.tokenizer.lang_code(int(lang_ids[0]))

    # --------------------------------------------------------- long-form API

    def transcribe_audio(self, audio: np.ndarray, params: AsrParams,
                         decode_window=None) -> TranscribeResult:
        """Long-form transcription: 30 s windows advanced by decoded
        timestamp boundaries (openai-style seek), with silence skipping via
        no_speech_thold. decode_window(mel, language, task,
        suppress_non_speech, ...) -> dict lets the window batcher route each
        window through its shared batch. With params.word_timestamps each
        decoded window's segments carry their words (`_attach_words`)."""
        audio = np.asarray(audio, np.float32).reshape(-1)
        if audio.size == 0:
            return TranscribeResult(segments=[], full_text="")
        language = params.language or (
            self.detect_language(audio) if self.tokenizer.multilingual else "en")
        if decode_window is None:
            def decode_window(mel, lang, task, sns, context=None,
                              speaker_diarization=False, temperature=0.0):
                return self.decode_windows(
                    mel, lang, task=task, suppress_non_speech=sns,
                    speaker_diarization=speaker_diarization,
                    temperatures=[temperature] if temperature else None,
                    context_tokens=[context] if context else None)[0]
        hook_params = set(inspect.signature(decode_window).parameters)
        extra_kw = {}
        if "speaker_diarization" in hook_params:
            extra_kw["speaker_diarization"] = params.speaker_diarization
        if "temperature" in hook_params:
            extra_kw["temperature"] = params.temperature
        takes_context = "context" in hook_params

        seek = 0
        raw_segments: list[dict] = []
        context: list[int] = []
        n_tokens = 0
        while seek < audio.size:
            window = audio[seek: seek + MEL.N_SAMPLES]
            mel = self.compute_mel(window)  # pads to 3000 frames
            ctx = context if params.condition_on_previous_text else None
            if takes_context:
                res = decode_window(mel, language, params.task, params.suppress_non_speech,
                                    context=ctx, **extra_kw)
            else:
                res = decode_window(mel, language, params.task, params.suppress_non_speech,
                                    **extra_kw)
            offset = seek / SAMPLE_RATE
            window_dur = min(window.size, MEL.N_SAMPLES) / SAMPLE_RATE
            n_tokens += int(res["n_sampled"])
            if (res["no_speech_prob"] > self.config.no_speech_thold
                    and res["avg_logprob"] < self.config.logprob_thold):
                seek += MEL.N_SAMPLES  # silent window
                continue
            # context for the next window; reset after hot fallbacks
            # (openai prompt_reset rule)
            if res.get("temperature", 0.0) > 0.5:
                context = []
            else:
                context = context + [int(t) for t in res["tokens"][: res["n_sampled"]]
                                     if t < self.tokenizer.eot]
                context = context[-(self.dims.n_text_ctx // 2 - 8):]
            segs, advance = D.segments_from_tokens(
                res["tokens"], res["n_sampled"], self.tokenizer, window_offset=offset)
            for s in segs:
                s["end"] = min(s["end"], offset + window_dur)
                s["start"] = min(s["start"], s["end"])
            if params.word_timestamps and segs:
                self._attach_words(segs, res, mel, language, offset, window_dur)
            raw_segments.extend(segs)
            if advance is not None and advance > 0.5:
                seek += int(advance * SAMPLE_RATE)
            else:
                seek += MEL.N_SAMPLES
        return self._postprocess(raw_segments, params, language, n_tokens=n_tokens)

    def transcribe_audio_vad(self, audio: np.ndarray, params: AsrParams,
                             decode_window=None) -> TranscribeResult:
        """VAD-segmented long-form transcription: the energy VAD
        (`audio/vad.py::speech_segments`) finds the speech spans, only
        those reach the encoder through `transcribe_audio`, and segment and
        word times are shifted by each span's offset. After the first span
        its detected language holds for the rest of the file."""
        audio = np.asarray(audio, np.float32).reshape(-1)
        spans = speech_segments(audio)
        if not spans:
            return TranscribeResult(segments=[], full_text="", language=params.language)
        all_segments: list[TranscribeSegment] = []
        language = params.language
        full_text = []
        n_tokens = 0
        for start, end in spans:
            if language and params.language is None:
                params = dataclasses.replace(params, language=language)
            res = self.transcribe_audio(audio[start:end], params, decode_window)
            language = language or res.language
            offset = start / SAMPLE_RATE
            for s in res.segments:
                s.start += offset
                s.end += offset
                for w in s.words or ():
                    w["start"] += offset
                    w["end"] += offset
                all_segments.append(s)
            full_text.append(res.full_text)
            n_tokens += res.n_tokens
        return TranscribeResult(segments=all_segments, full_text="".join(full_text),
                                language=language, n_tokens=n_tokens)

    @collective("window")
    def _attach_words(self, segs: list[dict], res: dict, mel: torch.Tensor,
                      language: str | None, offset: float, window_dur: float) -> None:
        """Word-level timestamps by cross-attention DTW (`models/align.py`)
        for one decoded window: its mel is encoded again (the decode hook
        returns no encoder states, as in the reference), and each word goes
        to the segments whose span, widened by 0.02 s, holds its start.

        Each segment gets its own copy of a word: `transcribe_audio_vad`
        shifts the words segment by segment, and the JAX engine, which
        shares one dict between the segments that hold a word, shifts such
        a word once for each of them (a fault of the reference)."""
        enc = W.encode(self.model, mel)
        tokens = [int(t) for t in res["tokens"][: res["n_sampled"]]]
        words = A.word_timestamps(self.model, self.tokenizer, tokens, enc, language=language,
                                  audio_seconds=window_dur, time_offset=offset)
        for s in segs:
            s["words"] = [dict(w) for w in words
                          if s["start"] - 0.02 <= w["start"] < s["end"] + 0.02]

    def _postprocess(self, raw_segments: list[dict], params: AsrParams,
                     language: str | None, n_tokens: int = 0) -> TranscribeResult:
        """Reference segment pipeline: promo filter, CJK punctuation,
        speaker turns, short-segment merging, and in stream mode only the
        last segment."""
        segments: list[TranscribeSegment] = []
        speaker = 0
        prev_turn = False
        for s in raw_segments:
            if prev_turn and params.speaker_diarization:
                speaker += 1
            prev_turn = bool(s.get("speaker_turn_next"))
            if not s["text"].strip():
                continue
            if PP.is_promotional_text(s["text"]):
                log.debug("filtered promotional segment: %s", s["text"])
                continue
            text = PP.add_punctuation(s["text"]) if language == "zh" else s["text"]
            segments.append(TranscribeSegment(text=text, speaker_id=speaker,
                                              start=s["start"], end=s["end"],
                                              words=s.get("words")))
        segments = self._merge_short_segments(segments, params.min_segment_length)
        if params.stream_mode and segments:
            # the reference keeps only the final segment in stream mode
            last = segments[-1]
            return TranscribeResult(segments=[last], full_text=last.text,
                                    language=language, n_tokens=n_tokens)
        return TranscribeResult(segments=segments, full_text="".join(s.text for s in segments),
                                language=language, n_tokens=n_tokens)

    @staticmethod
    def _merge_short_segments(segments: list[TranscribeSegment],
                              min_len: int) -> list[TranscribeSegment]:
        """Segments shorter than min_len characters merge into the adjacent
        same-speaker segment; no text is dropped."""
        min_len = max(0, int(min_len))
        if min_len <= 1 or len(segments) <= 1:
            return segments

        def absorb(dst: TranscribeSegment, src: TranscribeSegment) -> None:
            dst.text += src.text
            dst.end = max(dst.end, src.end)
            if dst.words is not None or src.words is not None:
                dst.words = (dst.words or []) + (src.words or [])

        merged: list[TranscribeSegment] = []
        for s in segments:
            if (merged and len(merged[-1].text.strip()) < min_len
                    and merged[-1].speaker_id == s.speaker_id):
                absorb(merged[-1], s)
            else:
                merged.append(s)
        if (len(merged) > 1 and len(merged[-1].text.strip()) < min_len
                and merged[-2].speaker_id == merged[-1].speaker_id):
            last = merged.pop()
            absorb(merged[-1], last)
        return merged

    # ----------------------------------------------------- AsrEngine surface

    def create_state(self) -> EngineState:
        return EngineState()

    def transcribe_with_state(self, state: EngineState, audio, params: AsrParams,
                              decode_window=None) -> TranscribeResult:
        with state.lock:  # the reference serializes per stream
            if params.language is None and state.language:
                params = AsrParams(**{**params.__dict__, "language": state.language})
            if params.stream_mode:
                result = self._transcribe_stream_chunk(audio, params, decode_window,
                                                       state=state)
            else:
                result = self.transcribe_audio(np.asarray(audio, np.float32), params,
                                               decode_window)
            state.language = result.language or state.language
            return result

    # ---------------------------------------------------------- slot serving

    def enable_slot_serving(self, n_slots: int | None = None, t_mel: int = 512,
                            max_new: int = 96, int8_kv: bool | None = None,
                            self_int8: bool | None = None, max_prompt: int = 16,
                            beam_size: int | None = None) -> None:
        """Route stream chunks through the token-level slot pool
        (`runtime/slots.py`): concurrent streams join and leave the decode
        batch at token granularity. max_prompt=16 fits plain SOT prompts;
        a larger one (e.g. 64) lets pooled streams carry previous-text
        conditioning. The pool holds one mel bucket (t_mel) but serves
        every chunk size: shorter chunks ride zero-padded when asked
        (`pad_to_bucket`), oversized ones as split sub-windows.

        beam_size=None inherits `config.beam_size`: beam_size > 1 builds the
        beam pool (`runtime/beam_slots.py`). int8_kv (int8 cross-KV)
        defaults to `config.cross_kv_int8`; self_int8 (int8 self-KV pages)
        defaults to on for beam pools, whose page reads dominate their step,
        and off for greedy pools, as in the reference.

        On a sharded engine (shard() first) the pool's pages shard with the
        params: slot rows on dp, heads on tp, and every follower builds its
        part. The slot count is rounded down so the pool's S+1 rows divide
        dp, as in the JAX engine."""
        from speaksense_tpu_torch.runtime.slots import StreamingDecodeServer

        n_slots = n_slots or self.config.stream_slots
        if self.mesh is not None:
            dp = self.mesh.shape["dp"]
            rounded = max(dp, (n_slots + 1) // dp * dp) - 1
            if rounded != n_slots:
                log.info("slot pool: %d slots -> %d so S+1 rows divide dp=%d",
                         n_slots, rounded, dp)
            n_slots = rounded
        if beam_size is None:
            beam_size = self.config.beam_size or 1
        if self_int8 is None:
            self_int8 = beam_size > 1
        self._slot_server = StreamingDecodeServer(
            self, n_slots=n_slots, t_mel=t_mel, max_new=max_new,
            int8_kv=self.config.cross_kv_int8 if int8_kv is None else int8_kv,
            self_int8=self_int8, max_prompt=max_prompt, mesh=self.mesh, beam_size=beam_size)

    @collective("pool")
    def _new_pool(self, beam_size: int, **kw):
        """The slot pool of `StreamingDecodeServer` (a beam pool for
        beam_size > 1), built on every rank of a mesh: a follower's pool
        calls reach its part."""
        from speaksense_tpu_torch.runtime.beam_slots import BeamSlotPool
        from speaksense_tpu_torch.runtime.slots import SlotPool

        if beam_size and beam_size > 1:
            self._pool = BeamSlotPool(self, beam_size=beam_size, mesh=self.mesh, **kw)
        else:
            self._pool = SlotPool(self, mesh=self.mesh, **kw)
        return self._pool

    @collective("pool")
    def _drop_pool(self) -> None:
        self._pool = None

    @property
    def device_denoise(self) -> bool:
        """True when stream chunks run the denoise chain on the device
        (inside the slot pool's admission): StreamSession then skips its
        host numpy denoise and sets AsrParams.denoise instead."""
        return self._slot_server is not None

    def disable_slot_serving(self) -> None:
        if self._slot_server is not None:
            self._slot_server.stop()
            self._slot_server = None
            self._drop_pool()

    def _pool_candidate(self, raw: dict) -> dict:
        """Host-side quality features of one pooled decode result, as
        decode_windows computes them for a window row."""
        n = int(raw["n_sampled"])
        text = self.tokenizer.decode(raw["tokens"][:n])
        return {**raw, "text": text,
                "compression_ratio": PP.compression_ratio(text),
                "token_entropy": PP.token_entropy(raw["tokens"][:n]),
                "temperature": float(raw.get("temperature", 0.0))}

    def _pool_quality_gate(self, raw: dict, retry) -> dict:
        """whisper's temperature-fallback ladder on a pooled chunk.
        retry(temperature) resubmits the chunk's audio as best_of concurrent
        pool decodes at that temperature (per-slot temperatures: retries
        stay continuously batched with live traffic), or for a beam pool one
        window-path decode that runs the rest of the ladder itself; the best
        avg_logprob wins (openai best_of rule), and a chunk that still fails
        at t = 1.0 keeps its last attempt, as decode_windows does. A
        candidate that already carries its quality features (the window
        path's) is taken as it is."""
        cand = self._pool_candidate(raw)
        if retry is None:
            return cand
        attempt = 0
        while (needs_fallback_retry(cand, self.config)
               and cand["temperature"] < FALLBACK_TEMPS[-1]
               and attempt + 1 < len(FALLBACK_TEMPS)):
            attempt += 1
            t = FALLBACK_TEMPS[attempt]
            METRICS.inc("asr_fallback_retries_total")
            METRICS.inc("asr_pool_fallback_retries_total")
            try:
                cands = [c if "compression_ratio" in c else self._pool_candidate(c)
                         for c in retry(t)]
            except Exception as e:
                # a failed resubmission (pool reset, server stopping) keeps
                # the candidate the chunk already holds, as the window
                # ladder would
                log.warning("pool fallback retry at t=%.1f failed; keeping last "
                            "attempt: %s", t, e)
                break
            if not cands:
                break
            cand = max(cands, key=lambda c: c["avg_logprob"])
        return cand

    def _pool_retry_factory(self, server, audio, language, task, context, denoise):
        """The retry(temperature) closure of one pooled chunk (see
        _pool_quality_gate): best_of concurrent pool resubmissions of the
        chunk's submit-time audio at the rung's temperature. A beam pool
        decodes at t = 0 only, so its retry is one window-path decode of
        the chunk's audio, denoised as the pool would have, at the rung's
        temperature with beam_size=1 (whisper.cpp's beam to
        greedy-sampling ladder); decode_windows climbs the rest of the
        ladder with best_of itself."""
        best_of = max(1, int(self.config.best_of))
        if getattr(server.pool, "K", 1) > 1:
            def retry(temp: float) -> list[dict]:
                a = (audio.astype(np.float32) / 32767.0 if audio.dtype == np.int16
                     else audio)
                if denoise:
                    a = DSP.denoise_audio(a, DSP.DenoiseConfig(post_gain=1.0))
                mel = self.compute_mel(a, pad_to=server.pool.t_mel)
                return self.decode_windows(
                    mel, language, task=task, max_new_tokens=server.pool.max_new,
                    temperatures=[temp], context_tokens=[context] if context else None,
                    beam_size=1)[:1]

            return retry

        def retry(temp: float) -> list[dict]:
            futs = [server.submit_audio(audio, language=language, task=task,
                                        context=context, denoise=denoise, temperature=temp)
                    for _ in range(best_of)]
            return [f.result() for f in futs]

        return retry

    def _silence_suppressed(self, raw: dict) -> bool:
        """The no-speech gate of every stream path: no_speech_prob over its
        threshold and a poor avg_logprob (whisper's silence-hallucination
        suppression). Counts asr_no_speech_suppressed_total."""
        if (float(raw.get("no_speech_prob", 0.0)) > self.config.no_speech_thold
                and float(raw.get("avg_logprob", 0.0)) < self.config.logprob_thold):
            METRICS.inc("asr_no_speech_suppressed_total")
            return True
        return False

    def _update_stream_context(self, state: EngineState | None, text_toks: list[int],
                               hot: bool) -> None:
        """Conditioning context of stream chunks. hot (a window decoded at
        temperature > 0.5) resets it: openai's prompt_reset rule."""
        if state is None:
            return
        if hot:
            state.context_tokens = []
            return
        cap = self._slot_server.pool.max_prompt if self._slot_server is not None else 16
        state.context_tokens = (state.context_tokens + text_toks)[-cap:]

    def _finish_slot_chunk(self, raw: dict, n_samples: int, params: AsrParams,
                           language: str | None, state: EngineState | None) -> TranscribeResult:
        """Host postprocess of one pooled stream chunk: tokens to segments
        clamped to the chunk, conditioning context, and the reference
        segment pipeline."""
        if self._silence_suppressed(raw):
            return TranscribeResult(segments=[], full_text="", language=language,
                                    n_tokens=int(raw["n_sampled"]))
        window_dur = n_samples / SAMPLE_RATE
        segs, _ = D.segments_from_tokens(raw["tokens"], raw["n_sampled"], self.tokenizer)
        for s in segs:
            s["end"] = min(s["end"], window_dur)
            s["start"] = min(s["start"], s["end"])
        text_toks = [int(t) for t in raw["tokens"][: raw["n_sampled"]]
                     if t < self.tokenizer.eot]
        self._update_stream_context(state, text_toks,
                                    hot=float(raw.get("temperature", 0.0)) > 0.5)
        return self._postprocess(segs, params, language, n_tokens=int(raw["n_sampled"]))

    def _finish_slot_chunk_multi(self, raws: list[dict], piece_samples: int, n_samples: int,
                                 params: AsrParams, language: str | None,
                                 state: EngineState | None) -> TranscribeResult:
        """Host postprocess of one oversized chunk decoded as pool-bucket
        sub-windows: each piece's segments clamped to the piece and offset
        onto the chunk's timeline, then one segment pipeline over all."""
        segs_all: list[dict] = []
        text_toks: list[int] = []
        n_tokens = 0
        hot = any(float(r.get("temperature", 0.0)) > 0.5 for r in raws)
        for i, raw in enumerate(raws):
            n_tokens += int(raw["n_sampled"])
            if self._silence_suppressed(raw):
                continue
            off = i * piece_samples / SAMPLE_RATE
            dur = min(piece_samples, n_samples - i * piece_samples) / SAMPLE_RATE
            segs, _ = D.segments_from_tokens(raw["tokens"], raw["n_sampled"], self.tokenizer)
            for s in segs:
                s["end"] = min(s["end"], dur) + off
                s["start"] = min(s["start"], s["end"] - off) + off
            segs_all.extend(segs)
            text_toks.extend(int(t) for t in raw["tokens"][: raw["n_sampled"]]
                             if t < self.tokenizer.eot)
        self._update_stream_context(state, text_toks, hot=hot)
        return self._postprocess(segs_all, params, language, n_tokens=n_tokens)

    def submit_stream_chunk(self, state: EngineState | None, audio, params: AsrParams,
                            pad_to_bucket: bool = False):
        """Nonblocking stream-chunk submission for session-level pipelining.
        Returns a handle whose settle() gives the TranscribeResult, or None
        when the chunk must take the sequential transcribe_with_state path:
        no slot pool, a sub-bucket chunk without pad_to_bucket, or the bound
        of two conditioned chunks of one stream in flight. Oversized chunks
        ride the pool as sub-windows (_PendingMultiChunk). s16 PCM passes
        through unscaled (the pool dequantizes on the device)."""
        if not params.stream_mode:
            return None
        server = self._slot_server
        if server is None:
            return None
        audio = np.asarray(audio).reshape(-1)
        if audio.dtype != np.int16:
            audio = audio.astype(np.float32, copy=False)
        bucket = self._mel_bucket(max(1, audio.size // MEL.HOP_LENGTH))
        oversized = bucket > server.pool.t_mel
        if bucket != server.pool.t_mel and not oversized and not pad_to_bucket:
            return None
        context = None
        conditioned = False
        if (state is not None and params.condition_on_previous_text
                and server.pool.max_prompt > 16):
            # bounded conditioned pipelining: the prompt carries the
            # context at submit time, so with two chunks of one stream in
            # flight chunk k+1's prompt may lag chunk k's text by one chunk
            with state.lock:
                if state.inflight_conditioned >= 2:
                    return None
                state.inflight_conditioned += 1
                context = list(state.context_tokens) or None
            conditioned = True
        language = params.language or (state.language if state else None) or "en"

        def mk_retry(a):
            return self._pool_retry_factory(server, a, language, params.task, context,
                                            params.denoise)

        piece = server.pool.t_mel * MEL.HOP_LENGTH
        try:
            if oversized:
                futs = [server.submit_audio(audio[i:i + piece], language=language,
                                            task=params.task, context=context,
                                            denoise=params.denoise)
                        for i in range(0, audio.size, piece)]
            else:
                fut = server.submit_audio(audio, language=language, task=params.task,
                                          context=context, denoise=params.denoise)
        except Exception:
            if conditioned:
                with state.lock:
                    state.inflight_conditioned -= 1
            raise
        if oversized:
            retries = [mk_retry(audio[i:i + piece]) for i in range(0, audio.size, piece)]
            return _PendingMultiChunk(self, state, futs, piece, audio.size, params, language,
                                      conditioned=conditioned, retries=retries)
        return _PendingChunk(self, state, fut, audio.size, params, language,
                             conditioned=conditioned, retry=mk_retry(audio))

    def _transcribe_stream_chunk(self, audio, params: AsrParams, decode_window=None,
                                 state: EngineState | None = None) -> TranscribeResult:
        """One stream chunk (about 5 s), settled here: through the slot pool
        when its bucket is the pool's (oversized chunks as sub-windows),
        otherwise through the window path at the chunk's mel bucket."""
        audio = np.asarray(audio, np.float32).reshape(-1)
        bucket = self._mel_bucket(max(1, audio.size // MEL.HOP_LENGTH))
        language = params.language or "en"
        server = self._slot_server
        if server is not None and bucket >= server.pool.t_mel:
            # previous-text conditioning rides the prompt only on a pool
            # built with max_prompt > 16 (the reference's gate)
            context = None
            if (state is not None and params.condition_on_previous_text
                    and server.pool.max_prompt > 16):
                context = list(state.context_tokens) or None
            piece = server.pool.t_mel * MEL.HOP_LENGTH
            oversized = bucket > server.pool.t_mel
            starts = range(0, audio.size, piece) if oversized else range(1)
            futs = [server.submit_audio(audio[i:i + piece], language=language,
                                        task=params.task, context=context,
                                        denoise=params.denoise)
                    for i in starts]
            raws = [self._pool_quality_gate(
                        f.result(), self._pool_retry_factory(server, audio[i:i + piece],
                                                             language, params.task, context,
                                                             params.denoise))
                    for i, f in zip(starts, futs)]
            if oversized:
                return self._finish_slot_chunk_multi(raws, piece, audio.size, params,
                                                     language, state)
            return self._finish_slot_chunk(raws[0], audio.size, params, language, state)
        if server is not None:
            # a sub-bucket chunk on a pool built above the smallest bucket
            # decodes through the smaller window program
            METRICS.inc("asr_slot_bucket_fallbacks_total")
        if params.denoise:
            # the pool would have denoised on the device; honour the
            # request on the host for the window path
            audio = DSP.denoise_audio(audio, DSP.DenoiseConfig(post_gain=1.0))
        mel = self.compute_mel(audio, pad_to=bucket)
        if decode_window is None:
            def decode_window(mel, lang, task, sns, speaker_diarization=False,
                              temperature=0.0):
                return self.decode_windows(
                    mel, lang, task=task, suppress_non_speech=sns,
                    speaker_diarization=speaker_diarization,
                    temperatures=[temperature] if temperature else None,
                    max_new_tokens=96)[0]
        hook_params = set(inspect.signature(decode_window).parameters)
        kw = {}
        if "speaker_diarization" in hook_params:
            kw["speaker_diarization"] = params.speaker_diarization
        if "temperature" in hook_params:
            kw["temperature"] = params.temperature
        res = decode_window(mel, language, params.task, params.suppress_non_speech, **kw)
        if self._silence_suppressed(res):
            return TranscribeResult(segments=[], full_text="", language=language,
                                    n_tokens=int(res["n_sampled"]))
        window_dur = audio.size / SAMPLE_RATE
        segs, _ = D.segments_from_tokens(res["tokens"], res["n_sampled"], self.tokenizer)
        for s in segs:
            s["end"] = min(s["end"], window_dur)
            s["start"] = min(s["start"], s["end"])
        return self._postprocess(segs, params, language, n_tokens=int(res["n_sampled"]))
