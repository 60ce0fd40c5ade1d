"""WhisperEngine in PyTorch: the counterpart of `speaksense_tpu/asr/engine.py`
behind the port's `AsrEngine` interface (`speaksense_tpu_torch/asr`).

Covered: checkpoint loading (`from_pretrained`: ggml files of every quant
type whisper.cpp ships, through the convert-once weight cache, and HF
directories), random-weight and JAX-parameter construction, log-mel, batched
window decoding with whisper's temperature-fallback ladder (greedy attempt,
then best_of sampled candidate rows per pending window), language detection,
the openai-style long-form seek loop with no-speech skipping and
previous-text conditioning, the reference's segment post-processing, and
the streaming surface: stream-mode chunks through the greedy slot pool
(`runtime/slots.py`) with device denoise, the pooled fallback ladder,
no-speech suppression, conditioning context, session pipelining
(`submit_stream_chunk`), oversized chunks split into pool-bucket
sub-windows and the padded tail flush; a sub-bucket chunk without a pool
takes the window path.

Not ported yet, each raising NotImplementedError that names its ROADMAP
item: beam search and the beam pool, word timestamps, VAD segmentation,
multi-GPU sharding and the int8 weight/KV options.
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
from speaksense_tpu_torch.models import decode as D
from speaksense_tpu_torch.config import EngineConfig
from speaksense_tpu_torch.models import whisper as W
from speaksense_tpu_torch.models.tokenizer import Tokenizer
from speaksense_tpu_torch.utils.metrics import REGISTRY as METRICS

log = logging.getLogger(__name__)

SAMPLE_RATE = MEL.SAMPLE_RATE
# whisper temperature fallback schedule (openai + whisper.cpp)
FALLBACK_TEMPS = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)

_LATER = {
    "int8": "int8 paths (int8 weights, int8 cross-KV, int8 self-KV)",
    "beam": "beam search and the beam pool",
    "stream": "transcribe_audio_vad and word_timestamps",
    "multi": "multi-GPU",
}


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to speaksense_tpu_torch yet "
        f"(ROADMAP.md Queue 1, remaining: {_LATER[item]})")


def _refuse_int8(config: EngineConfig) -> None:
    if config.weights_int8 or config.cross_kv_int8 or config.self_kv_int8:
        raise _not_ported("int8 weights / KV", "int8")


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
    def __init__(self, model: W.Whisper, tokenizer: Tokenizer,
                 mel_filters: np.ndarray | None = None,
                 config: EngineConfig | None = None, name: str = "whisper", seed: int = 0):
        self.config = config or EngineConfig()
        _refuse_int8(self.config)
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
        self._rng = torch.Generator(device=self.device).manual_seed(seed)
        self._slot_server = None

    # ------------------------------------------------------------------ load

    @staticmethod
    def _dtype(config: EngineConfig) -> torch.dtype:
        return torch.bfloat16 if config.compute_dtype == "bfloat16" else torch.float32

    @classmethod
    def from_random(cls, model: str = "large-v3", config: EngineConfig | None = None,
                    device="cuda", seed: int = 0) -> "WhisperEngine":
        """Random-weight engine (no checkpoint needed); the weights are drawn
        on `device` from a generator seeded with `seed`."""
        config = config or EngineConfig()
        dims = W.MODEL_DIMS[model]
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
        hold one fused projection, so `config.fuse_qkv` changes nothing."""
        config = config or EngineConfig()
        m = W.params_from_jax(np_params, dims, device=device, dtype=cls._dtype(config))
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
        _refuse_int8(config)     # before reading gigabytes
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
        _refuse_int8(config)
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
        raise _not_ported("multi-GPU sharding", "multi")

    # ------------------------------------------------------------------ audio

    def compute_mel(self, audio, pad_to: int | None = None) -> torch.Tensor:
        """audio (n,) or (B, n) f32 @16k -> (B, T_mel, n_mels) on the engine's
        device. pad_to selects a frame count (3000 for full windows)."""
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

    def _run_window(self, mels, prompt, prompt_len, sot_index, temps, with_ts: bool,
                    max_new: int, suppress) -> dict:
        cfg = D.RuleConfig.from_tokenizer(
            self.tokenizer, with_timestamps=with_ts,
            max_initial_ts=self.config.max_initial_ts, max_new_tokens=max_new)
        n_audio_ctx = min(mels.shape[1] // 2, self.dims.n_audio_ctx)
        out = D.transcribe_window(
            self.model, cfg, suppress, mels, prompt,
            torch.as_tensor(temps, dtype=torch.float32, device=self.device),
            self._rng, sot_index=sot_index, n_audio_ctx=n_audio_ctx, prompt_len=prompt_len)
        return {k: out[k].cpu().numpy()
                for k in ("tokens", "n_sampled", "avg_logprob", "no_speech_prob")}

    def decode_windows(self, mels, language, task: str = "transcribe",
                       with_timestamps: bool = True, suppress_non_speech: bool = False,
                       max_new_tokens: int | None = None, temperatures=None,
                       beam_size: int | None = None,
                       speaker_diarization: bool = False,
                       context_tokens: list | None = None) -> list[dict]:
        """Decode a batch of mel windows with per-row temperature fallback.
        mels: (B, T_mel, n_mels); language: one code or a per-row list.
        Returns per-row dicts with tokens/text/avg_logprob/no_speech_prob/
        compression_ratio/temperature."""
        if beam_size is None:
            beam_size = self.config.beam_size
        if beam_size and beam_size > 1:
            raise _not_ported("beam search", "beam")
        mels = torch.as_tensor(mels, device=self.device)
        B = mels.shape[0]
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
        METRICS.inc("asr_windows_total", B)
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

        # attempt 0: every row at its starting temperature (greedy by default)
        out = self._run_window(mels, prompt, prompt_len, sot_index, temps,
                               with_timestamps, max_new, suppress)
        for b in range(B):
            _settle(b, _candidate(out, b, temps[b]))

        # retries: t > 0 sampling with best_of candidate rows per pending
        # window; the best avg_logprob wins (openai best_of rule)
        best_of = max(1, int(self.config.best_of))
        for _attempt in range(1, len(schedule)):
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
                out = self._run_window(mels[idx], prompt[idx], prompt_len[idx],
                                       sot_index[idx], temps[np.asarray(cand_rows)],
                                       with_timestamps, max_new, suppress)
                for gi, s_i in enumerate(group):
                    rows_i = range(gi * best_of, (gi + 1) * best_of)
                    best_row = max(rows_i, key=lambda r: out["avg_logprob"][r])
                    _settle(s_i, _candidate(out, best_row, temps[s_i]))
        for b in range(B):
            if results[b] is None:
                results[b] = last_attempt[b]
        METRICS.observe("asr_decode_window_seconds", time.perf_counter() - t_start)
        return results

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
        window through its shared batch."""
        if params.word_timestamps:
            raise _not_ported("word_timestamps", "stream")
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
            raw_segments.extend(segs)
            if advance is not None and advance > 0.5:
                seek += int(advance * SAMPLE_RATE)
            else:
                seek += MEL.N_SAMPLES
        return self._postprocess(raw_segments, params, language, n_tokens=n_tokens)

    def transcribe_audio_vad(self, audio: np.ndarray, params: AsrParams,
                             decode_window=None) -> TranscribeResult:
        raise _not_ported("transcribe_audio_vad", "stream")

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
        (`pad_to_bucket`), oversized ones as split sub-windows. int8 pools
        and beam pools are not ported."""
        from speaksense_tpu_torch.runtime.slots import StreamingDecodeServer

        if beam_size is None:
            beam_size = self.config.beam_size or 1
        self._slot_server = StreamingDecodeServer(
            self, n_slots=n_slots or self.config.stream_slots, t_mel=t_mel, max_new=max_new,
            int8_kv=self.config.cross_kv_int8 if int8_kv is None else int8_kv,
            self_int8=bool(self_int8), max_prompt=max_prompt, beam_size=beam_size)

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
        stay continuously batched with live traffic); the best avg_logprob
        wins (openai best_of rule), and a chunk that still fails at t = 1.0
        keeps its last attempt, as decode_windows does."""
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
                cands = [self._pool_candidate(c) for c in retry(t)]
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
        chunk's submit-time audio at the rung's temperature."""
        best_of = max(1, int(self.config.best_of))

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
