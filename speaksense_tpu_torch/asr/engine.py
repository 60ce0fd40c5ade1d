"""WhisperEngine in PyTorch: the counterpart of `speaksense_tpu/asr/engine.py`
behind the shared `AsrEngine` interface.

Covered: random-weight and JAX-parameter construction, log-mel, batched
window decoding with whisper's temperature-fallback ladder (greedy attempt,
then best_of sampled candidate rows per pending window), language detection,
the openai-style long-form seek loop with no-speech skipping and
previous-text conditioning, and the reference's segment post-processing.

Not ported yet, each raising NotImplementedError that names its ROADMAP
item: stream mode and stream-chunk submission, slot serving, beam search,
word timestamps, VAD segmentation, ggml/HF checkpoint loading, multi-GPU
sharding and the int8 weight/KV options.
"""

from __future__ import annotations

import inspect
import logging
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from speaksense_tpu.asr import AsrEngine, AsrParams, TranscribeResult, TranscribeSegment
from speaksense_tpu.asr import postprocess as PP
from speaksense_tpu.config import EngineConfig
from speaksense_tpu.utils.metrics import REGISTRY as METRICS
from speaksense_tpu_torch._shared import Tokenizer
from speaksense_tpu_torch.audio import mel as MEL
from speaksense_tpu_torch.models import decode as D
from speaksense_tpu_torch.models import whisper as W

log = logging.getLogger(__name__)

SAMPLE_RATE = MEL.SAMPLE_RATE
# whisper temperature fallback schedule (openai + whisper.cpp)
FALLBACK_TEMPS = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)

_LATER = {
    "int8": "int8 paths (int8 weights, int8 cross-KV, int8 self-KV)",
    "slots": "slot pool with device denoise and mel",
    "beam": "beam search and the beam pool",
    "stream": "transcribe_audio_vad, stream mode and word_timestamps",
    "ckpt": "ggml and HF checkpoint loading",
    "multi": "multi-GPU",
}


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to speaksense_tpu_torch yet "
        f"(ROADMAP.md Queue 1, remaining: {_LATER[item]})")


@dataclass
class EngineState:
    """Per-stream host-side context (non-stream mode keeps only the
    detected language and the per-stream lock)."""

    language: str | None = None
    lock: threading.Lock = field(default_factory=threading.Lock)


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


class WhisperEngine(AsrEngine):
    def __init__(self, model: W.Whisper, tokenizer: Tokenizer,
                 mel_filters: np.ndarray | None = None,
                 config: EngineConfig | None = None, name: str = "whisper", seed: int = 0):
        self.config = config or EngineConfig()
        if self.config.weights_int8 or self.config.cross_kv_int8 or self.config.self_kv_int8:
            raise _not_ported("int8 weights / KV", "int8")
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
        # sampling noise for the t > 0 fallback attempts
        self._rng = torch.Generator(device=self.device).manual_seed(seed)

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
                        config: EngineConfig | None = None, device="cpu") -> "WhisperEngine":
        """Engine on the JAX package's parameter pytree (numpy arrays)."""
        config = config or EngineConfig()
        m = W.params_from_jax(np_params, dims, device=device, dtype=cls._dtype(config))
        return cls(m, tokenizer, config=config, name="jax-params")

    @classmethod
    def from_ggml(cls, path: str, config: EngineConfig | None = None) -> "WhisperEngine":
        raise _not_ported("ggml loading", "ckpt")

    @classmethod
    def from_hf_dir(cls, path: str, config: EngineConfig | None = None) -> "WhisperEngine":
        raise _not_ported("HF checkpoint loading", "ckpt")

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
        speaker turns, short-segment merging."""
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
        if params.stream_mode:
            raise _not_ported("stream mode", "stream")
        with state.lock:
            if params.language is None and state.language:
                params = AsrParams(**{**params.__dict__, "language": state.language})
            result = self.transcribe_audio(np.asarray(audio, np.float32), params,
                                           decode_window)
            state.language = result.language or state.language
            return result

    def enable_slot_serving(self, *args, **kwargs) -> None:
        raise _not_ported("slot serving", "slots")

    def submit_stream_chunk(self, state, audio, params: AsrParams, pad_to_bucket: bool = False):
        raise _not_ported("stream-chunk submission", "stream")
