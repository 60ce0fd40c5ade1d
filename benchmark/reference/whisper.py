"""Plain reference of a Whisper encoder-decoder and of its greedy decoding
rules, in float32 PyTorch.

It decides whether a run of the benchmark is correct: the benchmark draws
the weights and the audio from the seed and hands the same to the program
and to this file. It imports torch and numpy only: nothing of the program,
no kernel, no cache, no batching. What the program derives from those
inputs (the log-mel, the fused and int8 weights, the cross-attention keys,
the token masks) is worked out here again from the published definitions:

- log-mel: openai/whisper `audio.log_mel_spectrogram` (a centred STFT with a
  periodic Hann window, n_fft 400, hop 160, the last frame dropped, a
  Slaney mel filterbank, log10 clamped at 1e-10, a floor 8 below the
  window's maximum, (x + 4) / 4);
- the model: openai/whisper `model.py` (conv stem with GELU, sinusoidal
  encoder positions held as a weight, pre-norm blocks, tied output
  embedding), every product in float32 with TF32 off;
- the rules: the timestamp rules of openai/whisper `decoding.py` with the
  serving system's one departure, that a forced timestamp leaves
  end-of-text legal (its decode loop says so at the forcing rule).

`gaps` measures a decoded sequence against these logits: for each served
token, by how much its log-probability lies below the best the rules let
through, the margin of the timestamp-forcing decision included.
`served_logprobs` gives each served token's log-probability as a decoder
that applies the rules samples it, the forcing included: what the
program sums into a window's `avg_logprob`.

`encode(..., lower=True)` and `decoder_logits(..., lower=True)` are the
benchmark's control: the model one step below the served precision
everywhere, every product's operands in float8 (e4m3, one scale per
tensor) where the program holds bf16 (the convolutions, the projections,
QK^T and PV, the MLP, the logits), and every decoder key and value rounded
to 4 bits where the program holds them in int8.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16_000
N_FFT = 400
HOP = 160


@dataclass(frozen=True)
class Shape:
    n_mels: int
    n_vocab: int
    d: int
    heads: int
    enc_layers: int
    dec_layers: int
    audio_ctx: int
    text_ctx: int

    @classmethod
    def from_config(cls, cfg: dict) -> "Shape":
        return cls(n_mels=cfg["num_mel_bins"], n_vocab=cfg["vocab_size"], d=cfg["d_model"],
                   heads=cfg["encoder_attention_heads"], enc_layers=cfg["encoder_layers"],
                   dec_layers=cfg["decoder_layers"], audio_ctx=cfg["max_source_positions"],
                   text_ctx=cfg["max_target_positions"])


@dataclass(frozen=True)
class Vocab:
    """The special-token layout of a multilingual Whisper vocabulary
    (openai/whisper `tokenizer.py`): end-of-text at 50257, then
    start-of-transcript, one token per language, translate, transcribe,
    start-of-lm, start-of-previous, no-speech, no-timestamps, and the
    timestamps from there to the end of the vocabulary."""

    eot: int
    sot: int
    lang_base: int
    num_languages: int
    translate: int
    transcribe: int
    sot_lm: int
    sot_prev: int
    no_speech: int
    no_timestamps: int
    ts_begin: int
    n_vocab: int
    blank: int | None

    @classmethod
    def multilingual(cls, n_vocab: int, blank: int | None = None) -> "Vocab":
        num_languages = 99 + (n_vocab - 51865)
        eot = 50257
        lang_base = eot + 2
        translate = lang_base + num_languages
        return cls(eot=eot, sot=eot + 1, lang_base=lang_base, num_languages=num_languages,
                   translate=translate, transcribe=translate + 1, sot_lm=translate + 2,
                   sot_prev=translate + 3, no_speech=translate + 4,
                   no_timestamps=translate + 5, ts_begin=translate + 6, n_vocab=n_vocab,
                   blank=blank)

    def prompt(self, language_index: int = 0) -> list[int]:
        """<|startoftranscript|><|lang|><|transcribe|>, timestamps on."""
        return [self.sot, self.lang_base + language_index, self.transcribe]

    def suppressed(self) -> list[int]:
        """Tokens never sampled while transcribing: the task and language
        markers and the other start tokens."""
        return ([self.sot, self.sot_lm, self.sot_prev, self.no_speech, self.translate,
                 self.transcribe]
                + list(range(self.lang_base, self.lang_base + self.num_languages)))


# ---------------------------------------------------------------------------
# log-mel
# ---------------------------------------------------------------------------

def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    logstep = math.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_hz / f_sp + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    f / f_sp)


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    logstep = math.log(6.4) / 27.0
    min_log_mel = min_log_hz / f_sp
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), f_sp * m)


def mel_filters(n_mels: int) -> np.ndarray:
    """Slaney-normalised triangular filters (n_mels, n_fft // 2 + 1), in
    float64: librosa's `filters.mel(sr=16000, n_fft=400, n_mels=n_mels)`."""
    freqs = np.linspace(0.0, SAMPLE_RATE / 2, N_FFT // 2 + 1)
    edges = _mel_to_hz(np.linspace(_hz_to_mel(np.float64(0.0)),
                                   _hz_to_mel(np.float64(SAMPLE_RATE / 2)), n_mels + 2))
    width = np.diff(edges)
    out = np.zeros((n_mels, freqs.size))
    for i in range(n_mels):
        rise = (freqs - edges[i]) / width[i]
        fall = (edges[i + 2] - freqs) / width[i + 1]
        out[i] = np.maximum(0.0, np.minimum(rise, fall)) * 2.0 / (edges[i + 2] - edges[i])
    return out


def log_mel(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """audio (n,) float32 at 16 kHz, n a whole number of hops -> (n / 160,
    n_mels) float32."""
    window = torch.hann_window(N_FFT, periodic=True, dtype=torch.float64, device=audio.device)
    spec = torch.stft(audio.double(), N_FFT, HOP, window=window, center=True,
                      pad_mode="reflect", return_complex=True)
    power = spec[:, :-1].abs() ** 2
    fb = torch.as_tensor(mel_filters(n_mels), device=audio.device)
    logs = torch.log10(torch.clamp(fb @ power, min=1e-10))
    logs = torch.maximum(logs, logs.max() - 8.0)
    return ((logs + 4.0) / 4.0).T.float().contiguous()


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def sinusoids(length: int, channels: int) -> torch.Tensor:
    """Whisper's encoder position table (length, channels), float32."""
    inc = math.log(10_000.0) / (channels // 2 - 1)
    inv = torch.exp(-inc * torch.arange(channels // 2, dtype=torch.float64))
    t = torch.arange(length, dtype=torch.float64)[:, None] * inv[None, :]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=1).float()


def _f(w: torch.Tensor) -> torch.Tensor:
    return w.float()


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the tensor (its largest
    magnitude at the format's largest, 448), back in float32."""
    scale = x.abs().amax().clamp(min=1e-12) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _lin(x, w, b=None, fp8=False):
    w = _f(w)
    if fp8:
        x, w = _fp8(x), _fp8(w)
    return F.linear(x, w, None if b is None else _f(b))


def _ln(x, p, name):
    return F.layer_norm(x, (x.shape[-1],), _f(p[name + ".g"]), _f(p[name + ".b"]), 1e-5)


def _heads(x, h):
    t, d = x.shape
    return x.view(t, h, d // h).transpose(0, 1)


def _attend(q, k, v, mask=None, fp8=False):
    """Softmax attention of (H, Tq, Dh) over (H, Tk, Dh) in float32; with
    fp8 both products take float8 operands."""
    if fp8:
        q, k, v = _fp8(q), _fp8(k), _fp8(v)
    logits = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
    if mask is not None:
        logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    out = (_fp8(p) if fp8 else p) @ v
    return out.transpose(0, 1).reshape(q.shape[1], -1)


def _quantize(x: torch.Tensor, bits: int | None, dim: int) -> torch.Tensor:
    """x rounded to a symmetric `bits`-bit grid with one scale per slice
    along `dim` (the largest magnitude maps to the grid's end)."""
    if bits is None:
        return x
    top = 2 ** (bits - 1) - 1
    scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-8) / top
    return torch.round(x / scale).clamp(-top, top) * scale


def _conv(x, w, b, stride, fp8=False):
    w = _f(w)
    if fp8:
        x, w = _fp8(x), _fp8(w)
    return F.conv1d(x, w, _f(b), stride=stride, padding=1)


def encode(w: dict, mel: torch.Tensor, s: Shape, lower: bool = False) -> torch.Tensor:
    """mel (2 * audio_ctx, n_mels) -> encoder states (audio_ctx, d). With
    `lower` (the control) every product takes float8 operands."""
    x = mel.T[None]
    x = F.gelu(_conv(x, w["enc.conv1.w"], w["enc.conv1.b"], 1, lower))
    x = F.gelu(_conv(x, w["enc.conv2.w"], w["enc.conv2.b"], 2, lower))
    x = x[0].T + _f(w["enc.pos"])

    def lin(h, name, bias=True):
        return _lin(h, w[name + ".w"], w[name + ".b"] if bias else None, fp8=lower)

    for i in range(s.enc_layers):
        p = f"enc.{i}."
        h = _ln(x, w, p + "attn_ln")
        q = _heads(lin(h, p + "q"), s.heads)
        k = _heads(lin(h, p + "k", bias=False), s.heads)
        v = _heads(lin(h, p + "v"), s.heads)
        x = x + lin(_attend(q, k, v, fp8=lower), p + "o")
        h = _ln(x, w, p + "mlp_ln")
        x = x + lin(F.gelu(lin(h, p + "fc1")), p + "fc2")
    return _ln(x, w, "enc.ln_post")


def decoder_logits(w: dict, enc: torch.Tensor, tokens: list[int], s: Shape,
                   lower: bool = False, self_bits: int | None = 4,
                   cross_bits: int | None = 4) -> torch.Tensor:
    """Causal decoder over `tokens` (T,) against encoder states (A, d):
    float32 logits (T, n_vocab). With `lower` (the control) every product
    takes float8 operands, attention's too, and every self-attention key
    and value is rounded to `self_bits` bits per token, every
    cross-attention one to `cross_bits` per channel over the frames (None:
    float8 alone, the step below keys and values held in bf16)."""
    dev = enc.device
    bits = (self_bits, cross_bits) if lower else (None, None)
    ids = torch.as_tensor(tokens, dtype=torch.long, device=dev)
    T = ids.shape[0]
    x = _f(w["dec.tok_emb"])[ids] + _f(w["dec.pos"])[:T]
    causal = torch.ones(T, T, dtype=torch.bool, device=dev).tril()[None]

    def lin(h, name, bias=True):
        return _lin(h, w[name + ".w"], w[name + ".b"] if bias else None, fp8=lower)

    for i in range(s.dec_layers):
        p = f"dec.{i}."
        h = _ln(x, w, p + "attn_ln")
        q = _heads(lin(h, p + "q"), s.heads)
        k = _quantize(_heads(lin(h, p + "k", bias=False), s.heads), bits[0], -1)
        v = _quantize(_heads(lin(h, p + "v"), s.heads), bits[0], -1)
        x = x + lin(_attend(q, k, v, causal, lower), p + "o")
        h = _ln(x, w, p + "cross_ln")
        q = _heads(lin(h, p + "cq"), s.heads)
        k = _quantize(_heads(lin(enc, p + "ck", bias=False), s.heads), bits[1], -2)
        v = _quantize(_heads(lin(enc, p + "cv"), s.heads), bits[1], -2)
        x = x + lin(_attend(q, k, v, fp8=lower), p + "co")
        h = _ln(x, w, p + "mlp_ln")
        x = x + lin(F.gelu(lin(h, p + "fc1")), p + "fc2")
    h = _ln(x, w, "dec.ln")
    emb = _f(w["dec.tok_emb"])
    return (_fp8(h) @ _fp8(emb).T) if lower else h @ emb.T


def no_speech_logprob(logits: torch.Tensor, vocab: Vocab) -> float:
    """log P(<|nospeech|>) at the start-of-transcript position (row 0), over
    the whole vocabulary: the log of a window's `no_speech_prob`."""
    return float(torch.log_softmax(logits[0].float(), dim=-1)[vocab.no_speech])


# ---------------------------------------------------------------------------
# the decoding rules and the gap of a served sequence
# ---------------------------------------------------------------------------

def history_logprobs(logits: torch.Tensor, served: list[int], vocab: Vocab,
                     max_initial_ts: int) -> torch.Tensor:
    """Row k of `logits` (n, V) chooses served[k]; returns its log-softmax
    after every rule that depends on the tokens before it (suppressed
    tokens, no blank or end-of-text first, timestamps in pairs and never
    decreasing, the first token a timestamp no later than max_initial_ts
    steps). Masked entries are -inf."""
    n, V = logits.shape
    dev = logits.device
    col = torch.arange(V, device=dev)[None, :]
    is_ts = col >= vocab.ts_begin
    is_text = col < vocab.eot
    mask = torch.zeros(n, V, dtype=torch.bool, device=dev)
    mask[:, vocab.suppressed()] = True
    mask[:, vocab.no_timestamps] = True
    blank = [vocab.eot] + ([] if vocab.blank is None else [vocab.blank])
    mask[0, blank] = True
    mask[0] |= ~is_ts[0] | (col[0] > vocab.ts_begin + max_initial_ts)
    last_ts = 0
    for k in range(1, n):
        last = served[k - 1]
        last_was_ts = last >= vocab.ts_begin
        penult_was_ts = k < 2 or served[k - 2] >= vocab.ts_begin
        if last_was_ts:
            last_ts = last
        if last_was_ts and penult_was_ts:
            mask[k] |= is_ts[0]
        elif last_was_ts:
            mask[k] |= is_text[0]
        if last_ts:
            floor = last_ts if (last_was_ts and not penult_was_ts) else last_ts + 1
            mask[k] |= is_ts[0] & (col[0] < floor)
    return torch.log_softmax(logits.float().masked_fill(mask, float("-inf")), dim=-1)


def _forcing(lp: torch.Tensor, vocab: Vocab):
    """Per row: the total log-probability of the timestamps, the best
    token below the timestamps, and the best among tokens that are not
    text (end-of-text and the timestamps)."""
    ts = torch.logsumexp(lp[:, vocab.ts_begin:], dim=-1)
    below = lp[:, :vocab.ts_begin].amax(dim=-1)
    non_text = lp[:, vocab.eot:].amax(dim=-1)
    return ts, below, non_text


def gaps(lp: torch.Tensor, served: list[int], vocab: Vocab) -> torch.Tensor:
    """(n,) how far each served token lies below the rules' best, in nats.

    A timestamp total above the best text forces a timestamp (end-of-text
    stays legal). A text token served where this forcing holds lies the
    forcing's margin below, or more; a timestamp or end-of-text served where
    it does not hold lies below the best token, or only by the forcing's
    margin and its own distance to the best non-text token, whichever is
    less: a near tie in the forcing decides between two legal answers."""
    ts, below, non_text = _forcing(lp, vocab)
    best = lp.amax(dim=-1)
    tok = torch.as_tensor(served, dtype=torch.long, device=lp.device)
    own = lp.gather(1, tok[:, None])[:, 0]
    forced = ts > below
    text = tok < vocab.eot
    free_gap = best - own
    gap = torch.where(
        text,
        torch.where(forced, torch.maximum(ts - below, free_gap), free_gap),
        torch.where(forced, non_text - own,
                    torch.minimum(free_gap, torch.maximum(below - ts, non_text - own))))
    return gap.clamp(min=0.0)


def served_logprobs(lp: torch.Tensor, served: list[int], vocab: Vocab) -> torch.Tensor:
    """(n,) each greedily served token's log-probability after every rule,
    the timestamp forcing included: where it holds, a timestamp or
    end-of-text is renormalised over the tokens that are not text. Which
    way the decoder went is read from the served token, so that a near tie
    in the forcing does not count as the decoder's error: a text token is
    never served under the forcing; a timestamp always is (one that beats
    every other token makes the timestamps' total beat them too). An
    end-of-text served without the forcing beat every text token, so it
    was forced where the best token lies further above it than the
    timestamps' total lies below the forcing: of the two ties it would
    take, the nearer one decides."""
    ts, below, _ = _forcing(lp, vocab)
    tok = torch.as_tensor(served, dtype=torch.long, device=lp.device)
    own = lp.gather(1, tok[:, None])[:, 0]
    non_text = torch.logsumexp(lp[:, vocab.eot:], dim=-1)
    eot_forced = lp.amax(dim=-1) - own > below - ts
    forced = (tok >= vocab.ts_begin) | ((tok == vocab.eot) & eot_forced)
    return torch.where(forced, own - non_text, own)


def choices(lp: torch.Tensor, vocab: Vocab) -> list[int]:
    """The token the rules put first at each row (greedy, forcing applied)."""
    ts, below, _ = _forcing(lp, vocab)
    forced = (ts > below)[:, None]
    col = torch.arange(lp.shape[1], device=lp.device)[None, :]
    return lp.masked_fill(forced & (col < vocab.eot), float("-inf")).argmax(dim=-1).tolist()
