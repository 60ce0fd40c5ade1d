"""Whisper tokenizer: id<->bytes vocabulary plus the special-token layout.

The port's own copy of `speaksense_tpu/models/tokenizer.py`, with the same
names and behaviour (numpy and the standard library; the optional `regex`
package gives GPT-2's Unicode pre-tokenization, `re` the ASCII fallback).

The reference delegates tokenization entirely to whisper.cpp (the ggml file
embeds the byte-decoded BPE vocab, which whisper.cpp concatenates per token —
consumed via full_get_segment_text at the reference's src/asr/whisper.rs:85).
We read the same embedded vocab (ckpt/ggml.py) and derive the special-token
ids from n_vocab, matching the openai/whisper layout:

  english models (n_vocab 51864):   eot=50256, sot=50257, ...
  multilingual v1/v2 (51865):       eot=50257, sot=50258, 99 languages
  multilingual v3 (51866):          one more language ('yue')

followed by <|translate|>, <|transcribe|>, <|startoflm|>, <|startofprev|>,
<|nospeech|>, <|notimestamps|>, and 1501 timestamp tokens <|0.00|>..<|30.00|>
at 20 ms resolution.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# Canonical whisper language order; index -> position after the SOT token.
LANGUAGES = (
    "en zh de es ru ko fr ja pt tr pl ca nl ar sv it id hi fi vi he uk el ms "
    "cs ro da hu ta no th ur hr bg lt la mi ml cy sk te fa lv bn sr az sl kn "
    "et mk br eu is hy ne mn bs kk sq sw gl mr pa si km sn yo so af oc ka be "
    "tg sd gu am yi lo uz fo ht ps tk nn mt sa lb my bo tl mg as tt haw ln "
    "ha ba jw su yue"
).split()

TS_RESOLUTION = 0.02   # seconds per timestamp token
TS_COUNT = 1501        # <|0.00|> .. <|30.00|>

# Strings whose exact-match vocab ids are suppressed during sampling so the
# decoder cannot emit bracketed/annotation junk (openai's non_speech_tokens;
# whisper.cpp mirrors it via suppress_non_speech_tokens — the reference turns
# that OFF at the reference's src/asr/whisper.rs:152, so suppression is
# configurable in AsrParams).
_NON_SPEECH = (
    list('"#()*+/:;<=>@[\\]^_`{|}~「」『』')
    + "<< >> <<< >>> -- --- -( -[ (' (\" (( )) ((( ))) [[ ]] {{ }} ♪♪ ♪♪♪".split()
    + list("♩♪♫♬♭♮♯")
)


@dataclass
class Tokenizer:
    vocab: list[bytes]            # id -> raw UTF-8-ish bytes for text tokens
    n_vocab: int
    multilingual: bool
    num_languages: int
    # special ids
    eot: int = field(init=False)
    sot: int = field(init=False)
    lang_base: int = field(init=False)
    translate: int = field(init=False)
    transcribe: int = field(init=False)
    sot_lm: int = field(init=False)
    sot_prev: int = field(init=False)
    no_speech: int = field(init=False)
    no_timestamps: int = field(init=False)
    ts_begin: int = field(init=False)

    def __post_init__(self):
        self.eot = 50257 if self.multilingual else 50256
        self.sot = self.eot + 1
        self.lang_base = self.sot + 1
        self.translate = self.lang_base + self.num_languages
        self.transcribe = self.translate + 1
        self.sot_lm = self.transcribe + 1
        self.sot_prev = self.sot_lm + 1
        self.no_speech = self.sot_prev + 1
        self.no_timestamps = self.no_speech + 1
        self.ts_begin = self.no_timestamps + 1

    # -- construction -------------------------------------------------------

    @classmethod
    def from_vocab(cls, vocab: list[bytes]) -> "Tokenizer":
        n_vocab = len(vocab)
        multilingual = n_vocab >= 51865
        num_languages = (99 + (n_vocab - 51865)) if multilingual else 99
        return cls(vocab=vocab, n_vocab=n_vocab, multilingual=multilingual,
                   num_languages=num_languages)

    @classmethod
    def synthetic(cls, n_vocab: int = 51865) -> "Tokenizer":
        """Placeholder vocab for random-weight tests/benchmarks: realistic
        special-token layout, dummy text pieces."""
        base = 50257 if n_vocab >= 51865 else 50256
        vocab = [b"<%d>" % i for i in range(min(base, n_vocab))]
        return cls.from_vocab(vocab + [b""] * (n_vocab - len(vocab)))

    # -- special-token helpers ---------------------------------------------

    def lang_token(self, code: str) -> int:
        try:
            return self.lang_base + LANGUAGES.index(code)
        except ValueError:
            raise KeyError(f"unknown language code {code!r}") from None

    def lang_code(self, token_id: int) -> str:
        return LANGUAGES[token_id - self.lang_base]

    def timestamp_token(self, seconds: float) -> int:
        return self.ts_begin + int(round(seconds / TS_RESOLUTION))

    def timestamp_seconds(self, token_id: int) -> float:
        return (token_id - self.ts_begin) * TS_RESOLUTION

    def is_timestamp(self, token_id: int) -> bool:
        return token_id >= self.ts_begin

    def sot_sequence(self, language: str | None = None, task: str = "transcribe",
                     timestamps: bool = True) -> list[int]:
        """[sot, lang, task(, notimestamps)] prompt prefix (multilingual);
        english-only models use just [sot]."""
        if not self.multilingual:
            seq = [self.sot]
        else:
            lang = self.lang_token(language if language else "en")
            seq = [self.sot, lang, self.transcribe if task == "transcribe" else self.translate]
        if not timestamps:
            seq.append(self.no_timestamps)
        return seq

    # -- text ---------------------------------------------------------------

    def decode(self, ids, skip_special: bool = True) -> str:
        out = bytearray()
        for i in ids:
            i = int(i)
            if i < self.eot and i < len(self.vocab):
                out += self.vocab[i]
            elif not skip_special:
                out += self.special_str(i).encode("utf-8")
        return out.decode("utf-8", errors="replace")

    def decode_bytes(self, ids) -> bytes:
        out = bytearray()
        for i in ids:
            i = int(i)
            if i < self.eot and i < len(self.vocab):
                out += self.vocab[i]
        return bytes(out)

    def special_str(self, i: int) -> str:
        if i == self.eot:
            return "<|endoftext|>"
        if i == self.sot:
            return "<|startoftranscript|>"
        if self.lang_base <= i < self.lang_base + self.num_languages:
            return f"<|{self.lang_code(i)}|>"
        if i == self.translate:
            return "<|translate|>"
        if i == self.transcribe:
            return "<|transcribe|>"
        if i == self.sot_lm:
            return "<|startoflm|>"
        if i == self.sot_prev:
            return "<|startofprev|>"
        if i == self.no_speech:
            return "<|nospeech|>"
        if i == self.no_timestamps:
            return "<|notimestamps|>"
        if i >= self.ts_begin:
            return f"<|{self.timestamp_seconds(i):.2f}|>"
        return f"<|unk{i}|>"

    # GPT-2 pre-tokenization pattern (openai/gpt-2 encoder.py); merges never
    # cross these word boundaries
    _GPT2_PAT = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+|"
                 r" ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")

    def encode_text(self, text: str) -> list[int]:
        """Byte-level BPE encode against the embedded vocab.

        The ggml container ships no merges table, but GPT-2-family vocabs
        (whisper's included) list tokens in MERGE ORDER — token id order IS
        merge priority. True BPE is therefore reconstructible: start from
        single bytes and repeatedly merge the adjacent pair whose
        concatenation has the LOWEST vocab id. This matches openai's
        encoder."""
        index: dict[bytes, int] = self._piece_index()
        out: list[int] = []
        for word in self._pre_tokenize(text):
            out.extend(self._bpe_word(word, index))
        return out

    def _pre_tokenize(self, text: str) -> list[bytes]:
        try:
            import regex  # \p{L}/\p{N} classes; ships with transformers

            pat = self.__dict__.get("_gpt2_pat_cache")
            if pat is None:
                pat = regex.compile(self._GPT2_PAT)
                self.__dict__["_gpt2_pat_cache"] = pat
            return [m.group().encode("utf-8") for m in pat.finditer(text)]
        except ImportError:  # pragma: no cover - regex is in this image
            import re

            return [m.group().encode("utf-8")
                    for m in re.finditer(rb"'s|'t|'re|'ve|'m|'ll|'d| ?[A-Za-z]+|"
                                         rb" ?\d+| ?[^\sA-Za-z\d]+|\s+",
                                         text.encode("utf-8"))]

    def _bpe_word(self, data: bytes, index: dict[bytes, int]) -> list[int]:
        if not data:
            return []
        parts = [data[i : i + 1] for i in range(len(data))]
        while len(parts) > 1:
            best_id, best_i = None, -1
            for i in range(len(parts) - 1):
                tid = index.get(parts[i] + parts[i + 1])
                if tid is not None and (best_id is None or tid < best_id):
                    best_id, best_i = tid, i
            if best_id is None:
                break
            parts[best_i : best_i + 2] = [parts[best_i] + parts[best_i + 1]]
        out = []
        for p in parts:
            tid = index.get(p)
            if tid is not None:
                out.append(tid)
            # unencodable byte (not in vocab): dropped
        return out

    def _piece_index(self) -> dict[bytes, int]:
        cached = self.__dict__.get("_piece_index_cache")
        if cached is None:
            cached = {v: i for i, v in enumerate(self.vocab[: self.eot]) if v}
            self.__dict__["_piece_index_cache"] = cached
        return cached

    # -- suppression sets ---------------------------------------------------

    def speaker_turn_token(self) -> int | None:
        """tinydiarize speaker-turn marker if this vocab carries one
        (whisper.cpp tdrz models; the reference enables it via
        set_tdrz_enable at whisper.rs:136-139)."""
        cached = self.__dict__.get("_solm_cache", -2)
        if cached != -2:
            return cached
        out = None
        for i, piece in enumerate(self.vocab):
            if piece in (b"[_SOLM_]", b"<|speakerturn|>", b" [_SOLM_]"):
                out = i
                break
        self.__dict__["_solm_cache"] = out
        return out

    def non_speech_tokens(self) -> list[int]:
        idx = self._piece_index()
        out = set()
        for s in (" -", " '"):
            tid = idx.get(s.encode())
            if tid is not None:
                out.add(tid)
        for sym in _NON_SPEECH:
            for cand in (sym, " " + sym):
                tid = idx.get(cand.encode())
                if tid is not None:
                    out.add(tid)
        return sorted(out)

    def blank_token(self) -> int | None:
        return self._piece_index().get(b" ")

    def suppress_mask(self, suppress_non_speech: bool = True,
                      allow_speaker_turn: bool = False) -> np.ndarray:
        """(n_vocab,) bool — True where sampling is forbidden always:
        specials that must never be sampled mid-transcription, plus the
        non-speech set when enabled. allow_speaker_turn unmasks the tdrz
        marker for diarization-enabled decoding."""
        m = np.zeros((self.n_vocab,), bool)
        for t in (self.sot, self.sot_lm, self.sot_prev, self.no_speech, self.translate,
                  self.transcribe):
            m[t] = True
        m[self.lang_base : self.lang_base + self.num_languages] = True
        if suppress_non_speech:
            m[self.non_speech_tokens()] = True
        if allow_speaker_turn:
            turn = self.speaker_turn_token()
            if turn is not None:
                m[turn] = False
        return m
