"""Transcript post-processing: promotional-text filtering, CJK punctuation.

The port's own copy of `speaksense_tpu/asr/postprocess.py`, with the same
names and behaviour. Behavior mirror of the reference's src/asr/whisper.rs:
- `is_promotional_text` (:41-43): drop segments containing known
  video-platform promo phrases (Whisper hallucinates these on
  silence/music because they dominate subtitle training data).
- `add_punctuation` (:175-201): heuristic sentence-final punctuation for
  Chinese segments based on question/exclamation cue characters.
"""

from __future__ import annotations

import functools
import os
import re

# Same phrase set the reference filters (whisper.rs:9-14) — this is behavior
# data, not code: the phrases are the Chinese "like/subscribe/donate" subtitle
# hallucinations whisper emits on non-speech audio.
PROMOTIONAL_PHRASES: tuple[str, ...] = (
    "请不吝点赞", "請不吝點贊", "點贊", "訂閱", "订阅", "打赏", "打賞",
    "打賞支持明鏡與點點欄目", "打赏支持明镜与点点栏目",
    "並且按下小鈴鐺才能收到最新消息哦!", "請按讚、訂閱、分享!",
    "明镜需要您的支持 欢迎收看订阅明镜",
    "請按讚,訂閱,分享,打開小鈴鐺,並且按下小鈴鐺才能收到最新消息謝謝觀看",
    "請按讚,訂閱,分享,打開小鈴鐺,並且按下小鈴鐺才能收到最新消息哦!",
)

_QUESTION_CUES = ("吗", "呢", "什么", "为何", "怎么")
_EXCLAIM_CUES = ("啊", "哇", "太", "真", "好", "真是")
_SENTENCE_FINAL = ("。", "！", "？", "，")


def is_promotional_text(text: str, phrases: tuple[str, ...] = PROMOTIONAL_PHRASES) -> bool:
    return any(p in text for p in phrases)


def add_punctuation(text: str) -> str:
    """Append '？'/'！'/' ' by cue characters unless already punctuated
    (reference whisper.rs:175-201, applied per segment)."""
    if text.endswith(_SENTENCE_FINAL):
        return text
    if any(c in text for c in _QUESTION_CUES):
        return text + "？"
    if any(c in text for c in _EXCLAIM_CUES):
        return text + "！"
    return text + " "


def compression_ratio(text: str) -> float:
    """zlib compressibility — openai whisper's repetition detector."""
    import zlib

    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))


def token_entropy(tokens, window: int = 32) -> float:
    """whisper.cpp's repetition detector: Shannon entropy of the token-id
    histogram over the LAST `window` sampled tokens (whisper_sequence_score's
    n=32 window; the reference configures entropy_thold 2.4 at
    the reference's src/asr/whisper.rs:164). Low entropy = the tail is
    cycling through few distinct tokens = likely repetition loop."""
    import math

    tail = list(tokens)[-window:]
    if not tail:
        return 0.0
    counts: dict = {}
    for t in tail:
        counts[t] = counts.get(t, 0) + 1
    n = len(tail)
    return -sum((c / n) * math.log(c / n) for c in counts.values())


# --- dirty-word filtering (the reference accepts filter_dirty_words in its
# transcribe API, web/handlers/asr.rs:36-46, but never reads it; here the
# flag masks matches in the result text). The list is intentionally small
# and conservative — production deployments supply their own via
# extra_words / SPEAKSENSE_DIRTY_WORDS (comma-separated).

_DIRTY_WORDS_EN = ("fuck", "fucking", "shit", "bitch", "asshole", "bastard",
                   "dickhead", "cunt", "motherfucker")
_DIRTY_WORDS_ZH = ("他妈的", "妈的", "操你", "傻逼", "混蛋", "王八蛋", "草泥马")
_DIRTY_WORDS_JA = ("くそ", "クソ", "ちくしょう", "ばかやろう", "バカヤロウ")


def _dirty_words() -> tuple[str, ...]:
    extra = tuple(w for w in os.environ.get("SPEAKSENSE_DIRTY_WORDS", "").split(",") if w)
    return _DIRTY_WORDS_EN + _DIRTY_WORDS_ZH + _DIRTY_WORDS_JA + extra


@functools.lru_cache(maxsize=4)
def _dirty_pattern(words: tuple[str, ...]):
    # ASCII words match case-insensitively on word boundaries; CJK terms
    # match as substrings (no word boundaries in zh/ja text)
    ascii_words = [re.escape(w) for w in words if w.isascii()]
    cjk_words = [re.escape(w) for w in words if not w.isascii()]
    parts = []
    if ascii_words:
        parts.append(r"\b(?:%s)\b" % "|".join(ascii_words))
    if cjk_words:
        parts.append("(?:%s)" % "|".join(cjk_words))
    return re.compile("|".join(parts), re.IGNORECASE)


def filter_dirty_words(text: str, extra_words: tuple[str, ...] = ()) -> str:
    """Mask profanity with '*' of the same length (first char kept for
    ASCII words: "f***"). Deterministic and idempotent."""
    if not text:
        return text
    pat = _dirty_pattern(_dirty_words() + tuple(extra_words))

    def mask(m: "re.Match[str]") -> str:
        w = m.group(0)
        if w.isascii() and len(w) > 1:
            return w[0] + "*" * (len(w) - 1)
        return "*" * len(w)

    return pat.sub(mask, text)
