"""Batched autoregressive decoding with Whisper's timestamp-rule state
machine: the counterpart of `speaksense_tpu/models/decode.py`.

The reference runs the sampling loop as one `lax.while_loop`; here it is a
Python loop over decode steps that stops once every row has emitted EOT (or
at max_new_tokens). The logit rules are the same vectorised mask arithmetic
(openai's SuppressBlank, SuppressTokens, timestamp pairing, monotonicity,
max_initial_ts and the timestamp-probability forcing rule). Temperature > 0
samples with Gumbel-max noise drawn from a `torch.Generator`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from speaksense_tpu_torch.models import whisper as W
from speaksense_tpu_torch.models.tokenizer import TS_RESOLUTION, Tokenizer

NEG_INF = -1e30


@dataclass(frozen=True)
class RuleConfig:
    """Static decode configuration."""

    eot: int
    ts_begin: int
    no_timestamps: int
    no_speech: int
    blank: int
    max_initial_ts_tok: int      # highest allowed first timestamp id (inclusive)
    with_timestamps: bool = True
    max_new_tokens: int = 224

    @classmethod
    def from_tokenizer(cls, tok: Tokenizer, with_timestamps: bool = True,
                       max_initial_ts: float = 1.0, max_new_tokens: int = 224) -> "RuleConfig":
        blank = tok.blank_token()
        return cls(
            eot=tok.eot, ts_begin=tok.ts_begin, no_timestamps=tok.no_timestamps,
            no_speech=tok.no_speech,
            blank=blank if blank is not None else tok.eot,
            max_initial_ts_tok=tok.ts_begin + int(round(max_initial_ts / TS_RESOLUTION)),
            with_timestamps=with_timestamps, max_new_tokens=max_new_tokens,
        )


def apply_logit_rules(logits: torch.Tensor, cfg: RuleConfig, suppress_mask: torch.Tensor,
                      n_sampled: torch.Tensor, last: torch.Tensor, penult: torch.Tensor,
                      last_ts: torch.Tensor) -> torch.Tensor:
    """Vectorised whisper logit rules. logits (B, V) f32; per-row state:
    n_sampled (B,), last/penult sampled tokens (B,), last_ts (B,) (0 = none).
    Returns the filtered logits."""
    B, V = logits.shape
    vocab_ids = torch.arange(V, device=logits.device)[None, :]
    is_ts_col = vocab_ids >= cfg.ts_begin
    is_text_col = vocab_ids < cfg.eot

    logits = logits.masked_fill(suppress_mask[None, :], NEG_INF)

    first = (n_sampled == 0)[:, None]
    blank_cols = (vocab_ids == cfg.blank) | (vocab_ids == cfg.eot)
    logits = logits.masked_fill(first & blank_cols, NEG_INF)

    if not cfg.with_timestamps:
        return logits.masked_fill(is_ts_col | (vocab_ids == cfg.no_timestamps), NEG_INF)

    logits = logits.masked_fill(vocab_ids == cfg.no_timestamps, NEG_INF)

    last_was_ts = (n_sampled >= 1) & (last >= cfg.ts_begin)
    penult_was_ts = (n_sampled < 2) | (penult >= cfg.ts_begin)
    # lone timestamp -> timestamp or EOT next; closed pair -> text next
    mask_ts = (last_was_ts & penult_was_ts)[:, None] & is_ts_col
    mask_text = (last_was_ts & ~penult_was_ts)[:, None] & is_text_col
    logits = logits.masked_fill(mask_ts | mask_text, NEG_INF)

    # monotonic timestamps
    have_ts = last_ts > 0
    thresh = torch.where(last_was_ts & ~penult_was_ts, last_ts, last_ts + 1)
    mono = have_ts[:, None] & is_ts_col & (vocab_ids < thresh[:, None])
    logits = logits.masked_fill(mono, NEG_INF)

    # the first sampled token is a timestamp no later than max_initial_ts
    logits = logits.masked_fill(first & ~is_ts_col, NEG_INF)
    logits = logits.masked_fill(first & (vocab_ids > cfg.max_initial_ts_tok), NEG_INF)

    # total timestamp probability beats the best text token -> force a timestamp
    logprobs = torch.log_softmax(logits, dim=-1)
    ts_logprob = torch.logsumexp(logprobs.masked_fill(~is_ts_col, NEG_INF), dim=-1)
    max_text = logprobs.masked_fill(is_ts_col, NEG_INF).amax(dim=-1)
    force_ts = (ts_logprob > max_text)[:, None] & is_text_col   # EOT stays legal
    return logits.masked_fill(force_ts, NEG_INF)


def _sample(logits: torch.Tensor, temperature: torch.Tensor,
            generator: torch.Generator | None, hot: bool | None = None) -> torch.Tensor:
    """Greedy where temperature == 0, Gumbel-max elsewhere; temperature (B,).
    hot says from the host whether any row has temperature > 0; None reads
    it from the device, which waits for the device."""
    t = temperature.clamp(min=0.0)[:, None]
    if hot is None:
        hot = bool((t > 0).any())
    if not hot:
        return logits.argmax(dim=-1)
    u = torch.rand(logits.shape, generator=generator, device=logits.device) + 1e-20
    gumbel = -torch.log(-torch.log(u))
    noisy = torch.where(t > 0, logits / t.clamp(min=1e-6) + gumbel, logits)
    return noisy.argmax(dim=-1)


@torch.no_grad()
def decode_loop(model: W.Whisper, cfg: RuleConfig, suppress_mask: torch.Tensor,
                first_logits: torch.Tensor, cache: W.KVCache, prompt_len: torch.Tensor,
                gen_base: int, temperature: torch.Tensor,
                generator: torch.Generator | None = None) -> dict:
    """Sample from the post-prompt logits until every row has emitted EOT or
    max_new_tokens were sampled. Returns
      tokens (B, max_new) int64 — sampled tokens, EOT-padded,
      n_sampled (B,) — count of real tokens (excluding EOT),
      sum_logprob (B,) — sum of sampled-token logprobs (including EOT)."""
    B = first_logits.shape[0]
    L = cfg.max_new_tokens
    dev = first_logits.device
    tokens = torch.full((B, L), cfg.eot, dtype=torch.long, device=dev)
    n_sampled = torch.zeros(B, dtype=torch.long, device=dev)
    last = torch.zeros(B, dtype=torch.long, device=dev)
    penult = torch.zeros(B, dtype=torch.long, device=dev)
    last_ts = torch.zeros(B, dtype=torch.long, device=dev)
    finished = torch.zeros(B, dtype=torch.bool, device=dev)
    sum_lp = torch.zeros(B, dtype=torch.float32, device=dev)
    logits = first_logits
    hot = bool((temperature > 0).any())     # read once, not at every step
    for step in range(L):
        filtered = apply_logit_rules(logits, cfg, suppress_mask, n_sampled, last, penult, last_ts)
        tok = _sample(filtered, temperature, generator, hot)
        tok = torch.where(finished, cfg.eot, tok)
        lp = torch.log_softmax(filtered, dim=-1)
        tok_lp = lp.gather(-1, tok[:, None])[:, 0]
        newly_done = ~finished & (tok == cfg.eot)
        active = ~finished
        tokens[:, step] = tok
        upd = active & ~newly_done
        n_sampled += upd.long()
        penult = torch.where(upd, last, penult)
        last = torch.where(upd, tok, last)
        last_ts = torch.where(upd & (tok >= cfg.ts_begin), tok, last_ts)
        finished = finished | newly_done
        sum_lp += torch.where(active, tok_lp, 0.0)
        if step + 1 == L or bool(finished.all()):
            break
        logits = W.decode_step(model, tok, cache, step, prompt_len, gen_base)
    return dict(tokens=tokens, n_sampled=n_sampled, sum_logprob=sum_lp)


@torch.no_grad()
def transcribe_window(model: W.Whisper, cfg: RuleConfig, suppress_mask: torch.Tensor,
                      mel: torch.Tensor, prompt: torch.Tensor, temperature: torch.Tensor,
                      generator: torch.Generator | None = None,
                      sot_index: torch.Tensor | int = 0, n_audio_ctx: int | None = None,
                      prompt_len: torch.Tensor | None = None) -> dict:
    """Encode one batch of windows and decode them to tokens.

    mel (B, T_mel, n_mels); prompt (B, P) right-padded, with prompt_len (B,)
    the true lengths; sot_index (B,) locates <|sot|> per row for the
    no-speech probability. Returns the `decode_loop` outputs plus
    avg_logprob (B,) and no_speech_prob (B,)."""
    B, P = prompt.shape
    dev = prompt.device
    if prompt_len is None:
        prompt_len = torch.full((B,), P, dtype=torch.long, device=dev)
    enc = W.encode(model, mel, n_ctx_out=n_audio_ctx)
    cache = W.init_cache(model, enc, t_cap=P + cfg.max_new_tokens)
    prefill_logits = W.decode_prefill(model, prompt, cache)
    rows = torch.arange(B, device=dev)
    sot_idx = torch.as_tensor(sot_index, dtype=torch.long, device=dev).expand(B)
    no_speech_prob = torch.softmax(prefill_logits[rows, sot_idx].float(), dim=-1)[:, cfg.no_speech]
    first_logits = prefill_logits[rows, prompt_len - 1]
    out = decode_loop(model, cfg, suppress_mask, first_logits, cache, prompt_len, P,
                      temperature, generator)
    out["avg_logprob"] = out["sum_logprob"] / (out["n_sampled"] + 1).float()
    out["no_speech_prob"] = no_speech_prob
    return out


@dataclass
class PoolState:
    """Device state of a slot pool of S slots: the pool pages and, per
    slot, the sampled tokens (S, max_new) (EOT-padded), the logits the next
    step samples from (S, V), the rule state, the running log-probability
    sum, the no-speech probability read at admission, the sampling
    temperature, and the true and padded prompt lengths that place the
    slot's keys (`W.pool_mask`). Rows of free slots hold stale but finite
    values and are masked by `active`."""

    pages: W.KVCache
    tokens: torch.Tensor
    last_logits: torch.Tensor
    n_sampled: torch.Tensor
    last: torch.Tensor
    penult: torch.Tensor
    last_ts: torch.Tensor
    active: torch.Tensor
    sum_lp: torch.Tensor
    ns_prob: torch.Tensor
    temp: torch.Tensor
    plen: torch.Tensor
    ppad: torch.Tensor

    @classmethod
    def empty(cls, model: W.Whisper, n_slots: int, max_new: int, t_text: int,
              n_audio_ctx: int, eot: int, device) -> "PoolState":
        def z(dtype, *shape):
            return torch.zeros((n_slots, *shape), dtype=dtype, device=device)

        return cls(pages=W.init_pool_pages(model, n_slots, t_text, n_audio_ctx, device),
                   tokens=torch.full((n_slots, max_new), eot, dtype=torch.long, device=device),
                   last_logits=z(torch.float32, model.dims.n_vocab),
                   n_sampled=z(torch.long), last=z(torch.long), penult=z(torch.long),
                   last_ts=z(torch.long), active=z(torch.bool), sum_lp=z(torch.float32),
                   ns_prob=z(torch.float32), temp=z(torch.float32),
                   plen=torch.ones(n_slots, dtype=torch.long, device=device),
                   ppad=torch.ones(n_slots, dtype=torch.long, device=device))


@torch.no_grad()
def pool_step(model: W.Whisper, cfg: RuleConfig, suppress_mask: torch.Tensor, st: PoolState,
              generator: torch.Generator | None, hot: bool) -> torch.Tensor:
    """One token for every slot of the pool, in place on `st` (the JAX
    `SlotPool._build_step` body): logit rules, greedy argmax or, for slots
    with temperature > 0, Gumbel-max sampling (hot: whether any slot is hot,
    kept on the host so an all-greedy step never waits for the device), the
    token's log-probability, the token write, the model step at each slot's
    own position and column, and retirement at EOT or at the max_new cap.
    A retired slot's temperature is cleared. Returns the (S,) bool of slots
    that finished at this step."""
    filtered = apply_logit_rules(st.last_logits, cfg, suppress_mask, st.n_sampled,
                                 st.last, st.penult, st.last_ts)
    tok = _sample(filtered, st.temp, generator, hot)
    tok = torch.where(st.active, tok, cfg.eot)
    tok_lp = torch.log_softmax(filtered, dim=-1).gather(-1, tok[:, None])[:, 0]
    newly_done = st.active & (tok == cfg.eot)
    still = st.active & ~newly_done

    S, max_new = st.tokens.shape
    rows = torch.arange(S, device=tok.device)
    write = st.n_sampled.clamp(max=max_new - 1)
    st.tokens[rows, write] = torch.where(st.active, tok, st.tokens[rows, write])
    # the token sits at position plen + n and its K/V goes to column
    # ppad + n (n = steps since admission while the slot is active); a
    # retired row's column is clamped and its writes are never read
    t_text = st.pages.self_k.shape[3]
    col = (st.ppad + st.n_sampled).clamp(max=t_text - 1)
    pos = (st.plen + st.n_sampled).clamp(max=model.dims.n_text_ctx - 1)
    mask = W.pool_mask(t_text, st.plen, st.ppad, col)
    st.last_logits = W.decode_step_pool(model, tok, st.pages, pos, col, mask)

    hit_cap = still & (st.n_sampled + 1 >= max_new)
    st.penult = torch.where(still, st.last, st.penult)
    st.last = torch.where(still, tok, st.last)
    st.last_ts = torch.where(still & (tok >= cfg.ts_begin), tok, st.last_ts)
    st.n_sampled = st.n_sampled + still.long()
    st.sum_lp = st.sum_lp + torch.where(st.active, tok_lp, 0.0)
    finished = newly_done | hit_cap
    st.active = st.active & ~finished
    st.temp = torch.where(st.active, st.temp, 0.0)
    return finished


@torch.no_grad()
def detect_language(model: W.Whisper, enc_out: torch.Tensor, tok: Tokenizer):
    """One forward pass from [sot]: probability mass over the language
    tokens. Returns (lang_ids (B,), probs (B, V))."""
    B = enc_out.shape[0]
    cache = W.init_cache(model, enc_out, t_cap=1)
    sot = torch.full((B, 1), tok.sot, dtype=torch.long, device=enc_out.device)
    logits = W.decode_prefill(model, sot, cache)[:, 0].float()
    mask = torch.ones(tok.n_vocab, dtype=torch.bool, device=enc_out.device)
    mask[tok.lang_base: tok.lang_base + tok.num_languages] = False
    probs = torch.softmax(logits.masked_fill(mask[None, :], NEG_INF), dim=-1)
    return probs.argmax(dim=-1), probs


def segments_from_tokens(tokens: np.ndarray, n_sampled: int, tok: Tokenizer,
                         window_offset: float = 0.0):
    """Host-side: split one row's sampled tokens into timestamped segments.
    Returns (segments, seek_advance_seconds); openai long-form stitching
    (see the reference's `segments_from_tokens`)."""
    ids = [int(t) for t in tokens[:n_sampled]]
    segments = []
    seek_advance = None
    # indices of the SECOND token of each consecutive-timestamp pair
    consecutive = [i for i in range(1, len(ids))
                   if tok.is_timestamp(ids[i]) and tok.is_timestamp(ids[i - 1])]
    if consecutive:
        # a window ending in ONE closing timestamp is consumed whole; otherwise
        # only complete slices are emitted and the seek goes back to the last
        # pair-closing timestamp so the open tail is decoded again
        single_ts_ending = (len(ids) >= 2 and tok.is_timestamp(ids[-1])
                            and not tok.is_timestamp(ids[-2]))
        slices = consecutive + ([len(ids)] if single_ts_ending else [])
        last_slice = 0
        for i in slices:
            segments.append(_make_segment(ids[last_slice:i], tok, window_offset))
            last_slice = i
        if not single_ts_ending:
            seek_advance = tok.timestamp_seconds(ids[last_slice - 1])
    else:
        seg = _make_segment(ids, tok, window_offset)
        if seg["tokens"]:
            segments.append(seg)
        ts = [t for t in ids if tok.is_timestamp(t)]
        if len(ts) >= 2:
            seek_advance = tok.timestamp_seconds(ts[-1])
    segments = [s for s in segments if s["tokens"]]
    return segments, seek_advance


def _make_segment(ids: list[int], tok: Tokenizer, offset: float) -> dict:
    ts = [t for t in ids if tok.is_timestamp(t)]
    text_ids = [t for t in ids if t < tok.eot]
    start = tok.timestamp_seconds(ts[0]) if ts else 0.0
    end = tok.timestamp_seconds(ts[-1]) if len(ts) >= 2 else (start + 30.0 if ts else 30.0)
    turn = tok.speaker_turn_token()
    return {
        "start": offset + start,
        "end": offset + end,
        "text": tok.decode(text_ids),
        "tokens": text_ids,
        # tinydiarize: the NEXT segment has a new speaker
        "speaker_turn_next": turn is not None and turn in ids,
    }
