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

import logging
import threading
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from speaksense_tpu_torch.models import whisper as W
from speaksense_tpu_torch.models.tokenizer import TS_RESOLUTION, Tokenizer
from speaksense_tpu_torch.utils.metrics import REGISTRY as METRICS

NEG_INF = -1e30

log = logging.getLogger(__name__)


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


@dataclass
class LoopState:
    """What a window decode carries from one step to the next, written in
    place: the logits the next token is sampled from (B, V) f32, the
    sampled tokens (B, max_new) (EOT-padded), the rule state, the rows that
    have emitted EOT, the running log-probability sum and `step`, a 0-d
    int64 on the device: the step the next token is sampled at, the column
    it is written to."""

    logits: torch.Tensor
    tokens: torch.Tensor
    n_sampled: torch.Tensor
    last: torch.Tensor
    penult: torch.Tensor
    last_ts: torch.Tensor
    finished: torch.Tensor
    sum_lp: torch.Tensor
    step: torch.Tensor

    @classmethod
    def empty(cls, B: int, V: int, max_new: int, device) -> "LoopState":
        def z(dtype, *shape):
            return torch.zeros(shape, dtype=dtype, device=device)

        return cls(logits=z(torch.float32, B, V), tokens=z(torch.long, B, max_new),
                   n_sampled=z(torch.long, B), last=z(torch.long, B), penult=z(torch.long, B),
                   last_ts=z(torch.long, B), finished=z(torch.bool, B),
                   sum_lp=z(torch.float32, B), step=z(torch.long))

    def start(self, first_logits: torch.Tensor, eot: int) -> "LoopState":
        """The state before the first step: first_logits, EOT tokens, zeros."""
        self.logits.copy_(first_logits)
        self.tokens.fill_(eot)
        for t in (self.n_sampled, self.last, self.penult, self.last_ts, self.finished,
                  self.sum_lp, self.step):
            t.zero_()
        return self


def sample_token(st: LoopState, cfg: RuleConfig, suppress_mask: torch.Tensor,
                 temperature: torch.Tensor, generator: torch.Generator | None,
                 hot: bool) -> torch.Tensor:
    """The token at step `st.step` for every row, in place on `st`: the
    logit rules on `st.logits`, sampling, EOT for rows already finished,
    the token's column, the rule state, `finished` and the log-probability
    sum. Returns the (B,) tokens."""
    filtered = apply_logit_rules(st.logits, cfg, suppress_mask, st.n_sampled, st.last,
                                 st.penult, st.last_ts)
    tok = _sample(filtered, temperature, generator, hot)
    tok = torch.where(st.finished, cfg.eot, tok)
    lp = torch.log_softmax(filtered, dim=-1)
    tok_lp = lp.gather(-1, tok[:, None])[:, 0]
    newly_done = ~st.finished & (tok == cfg.eot)
    active = ~st.finished
    st.tokens.index_copy_(1, st.step.view(1), tok[:, None])
    upd = active & ~newly_done
    st.n_sampled += upd.long()
    st.penult.copy_(torch.where(upd, st.last, st.penult))
    st.last.copy_(torch.where(upd, tok, st.last))
    st.last_ts.copy_(torch.where(upd & (tok >= cfg.ts_begin), tok, st.last_ts))
    st.finished |= newly_done
    st.sum_lp += torch.where(active, tok_lp, 0.0)
    return tok


@torch.no_grad()
def decode_loop(model: W.Whisper, cfg: RuleConfig, suppress_mask: torch.Tensor,
                first_logits: torch.Tensor, cache: W.KVCache, prompt_len: torch.Tensor,
                gen_base: int, temperature: torch.Tensor,
                generator: torch.Generator | None = None,
                steps: "WindowSteps | None" = None) -> dict:
    """Sample from the post-prompt logits until every row has emitted EOT or
    max_new_tokens were sampled. Returns
      tokens (B, max_new) int64 — sampled tokens, EOT-padded,
      n_sampled (B,) — count of real tokens (excluding EOT),
      sum_logprob (B,) — sum of sampled-token logprobs (including EOT).

    With `steps` (greedy rows over its own cache and inputs, which the
    caller has loaded) each step but the last is `steps.advance`: the token
    and the model step after it, replayed from the ring row's CUDA graph
    where there is one. The host still reads `finished` after every step.
    Counts its steps in `asr_decode_steps_total` and the replayed ones in
    `asr_decode_graph_steps_total`."""
    L = cfg.max_new_tokens
    if steps is None:
        B, V = first_logits.shape
        st = LoopState.empty(B, V, L, first_logits.device).start(first_logits, cfg.eot)
        hot = bool((temperature > 0).any())     # read once, not at every step
    else:
        st, hot = steps.state.start(first_logits, cfg.eot), False
    replayed = n_steps = 0
    for step in range(L):
        n_steps = step + 1
        with METRICS.span("decode.step", step=step):
            if steps is not None and step + 1 < L:
                replayed += steps.advance(step)
            else:
                tok = sample_token(st, cfg, suppress_mask, temperature, generator, hot)
                if step + 1 == L:
                    break
            with METRICS.span("decode.sync"):     # the host waits for the card here
                done = bool(st.finished.all())
            if done:
                break
            if steps is None:
                st.logits = W.decode_step(model, tok, cache, step, prompt_len, gen_base)
                st.step += 1
    METRICS.inc("asr_decode_steps_total", n_steps)
    METRICS.inc("asr_decode_graph_steps_total", replayed)
    out = dict(tokens=st.tokens, n_sampled=st.n_sampled, sum_logprob=st.sum_lp)
    # the entry's buffers serve its next batch: hand out copies
    return out if steps is None else {k: v.clone() for k, v in out.items()}


def ring_width(max_new: int) -> int:
    """The window path's int8 self-KV ring: 16 rows, halved until it
    divides the token budget, so flushes tile it (the reference's
    `decode_loop`)."""
    width = 16
    while max_new % width:
        width //= 2
    return width


class WindowSteps:
    """One greedy window decode over int8 self pages, made replayable: the
    batch's cache (int8 self pages of P + max_new columns with their ring,
    the cross-KV) and inputs (`prompt_len`, `suppress`) and the loop's
    `LoopState` live in buffers allocated once and written in place, so a
    step reads no host value that changes from step to step but its ring
    row n = step % W. The pages are as wide as the eager loop's, so the
    arithmetic, and the bits, are the eager loop's: pages wider than the
    prompt needs would lengthen the softmax and the value products, and
    round them otherwise on the card. `nbytes` is what the entry holds.

    On a CUDA device each ring row's step (`body`) runs eagerly the first
    time on a side stream, which warms it up, and is then captured into a
    CUDA graph; later steps of that row replay it. The W graphs share one
    memory pool and keep no tensor alive in it between replays, so they
    replay in any order. A capture that raises leaves the entry eager
    (`failed`) and the step's result stands: a capture runs nothing. On
    the CPU the body always runs eagerly."""

    def __init__(self, model: W.Whisper, cfg: RuleConfig, B: int, P: int, n_audio_ctx: int,
                 cross_int8: bool, device, width: int):
        device = torch.device(device)
        self.model, self.cfg, self.gen_base, self.cross_int8 = model, cfg, P, cross_int8
        self.width = width
        cross = W.zero_cross(model, B, n_audio_ctx, device, int8=cross_int8)
        self.cache = W.new_cache(model, cross, P + cfg.max_new_tokens, self_int8=True,
                                 ring_width=width)
        self.prompt_len = torch.zeros(B, dtype=torch.long, device=device)
        self.suppress = torch.zeros(model.dims.n_vocab, dtype=torch.bool, device=device)
        self.temperature = torch.zeros(B, dtype=torch.float32, device=device)
        self.state = LoopState.empty(B, model.dims.n_vocab, cfg.max_new_tokens, device)
        self.nbytes = sum(t.numel() * t.element_size()
                          for t in (*vars(self.cache).values(), *vars(self.state).values())
                          if t is not None)
        self.graphs: dict[int, torch.cuda.CUDAGraph] = {}
        self.capture = device.type == "cuda"
        self.failed = False
        self.stream = torch.cuda.Stream(device) if self.capture else None
        self.pool = torch.cuda.graph_pool_handle() if self.capture else None
        self.lock = threading.Lock()
        self.key = None             # its key in the `WindowGraphs` that made it

    def load(self, enc: torch.Tensor, prompt_len: torch.Tensor,
             suppress_mask: torch.Tensor) -> W.KVCache:
        """A batch into the entry: the cross-KV of the encoder states enc
        computed into its buffers, zero self pages, scales and ring, the
        prompt lengths and the suppress mask. Returns the cache, for the
        prefill."""
        c = self.cache
        cross = (c.cross_k, c.cross_v) + ((c.cross_ks, c.cross_vs) if self.cross_int8 else ())
        W.compute_cross_kv(self.model, enc, int8=self.cross_int8, out=cross)
        for t in (c.self_k, c.self_v, c.self_ks, c.self_vs, c.ring_k, c.ring_v):
            t.zero_()
        self.prompt_len.copy_(prompt_len)
        self.suppress.copy_(suppress_mask)
        return c

    def body(self, n: int) -> None:
        """One step at ring row n: the token at `state.step` (greedy), the
        model step after it, its logits into `state.logits`, the step
        counter advanced. What a graph of row n holds."""
        st = self.state
        tok = sample_token(st, self.cfg, self.suppress, self.temperature, None, False)
        st.logits.copy_(W.decode_step(self.model, tok, self.cache, st.step, self.prompt_len,
                                      self.gen_base, ring_n=n))
        st.step += 1

    def advance(self, step: int) -> bool:
        """Run loop step `step` (not the last): True where a graph replayed
        it."""
        n = step % self.width
        graph = self.graphs.get(n)
        if graph is not None:
            graph.replay()
            return True
        if not self.capture:
            self.body(n)
            return False
        current = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            self.body(n)            # the step itself, which warms its row up
            try:
                self.graphs[n] = self._capture(n)
                METRICS.inc("asr_decode_graph_captures_total")
            except RuntimeError:
                log.exception("capturing the window step failed (B %d, ring row %d); "
                              "these batches decode eagerly", self.state.tokens.shape[0], n)
                self.capture, self.failed = False, True
                self.graphs.clear()
        current.wait_stream(self.stream)
        return False

    def _capture(self, n: int) -> torch.cuda.CUDAGraph:
        graph = torch.cuda.CUDAGraph()
        # thread_local: other threads (a client's mel) keep using the card
        graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
        try:
            self.body(n)
        finally:
            graph.capture_end()
        return graph


class WindowGraphs:
    """The window path's `WindowSteps` entries, one for each key: what a
    batch's decode is built from: the model, the rules (constants of the
    graphs), B, the padded prompt length P, the encoder frames, the
    cross-KV's form and the device (max_new, the ring's width and the
    compute dtype follow from the rules and the model). A key's first batch
    captures its graphs. The entries hold at most `budget_bytes` together
    (by default a quarter of a CUDA card's memory: the weights and the slot
    pools keep the rest), the least recently used going first; a batch
    whose entry alone would pass it decodes eagerly. A key whose capture
    failed stays eager for the life of this object. The caller that owns
    it (`WhisperEngine`) passes it to `transcribe_window`."""

    BUDGET_SHARE = 0.25

    def __init__(self, budget_bytes: int | None = None):
        self.budget_bytes = budget_bytes
        self._entries: OrderedDict = OrderedDict()
        self._eager: set = set()
        self._lock = threading.Lock()

    def _budget(self, device: torch.device) -> float:
        if self.budget_bytes is not None:
            return self.budget_bytes
        if device.type != "cuda":
            return float("inf")
        return self.BUDGET_SHARE * torch.cuda.get_device_properties(device).total_memory

    def take(self, model: W.Whisper, cfg: RuleConfig, B: int, P: int, n_audio_ctx: int,
             cross_int8: bool, device) -> WindowSteps | None:
        """The key's entry, locked for the caller (`release` it), or None
        where the batch decodes eagerly: its key is eager, another thread
        holds the entry, or the entry would not fit the budget."""
        device = torch.device(device)
        key = (id(model), cfg, B, P, n_audio_ctx, cross_int8, model.dtype, str(device))
        with self._lock:
            if key in self._eager:
                return None
            entry = self._entries.get(key)
            if entry is None:
                args = (model, cfg, B, P, n_audio_ctx, cross_int8)
                width = ring_width(cfg.max_new_tokens)
                need = WindowSteps(*args, "meta", width).nbytes     # sized, not allocated
                budget = self._budget(device)
                if need > budget:
                    return None
                while self._entries and (need + sum(e.nbytes for e in self._entries.values())
                                         > budget):
                    self._entries.popitem(last=False)
                entry = self._entries[key] = WindowSteps(*args, device, width)
                entry.key = key
            self._entries.move_to_end(key)
            return entry if entry.lock.acquire(blocking=False) else None

    def release(self, entry: WindowSteps) -> None:
        with self._lock:
            if entry.failed:
                self._eager.add(entry.key)
                self._entries.pop(entry.key, None)
        entry.lock.release()


def graphs_engage(model: W.Whisper, device, self_kv_int8: bool,
                  temperature: torch.Tensor) -> bool:
    """Whether a window batch's steps replay from CUDA graphs: greedy rows
    (no temperature above 0, read from the device last) over int8 self
    pages with their ring, on one CUDA card (a mesh's gloo calls cannot be
    captured). Everything else decodes eagerly."""
    return (torch.device(device).type == "cuda" and self_kv_int8 and model.mesh is None
            and not bool((temperature > 0).any()))


@torch.no_grad()
def transcribe_window(model: W.Whisper, cfg: RuleConfig, suppress_mask: torch.Tensor,
                      mel: torch.Tensor, prompt: torch.Tensor, temperature: torch.Tensor,
                      generator: torch.Generator | None = None,
                      sot_index: torch.Tensor | int = 0, n_audio_ctx: int | None = None,
                      prompt_len: torch.Tensor | None = None, cross_kv_int8: bool = False,
                      self_kv_int8: bool = False, graphs: WindowGraphs | None = None) -> dict:
    """Encode one batch of windows and decode them to tokens.

    mel (B, T_mel, n_mels); prompt (B, P) right-padded, with prompt_len (B,)
    the true lengths; sot_index (B,) locates <|sot|> per row for the
    no-speech probability. cross_kv_int8: per-channel int8 cross-KV;
    self_kv_int8: int8 self-KV pages quantized at the ring's flush
    boundaries (`W.decode_step`). graphs: where `graphs_engage`, the batch
    is decoded in an entry of it (`WindowSteps`), its steps replayed from
    CUDA graphs. Returns the `decode_loop` outputs plus avg_logprob (B,)
    and no_speech_prob (B,)."""
    B, P = prompt.shape
    dev = prompt.device
    steps = None
    if graphs is not None and graphs_engage(model, dev, self_kv_int8, temperature):
        steps = graphs.take(model, cfg, B, P, n_audio_ctx or mel.shape[1] // 2, cross_kv_int8,
                            dev)
    if prompt_len is None:
        prompt_len = torch.full((B,), P, dtype=torch.long, device=dev)
    try:
        with METRICS.span("decode.encode", device=dev):
            enc = W.encode(model, mel, n_ctx_out=n_audio_ctx)
        with METRICS.span("decode.cross_kv", device=dev):
            if steps is None:
                cache = W.init_cache(model, enc, t_cap=P + cfg.max_new_tokens,
                                     cross_int8=cross_kv_int8, self_int8=self_kv_int8,
                                     ring_width=ring_width(cfg.max_new_tokens))
            else:
                cache = steps.load(enc, prompt_len, suppress_mask)
                prompt_len, suppress_mask = steps.prompt_len, steps.suppress
            del enc
        with METRICS.span("decode.prefill", device=dev):
            prefill_logits = W.decode_prefill(model, prompt, cache)
            rows = torch.arange(B, device=dev)
            sot_idx = torch.as_tensor(sot_index, dtype=torch.long, device=dev).expand(B)
            no_speech_prob = torch.softmax(prefill_logits[rows, sot_idx].float(),
                                           dim=-1)[:, cfg.no_speech]
            first_logits = prefill_logits[rows, prompt_len - 1]
        with METRICS.span("decode.steps", device=dev):
            out = decode_loop(model, cfg, suppress_mask, first_logits, cache, prompt_len, P,
                              temperature, generator, steps=steps)
    finally:
        if steps is not None:
            graphs.release(steps)
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
    values and are masked by `active`.

    With int8 self pages the steps' K/V go to the pages' ring at the pool's
    in-chunk step (`ring_n` of `pool_step`) and every W steps the ring is
    flushed into each slot's own columns: fcol is the column of the slot's
    next flushed token, born the ring row of its first token in the current
    chunk (rows below it belong to the slot's previous occupant)."""

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
    fcol: torch.Tensor
    born: torch.Tensor

    @classmethod
    def empty(cls, model: W.Whisper, n_slots: int, max_new: int, t_text: int,
              n_audio_ctx: int, eot: int, device, cross_int8: bool = False,
              self_int8: bool = False, ring_width: int = 16) -> "PoolState":
        def z(dtype, *shape):
            return torch.zeros((n_slots, *shape), dtype=dtype, device=device)

        pages = W.init_pool_pages(model, n_slots, t_text, n_audio_ctx, device,
                                  cross_int8=cross_int8, self_int8=self_int8,
                                  ring_width=ring_width)
        return cls(pages=pages,
                   tokens=torch.full((n_slots, max_new), eot, dtype=torch.long, device=device),
                   last_logits=z(torch.float32, model.dims.n_vocab),
                   n_sampled=z(torch.long), last=z(torch.long), penult=z(torch.long),
                   last_ts=z(torch.long), active=z(torch.bool), sum_lp=z(torch.float32),
                   ns_prob=z(torch.float32), temp=z(torch.float32),
                   plen=torch.ones(n_slots, dtype=torch.long, device=device),
                   ppad=torch.ones(n_slots, dtype=torch.long, device=device),
                   fcol=torch.ones(n_slots, dtype=torch.long, device=device), born=z(torch.long))


@torch.no_grad()
def pool_step(model: W.Whisper, cfg: RuleConfig, suppress_mask: torch.Tensor, st: PoolState,
              generator: torch.Generator | None, hot: bool, ring_n: int = 0) -> torch.Tensor:
    """One token for every slot of the pool, in place on `st` (the JAX
    `SlotPool._build_step` body): logit rules, greedy argmax or, for slots
    with temperature > 0, Gumbel-max sampling (hot: whether any slot is hot,
    kept on the host so an all-greedy step never waits for the device), the
    token's log-probability, the token write, the model step at each slot's
    own position and column, and retirement at EOT or at the max_new cap.
    A retired slot's temperature is cleared. With int8 self pages the model
    step writes ring row ring_n (the pool's steps modulo the ring's width)
    and the step that fills the ring flushes it. Returns the (S,) bool of
    slots that finished at this step."""
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
    pos = (st.plen + st.n_sampled).clamp(max=model.dims.n_text_ctx - 1)
    if st.pages.ring_k is None:
        col = (st.ppad + st.n_sampled).clamp(max=t_text - 1)
        mask = W.pool_mask(t_text, st.plen, st.ppad, col)
        st.last_logits = W.decode_step_pool(model, tok, st.pages, pos, col, mask)
    else:
        # int8 pages: the slot's prompt and its flushed tokens [ppad, fcol)
        # in int8, the chunk's earlier tokens [born, ring_n) in the ring
        mask_c, mask_r = W.ring_masks(st.pages, st.plen, st.ppad, st.fcol, st.born, ring_n)
        st.last_logits = W.decode_step_pool_ring(model, tok, st.pages, pos, ring_n, mask_c,
                                                 mask_r)
        if ring_n == st.pages.ring_k.shape[3] - 1:
            st.fcol, st.born, _, _ = W.flush_ring(st.pages, st.fcol, st.born)

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
