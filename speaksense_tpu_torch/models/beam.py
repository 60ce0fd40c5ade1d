"""Beam-search decoding: the counterpart of `speaksense_tpu/models/beam.py`
(`beam_decode`, `transcribe_window_beam`), and the device state and step of
the beam slot pool (the programs of `speaksense_tpu/runtime/beam_slots.py`).

Self-KV is never reordered. Each hypothesis row always writes its own page
row, and an ancestor table anc (B, K, T) records, for every hypothesis and
column, which of its batch row's K page rows holds the key it reads there.
Attention scores each hypothesis against all K rows of its batch row in one
product and picks each column's logit with anc; the values are contracted
under the same selection. A reorder moves the small int64 table, never the
pages. The prompt columns need no ancestry: every row holds the same prompt
KV. Cross-KV is stored once per batch row; the K hypotheses are its query
rows.

Each step takes the joint top-k over K x V per batch row (ties to the lower
index, as `lax.top_k`), after the logit rules of every hypothesis.
Finished hypotheses freeze: their only continuation is EOT at zero added
log-probability. The final choice is total logprob / (length + 1).

Page layout (L, B, H, K, T, Dh): a batch row's K page rows sit together
under each head, so one layer's pages are one (B, H, K·T, Dh) operand. The
window search keeps its pages in the compute dtype and writes each step's
column in place; the pool writes a ring in the compute dtype and flushes it
every W steps into pages that are int8 with per-token scales by default,
as the greedy pool does (`W.flush_ring`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from speaksense_tpu_torch.models import decode as D
from speaksense_tpu_torch.models import whisper as W
from speaksense_tpu_torch.models.decode import NEG_INF, RuleConfig


def _topk_lowest_index(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of each row of x (R, N) f32, in descending
    order, equal values taken lowest index first (the order of
    `jax.lax.top_k`; `torch.topk` leaves ties unordered). One top-k over an
    int64 key: the f32 bits mapped to an order-preserving int32, above the
    reversed index."""
    bits = x.contiguous().view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    n = x.shape[-1]
    key = key * (1 << 32) + (n - 1 - torch.arange(n, device=x.device))
    idx = torch.topk(key, k, dim=-1).indices
    return x.gather(-1, idx), idx


def beam_select(logits: torch.Tensor, scores: torch.Tensor, finished: torch.Tensor,
                n_sampled: torch.Tensor, last: torch.Tensor, penult: torch.Tensor,
                last_ts: torch.Tensor, cfg: RuleConfig, suppress_mask: torch.Tensor):
    """One step's joint top-k: the logit rules on every hypothesis row
    (logits (B·K, V), rule state (B, K)), a finished hypothesis continued by
    EOT alone at zero added log-probability, and the K best (score, parent,
    token) of each batch row over its K x V continuations."""
    B, K = scores.shape
    V = logits.shape[-1]
    filtered = D.apply_logit_rules(logits, cfg, suppress_mask, n_sampled.reshape(-1),
                                   last.reshape(-1), penult.reshape(-1), last_ts.reshape(-1))
    logprobs = torch.log_softmax(filtered, dim=-1).view(B, K, V)
    eot_only = torch.full((V,), NEG_INF, device=logits.device)
    eot_only[cfg.eot] = 0.0
    logprobs = torch.where(finished[:, :, None], eot_only, logprobs)
    top, idx = _topk_lowest_index((scores[:, :, None] + logprobs).reshape(B, K * V), K)
    return top, idx // V, idx % V


def _advance(tok, parent, act, finished, n_sampled, last, penult, last_ts, cfg: RuleConfig):
    """The rule state of the K new hypotheses: each follows its parent's,
    then takes its token where it is active and not finished. act (B, 1)
    freezes the rows of inactive pool slots. Returns (finished, n_sampled,
    last, penult, last_ts)."""
    def g(a):
        return a.gather(1, parent)

    was_fin = g(finished)
    newly = act & ~was_fin & (tok == cfg.eot)
    upd = act & ~was_fin & ~newly
    last_prev = g(last)
    return (torch.where(act, was_fin | newly, finished),
            g(n_sampled) + upd.long(),
            torch.where(upd, tok, last_prev),
            torch.where(upd, last_prev, g(penult)),
            torch.where(upd & (tok >= cfg.ts_begin), tok, g(last_ts)))


def _follow(parent: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x (B, K, ...) reordered to the new hypotheses' parents."""
    idx = parent.view(*parent.shape, *([1] * (x.dim() - 2))).expand_as(x)
    return x.gather(1, idx)


def _beam_attention(q, pk, pv, pks, pvs, anc, valid, k_new, v_new, rk=None, rv=None,
                    anc_r=None, valid_r=None) -> torch.Tensor:
    """Ancestor-indirected self-attention for one layer, one softmax over
    the pages' columns, (when given) the ring's rows and each hypothesis'
    own key.

    q (B, H, K, Dh): the K hypotheses of each batch row as query rows;
    pk/pv (B, H, K', T, Dh) the batch row's K' page rows, int8 with per-token
    f32 scales pks/pvs (B, H, K', T) or in the compute dtype (scales None);
    anc (B, K, T) the page row each hypothesis reads at each column, valid
    (B, T) the columns it may attend to; k_new/v_new (B, H, K, Dh) each
    hypothesis' own key and value of this step; rk/rv (B, H, K', W, Dh),
    anc_r and valid_r the same for the ring. Logits are f32 against all K'
    rows, the ancestor's picked, a key scale multiplying its logit; the
    softmax weights of the pages and the ring, times the value scale, are
    rounded to q's dtype and contracted with the ancestor's values in f32,
    and the own weight multiplies its value unrounded (the JAX beam block's
    rounding). Returns (B, H, K, Dh) in q's dtype."""
    B, H, K, Dh = q.shape
    scale = Dh ** -0.5
    qf = q.float()
    groups, parts = [], []
    for keys, values, ks, vs, a, ok in ((pk, pv, pks, pvs, anc, valid),
                                        (rk, rv, None, None, anc_r, valid_r)):
        if keys is None:
            continue
        Kp, T = keys.shape[2], keys.shape[3]
        logits = torch.matmul(qf, keys.reshape(B, H, Kp * T, Dh).float().transpose(-1, -2))
        logits = (logits * scale).view(B, H, K, Kp, T)
        if ks is not None:
            logits = logits * ks[:, :, None]
        logits = logits.gather(3, a[:, None, :, None, :].expand(B, H, K, 1, T))[:, :, :, 0]
        groups.append(logits.masked_fill(~ok[:, None, None, :], NEG_INF))
        sel = ((a[:, :, None, :] == torch.arange(Kp, device=a.device)[None, None, :, None])
               & ok[:, None, None, :])                              # (B, K, K', T)
        parts.append((values, vs, sel, T))
    groups.append((qf * k_new.float()).sum(-1, keepdim=True) * scale)
    w = torch.softmax(torch.cat(groups, dim=-1), dim=-1)
    out = None
    off = 0
    for values, vs, sel, T in parts:
        Kp = values.shape[2]
        w_sel = w[..., off:off + T][:, :, :, None, :] * sel[:, None]   # (B, H, K, K', T)
        if vs is not None:
            w_sel = w_sel * vs[:, :, None]
        o = torch.matmul(w_sel.to(q.dtype).float().reshape(B, H, K, Kp * T),
                         values.reshape(B, H, Kp * T, Dh).float())
        out = o if out is None else out + o
        off += T
    return (out + w[..., off:] * v_new.float()).to(q.dtype)


@torch.no_grad()
def beam_forward(model: W.Whisper, tok: torch.Tensor, pos: torch.Tensor, pages: W.KVCache,
                 anc: torch.Tensor, valid: torch.Tensor, col: int | None = None,
                 ring_n: int | None = None, anc_r: torch.Tensor | None = None,
                 valid_r: torch.Tensor | None = None) -> torch.Tensor:
    """One decoder step of the B·K hypothesis rows: tok/pos (B, K). Each
    row's K/V go to its own page row at the window's column `col`, or to
    ring row `ring_n` (the pool); anc/valid (and anc_r/valid_r for the
    ring) leave out the row being written, which enters the softmax as each
    hypothesis' own key (`_beam_attention`). Cross-attention reads
    the batch row's cross-KV once for its K hypotheses. Returns f32 logits
    (B·K, V)."""
    dec = model.decoder
    B, K = tok.shape
    H = model.n_text_head
    x = (dec.tok_emb[tok.reshape(-1)] + dec.pos[pos.reshape(-1)])[:, None, :]

    def to_rows(t):     # (B·K, H, 1, Dh) -> (B, H, K, Dh)
        return t[:, :, 0].reshape(B, K, H, -1).transpose(1, 2)

    def from_rows(t):   # (B, H, K, Dh) -> (B·K, H, 1, Dh)
        return t.transpose(1, 2).reshape(B * K, H, 1, -1)

    cross = W._cross_attention(pages)
    ring = pages.ring_k is not None

    def self_attn(i, q, k, v):
        if ring:
            pages.ring_k[i][:, :, :, ring_n] = to_rows(k)
            pages.ring_v[i][:, :, :, ring_n] = to_rows(v)
        else:
            pages.self_k[i][:, :, :, col] = to_rows(k)
            pages.self_v[i][:, :, :, col] = to_rows(v)
        ks = None if pages.self_ks is None else pages.self_ks[i]
        vs = None if pages.self_vs is None else pages.self_vs[i]
        out = _beam_attention(to_rows(q), pages.self_k[i], pages.self_v[i], ks, vs, anc, valid,
                              to_rows(k), to_rows(v), pages.ring_k[i] if ring else None,
                              pages.ring_v[i] if ring else None, anc_r, valid_r)
        return from_rows(out)

    x = W._decoder_blocks(model, x, self_attn, lambda i, cq: from_rows(cross(i, to_rows(cq))))
    return W._decoder_tail(model, x)[:, 0, :]


def _initial_scores(n: int, K: int, device) -> torch.Tensor:
    """Hypothesis 0 live at 0, the others at -1e30: the first step's top-k
    draws all K hypotheses from the first."""
    own = torch.arange(K, device=device)
    return torch.where(own == 0, 0.0, NEG_INF).expand(n, K).contiguous()


@torch.no_grad()
def beam_decode(model: W.Whisper, cfg: RuleConfig, suppress_mask: torch.Tensor,
                enc_out: torch.Tensor, prompt: torch.Tensor, beam_size: int = 5,
                prompt_len: torch.Tensor | None = None, sot_index: torch.Tensor | int = 0,
                cross_kv_int8: bool = False) -> dict:
    """Beam-search one batch of windows.

    enc_out (B, A, d) f32 encoder states; prompt (B, P) right-padded, with
    prompt_len (B,) the true lengths and sot_index (B,) the position of
    <|sot|> for the no-speech probability, the contract of
    `decode.transcribe_window`. cross_kv_int8: per-channel int8 cross-KV.
    The prompt is prefilled once per window and its KV copied to the K page
    rows. Returns tokens (B, max_new), n_sampled (B,), sum_logprob (B,),
    avg_logprob (B,) and no_speech_prob (B,) of each window's best
    hypothesis."""
    B, P = prompt.shape
    K = beam_size
    L = cfg.max_new_tokens
    dev = prompt.device
    if prompt_len is None:
        prompt_len = torch.full((B,), P, dtype=torch.long, device=dev)
    cross = W.compute_cross_kv(model, enc_out, int8=cross_kv_int8)
    pre = W.new_cache(model, cross, P)
    prefill_logits = W.decode_prefill(model, prompt, pre)
    rows = torch.arange(B, device=dev)
    sot_idx = torch.as_tensor(sot_index, dtype=torch.long, device=dev).expand(B)
    no_speech_prob = torch.softmax(prefill_logits[rows, sot_idx].float(), dim=-1)[:, cfg.no_speech]
    T = P + L
    pages = W.new_cache(model, cross, T, beams=K)
    pages.self_k[..., :P, :] = pre.self_k[:, :, :, None]
    pages.self_v[..., :P, :] = pre.self_v[:, :, :, None]
    del pre
    logits = prefill_logits[rows, prompt_len - 1].repeat_interleave(K, dim=0)
    own = torch.arange(K, device=dev)
    anc = own[None, :, None].expand(B, K, T).contiguous()
    tokens = torch.full((B, K, L), cfg.eot, dtype=torch.long, device=dev)
    scores = _initial_scores(B, K, dev)
    finished = torch.zeros((B, K), dtype=torch.bool, device=dev)
    n_sampled, last, penult, last_ts = (torch.zeros((B, K), dtype=torch.long, device=dev)
                                        for _ in range(4))
    act = torch.ones((B, 1), dtype=torch.bool, device=dev)
    t_idx = torch.arange(T, device=dev)[None, :]
    for step in range(L):
        scores, parent, tok = beam_select(logits, scores, finished, n_sampled, last, penult,
                                          last_ts, cfg, suppress_mask)
        tokens = _follow(parent, tokens)
        tokens[:, :, step] = tok
        finished, n_sampled, last, penult, last_ts = _advance(
            tok, parent, act, finished, n_sampled, last, penult, last_ts, cfg)
        if step + 1 == L or bool(finished.all()):
            break
        col = P + step
        anc = _follow(parent, anc)
        anc[:, :, col] = own
        valid = (t_idx < prompt_len[:, None]) | ((t_idx >= P) & (t_idx < col))
        pos = (prompt_len + step)[:, None].expand(B, K)
        logits = beam_forward(model, tok, pos, pages, anc, valid, col=col)
    avg = scores / (n_sampled + 1).float()
    best = avg.argmax(dim=1)
    return dict(tokens=tokens[rows, best], n_sampled=n_sampled[rows, best],
                sum_logprob=scores[rows, best], avg_logprob=avg[rows, best],
                no_speech_prob=no_speech_prob)


@torch.no_grad()
def transcribe_window_beam(model: W.Whisper, cfg: RuleConfig, suppress_mask: torch.Tensor,
                           mel: torch.Tensor, prompt: torch.Tensor, beam_size: int = 5,
                           n_audio_ctx: int | None = None,
                           prompt_len: torch.Tensor | None = None,
                           sot_index: torch.Tensor | int = 0,
                           cross_kv_int8: bool = False) -> dict:
    """Beam-search counterpart of `decode.transcribe_window`: encode the
    windows (the flash kernel on the card), then `beam_decode`."""
    enc = W.encode(model, mel, n_ctx_out=n_audio_ctx)
    return beam_decode(model, cfg, suppress_mask, enc, prompt, beam_size,
                       prompt_len=prompt_len, sot_index=sot_index, cross_kv_int8=cross_kv_int8)


# ---------------------------------------------------------------------------
# the beam slot pool's device state and step
# ---------------------------------------------------------------------------

@dataclass
class BeamPoolState:
    """Device state of a beam pool of S slots of K hypotheses: the pages
    (`W.new_cache` with K page rows a slot and a ring), the ancestor tables of the pages and the
    ring (S, K, T) and (S, K, W), and per hypothesis the tokens (S, K,
    max_new), the logits the next step selects from (S·K, V), the
    cumulative log-probability and the rule state (S, K); per slot the
    active flag, the no-speech probability, the true and padded prompt
    lengths, fcol (the column of the slot's next flushed token), born (the
    ring row of its first token in the current chunk) and nstep (steps
    since admission)."""

    pages: W.KVCache
    anc: torch.Tensor
    anc_ring: torch.Tensor
    tokens: torch.Tensor
    last_logits: torch.Tensor
    scores: torch.Tensor
    n_sampled: torch.Tensor
    last: torch.Tensor
    penult: torch.Tensor
    last_ts: torch.Tensor
    finished: torch.Tensor
    active: torch.Tensor
    ns_prob: torch.Tensor
    plen: torch.Tensor
    ppad: torch.Tensor
    fcol: torch.Tensor
    born: torch.Tensor
    nstep: torch.Tensor

    @classmethod
    def empty(cls, model: W.Whisper, n_slots: int, K: int, max_new: int, t_text: int,
              n_audio_ctx: int, eot: int, device, cross_int8: bool, self_int8: bool,
              ring_width: int) -> "BeamPoolState":
        own = torch.arange(K, device=device)

        def z(dtype, *rest):
            return torch.zeros((n_slots, *rest), dtype=dtype, device=device)

        cross = W.zero_cross(model, n_slots, n_audio_ctx, device, int8=cross_int8)
        return cls(pages=W.new_cache(model, cross, t_text, self_int8=self_int8,
                                     ring_width=ring_width, beams=K),
                   anc=own[None, :, None].expand(n_slots, K, t_text).contiguous(),
                   anc_ring=own[None, :, None].expand(n_slots, K, ring_width).contiguous(),
                   tokens=torch.full((n_slots, K, max_new), eot, dtype=torch.long,
                                     device=device),
                   last_logits=torch.zeros((n_slots * K, model.dims.n_vocab),
                                           dtype=torch.float32, device=device),
                   scores=z(torch.float32, K), n_sampled=z(torch.long, K),
                   last=z(torch.long, K), penult=z(torch.long, K), last_ts=z(torch.long, K),
                   finished=z(torch.bool, K), active=z(torch.bool),
                   ns_prob=z(torch.float32),
                   plen=torch.ones(n_slots, dtype=torch.long, device=device),
                   ppad=torch.ones(n_slots, dtype=torch.long, device=device),
                   fcol=torch.ones(n_slots, dtype=torch.long, device=device),
                   born=z(torch.long), nstep=z(torch.long))


@torch.no_grad()
def beam_pool_step(model: W.Whisper, cfg: RuleConfig, suppress_mask: torch.Tensor,
                   st: BeamPoolState, ring_n: int) -> torch.Tensor:
    """One step of every slot of the beam pool, in place on `st` (the JAX
    `BeamSlotPool._build_step` body): the joint top-k of each active slot
    (inactive slots freeze: own parents, EOT, scores kept), the hypotheses'
    rule state, tokens and ancestor tables reordered to their parents, the
    token written at the slot's step since admission, the model step (ring
    row ring_n for every row) and, when it fills the ring, the flush of the
    ring and its ancestors into each slot's own columns. A slot finishes when
    all K hypotheses have or at the max_new cap. Returns the (S,) bool of
    slots that finished at this step."""
    S, K = st.scores.shape
    max_new = st.tokens.shape[2]
    dev = st.scores.device
    act = st.active[:, None]
    top, parent, tok = beam_select(st.last_logits, st.scores, st.finished, st.n_sampled,
                                   st.last, st.penult, st.last_ts, cfg, suppress_mask)
    own = torch.arange(K, device=dev)
    parent = torch.where(act, parent, own[None, :])
    tok = torch.where(act, tok, cfg.eot)
    st.scores = torch.where(act, top, st.scores)
    st.finished, st.n_sampled, st.last, st.penult, st.last_ts = _advance(
        tok, parent, act, st.finished, st.n_sampled, st.last, st.penult, st.last_ts, cfg)
    tokens = _follow(parent, st.tokens)
    rows = torch.arange(S, device=dev)
    at = st.nstep.clamp(max=max_new - 1)
    tokens[rows, :, at] = torch.where(act, tok, tokens[rows, :, at])
    st.tokens = tokens
    st.anc = _follow(parent, st.anc)
    st.anc_ring = _follow(parent, st.anc_ring)
    st.anc_ring[:, :, ring_n] = own

    pages = st.pages
    valid, valid_r = W.ring_masks(pages, st.plen, st.ppad, st.fcol, st.born, ring_n)
    pos = (st.plen + st.nstep).clamp(max=model.dims.n_text_ctx - 1)[:, None].expand(S, K)
    st.last_logits = beam_forward(model, tok, pos, pages, st.anc, valid, ring_n=ring_n,
                                  anc_r=st.anc_ring, valid_r=valid_r)
    if ring_n == pages.ring_k.shape[-2] - 1:
        st.fcol, st.born, col, ok = W.flush_ring(pages, st.fcol, st.born)
        W._scatter_cols(st.anc, st.anc_ring, col, ok, 0, 2)
    finished = st.active & (st.finished.all(dim=1) | (st.nstep + 1 >= max_new))
    st.active = st.active & ~finished
    st.nstep = st.nstep + 1
    return finished


def best_hypothesis(st: BeamPoolState) -> tuple[torch.Tensor, ...]:
    """Per slot, the best hypothesis by total logprob / (length + 1):
    (n_sampled (S,), sum_logprob (S,), tokens (S, max_new))."""
    avg = st.scores / (st.n_sampled + 1).float()
    best = avg.argmax(dim=1)
    rows = torch.arange(best.shape[0], device=best.device)
    return st.n_sampled[rows, best], st.scores[rows, best], st.tokens[rows, best]
