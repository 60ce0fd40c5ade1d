"""Beam slot pool: token-level continuous batching at beam width K, the
counterpart of `speaksense_tpu/runtime/beam_slots.py` (BASELINE config 4:
64 concurrent streams, paged KV cache, beam = 5).

The host side is the greedy pool's (`SlotPool`: admission batching, job
bookkeeping, retirement of the slots that finished at a step, recycling);
the device side is `models/beam.py`'s `BeamPoolState` and `beam_pool_step`:

- self-KV pages (L, S, H, K, t_text, Dh), K page rows per slot, int8 with
  per-token scales by default (`enable_slot_serving` turns them on for beam
  pools), behind a ring of RING_WIDTH rows in the compute dtype that the
  pool flushes every RING_WIDTH steps, as the greedy pool's int8 pages;
- an ancestor table (S, K, t_text) instead of moving KV when the
  hypotheses are reordered;
- cross-KV once per slot (L, S, H, A, Dh), shared by its K hypotheses;
- per slot a joint top-k over K x V each step; finished hypotheses freeze;
  a slot retires when all K have finished or at the token budget, and
  reports its best hypothesis (total logprob / (length + 1)) in the greedy
  pool's result layout.

Beam pools decode at t = 0 only: the server refuses t > 0 submissions, and
the engine's fallback retries of a beam pool's chunk go through the window
path (`WhisperEngine._pool_retry_factory`).
"""

from __future__ import annotations

import torch

from speaksense_tpu_torch.models import beam as BM
from speaksense_tpu_torch.models import whisper as W
from speaksense_tpu_torch.runtime.slots import SlotPool


class BeamSlotPool(SlotPool):
    """SlotPool with K beam hypotheses per slot; the host API is unchanged."""

    def __init__(self, engine, n_slots: int, t_mel: int, max_new: int, beam_size: int = 5,
                 **kw):
        self.K = int(beam_size)
        if self.K < 2:
            raise ValueError("a beam pool needs beam_size >= 2; use SlotPool for greedy serving")
        super().__init__(engine, n_slots, t_mel, max_new, **kw)

    def _empty_state(self) -> BM.BeamPoolState:
        return BM.BeamPoolState.empty(self.model, self.R, self.K, self.max_new, self.t_text,
                                      self.n_audio_ctx, self.cfg.eot, self.device,
                                      cross_int8=self.int8_kv, self_int8=self.self_int8,
                                      ring_width=self.RING_WIDTH)

    def _admit_rows(self, enc: torch.Tensor, prompts: torch.Tensor, slots: torch.Tensor,
                    plen: torch.Tensor, sot: torch.Tensor, temps: torch.Tensor,
                    born: int) -> None:
        st = self.state
        K = self.K
        P = prompts.shape[1]
        rows = torch.arange(len(slots), device=prompts.device)
        logits = W.prefill_into_pool(self.model, enc, prompts, st.pages, slots)
        st.last_logits.view(self.R, K, -1)[slots] = logits[rows, plen - 1][:, None, :]
        st.ns_prob[slots] = torch.softmax(logits[rows, sot], dim=-1)[:, self.cfg.no_speech]
        own = torch.arange(K, device=prompts.device)
        st.anc[slots] = own[:, None]
        st.anc_ring[slots] = own[:, None]
        st.tokens[slots] = self.cfg.eot
        st.scores[slots] = BM._initial_scores(len(slots), K, prompts.device)
        for t in (st.n_sampled, st.last, st.penult, st.last_ts, st.finished, st.nstep):
            t[slots] = 0
        st.plen[slots] = plen
        st.ppad[slots] = P
        st.fcol[slots] = P
        st.born[slots] = born
        st.active[slots] = True

    def _device_step(self, hot: bool, ring_n: int) -> torch.Tensor:
        """One pool-wide beam step (t = 0 only: `hot` is never set)."""
        return BM.beam_pool_step(self.model, self.cfg, self.suppress, self.state, ring_n)

    def _meta(self, finished: torch.Tensor) -> list[torch.Tensor]:
        n_sampled, sum_lp, tokens = BM.best_hypothesis(self.state)
        return [finished.int()[:, None], n_sampled.int()[:, None],
                sum_lp.view(torch.int32)[:, None], self.state.ns_prob.view(torch.int32)[:, None],
                tokens.int()]
