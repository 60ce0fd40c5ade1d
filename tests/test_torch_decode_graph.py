"""The window decode step replayed from CUDA graphs (`models/decode.py`
`WindowSteps`, `WindowGraphs`): the capturable step body, driven eagerly
by its device step counter, gives the same bits as the eager
`decode_loop`; graphs engage only for greedy rows over int8 self pages on
one CUDA card, and every other caller counts steps but replays none.

The tests marked `cuda` hold the graph path against the eager one on the
card at large-v3-turbo's widths and skip without one. This file imports no
jax, so they run on a GPU machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda -s tests/test_torch_decode_graph.py
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from speaksense_tpu_torch.asr.engine import WhisperEngine
from speaksense_tpu_torch.config import EngineConfig
from speaksense_tpu_torch.models import decode as D
from speaksense_tpu_torch.models import whisper as W
from speaksense_tpu_torch.models.tokenizer import Tokenizer
from speaksense_tpu_torch.utils.metrics import REGISTRY

STEPS = "asr_decode_steps_total"
GRAPH_STEPS = "asr_decode_graph_steps_total"
CAPTURES = "asr_decode_graph_captures_total"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the parallel test run puts several workers on
    the cores, and torch's thread pool then spins against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _count(name: str) -> float:
    return REGISTRY.snapshot()["counters"].get(name, 0.0)


def _eot_after(monkeypatch, ends: torch.Tensor, eot: int) -> None:
    """Make row b's model step favour EOT from step ends[b] on (a step
    given as a host int or as the device counter alike), so rows finish
    at chosen steps; the rules still decide whether EOT is legal."""
    real = W.decode_step

    def step(model, token, cache, step, prompt_len, gen_base, ring_n=None):
        logits = real(model, token, cache, step, prompt_len, gen_base, ring_n=ring_n)
        logits[:, eot] += torch.where(ends <= step, 1e4, 0.0)
        return logits

    monkeypatch.setattr(W, "decode_step", step)


# ---------------------------------------------------------------------------
# CPU: the step body against the eager loop
# ---------------------------------------------------------------------------

TINY = W.WhisperDims(n_mels=80, n_vocab=51865, n_audio_ctx=1500, n_audio_state=64,
                     n_audio_head=2, n_audio_layer=1, n_text_ctx=448, n_text_state=64,
                     n_text_head=2, n_text_layer=2)
TOK = Tokenizer.synthetic(TINY.n_vocab)
B, MAX_NEW, WIDTH, FRAMES = 6, 40, 16, 32   # 39 model steps: two flushes and 7 ring rows


@pytest.fixture(scope="module")
def tiny():
    return W.init_random(TINY, torch.Generator().manual_seed(7), device="cpu",
                         dtype=torch.bfloat16)


def _batch(seed: int, ts: bool):
    """Mels, a right-padded prompt (rows 1 and 4 carry two previous-text
    tokens) and its true lengths."""
    g = torch.Generator().manual_seed(seed)
    mel = torch.randn((B, 2 * FRAMES, TINY.n_mels), generator=g)
    sot = TOK.sot_sequence("en", task="transcribe", timestamps=ts)
    rows = [[TOK.sot_prev, 17 + seed, 301] + sot if b in (1, 4) else sot for b in range(B)]
    P = max(map(len, rows))
    prompt = torch.full((B, P), TOK.eot, dtype=torch.long)
    for b, r in enumerate(rows):
        prompt[b, :len(r)] = torch.tensor(r)
    return mel, prompt, torch.tensor([len(r) for r in rows])


def _decode(model, cfg, suppress, mel, prompt, plen, steps=None) -> dict:
    """The window path's decode over int8 cross-KV and int8 self pages with
    a WIDTH-row ring: into a fresh cache and the eager loop, or into the
    entry `steps` and its step body."""
    P = prompt.shape[1]
    enc = W.encode(model, mel)
    if steps is None:
        cache = W.init_cache(model, enc, t_cap=P + MAX_NEW, cross_int8=True, self_int8=True,
                             ring_width=WIDTH)
    else:
        cache = steps.load(enc, plen, suppress)
        plen, suppress = steps.prompt_len, steps.suppress
    first = W.decode_prefill(model, prompt, cache)[torch.arange(B), plen - 1]
    return D.decode_loop(model, cfg, suppress, first, cache, plen, P, torch.zeros(B),
                         steps=steps)


@pytest.mark.parametrize("ts", [True, False], ids=["timestamps", "no_timestamps"])
def test_step_body_is_bit_equal_to_the_eager_loop(tiny, ts, monkeypatch):
    cfg = D.RuleConfig.from_tokenizer(TOK, with_timestamps=ts, max_new_tokens=MAX_NEW)
    suppress = torch.as_tensor(TOK.suppress_mask(suppress_non_speech=True))
    # rows finishing before, at and after a flush, two never; then a batch
    # in which every row ends early; then the first kind again on other
    # audio, all through one entry
    batches = [(1, [2, 9, 15, 16, 10 ** 6, 10 ** 6]), (2, [3, 5, 8, 12, 4, 6]),
               (3, [1, 10 ** 6, 20, 31, 33, 10 ** 6])]
    ends = torch.zeros(B, dtype=torch.long)
    _eot_after(monkeypatch, ends, cfg.eot)
    mel, prompt, _ = _batch(0, ts)
    steps = D.WindowSteps(tiny, cfg, B, prompt.shape[1], FRAMES, True, "cpu", WIDTH)
    seen = []
    for seed, row_ends in batches:
        ends.copy_(torch.tensor(row_ends))
        mel, prompt, plen = _batch(seed, ts)
        want = _decode(tiny, cfg, suppress, mel, prompt, plen)
        graph_steps = _count(GRAPH_STEPS)
        got = _decode(tiny, cfg, suppress, mel, prompt, plen, steps)
        assert _count(GRAPH_STEPS) == graph_steps           # the CPU replays nothing
        for name in ("tokens", "n_sampled", "sum_logprob"):
            assert torch.equal(got[name], want[name]), name
        seen.append(want["n_sampled"].tolist())
    # the batches did what they were made for: staggered ends with full
    # rows, then every row done well before the cap
    assert len(set(seen[0])) >= 4 and max(seen[0]) == MAX_NEW
    assert max(seen[1]) < 20


def test_graphs_engage_only_for_greedy_int8_pages_on_one_card(tiny):
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    cold, hot = torch.zeros(3), torch.tensor([0.0, 0.4, 0.0])
    assert D.graphs_engage(tiny, cuda, True, cold)
    assert not D.graphs_engage(tiny, cpu, True, cold)
    assert not D.graphs_engage(tiny, cuda, False, cold)       # bf16 self pages
    assert not D.graphs_engage(tiny, cuda, True, hot)         # a t > 0 row
    tiny.mesh = object()
    try:
        assert not D.graphs_engage(tiny, cuda, True, cold)    # tp / dp mesh
    finally:
        tiny.mesh = None


def test_window_graphs_keep_two_entries_and_lock_each():
    """One entry for each key, the padded prompt length part of it; the
    entries share a budget of bytes, the least recently used going first,
    and an entry larger than the budget is not made."""
    cfg = D.RuleConfig.from_tokenizer(TOK, max_new_tokens=MAX_NEW)
    model = W.Whisper(TINY, device="cpu", dtype=torch.float32)
    graphs = D.WindowGraphs()
    first = graphs.take(model, cfg, 2, 3, FRAMES, True, "cpu")
    assert first.width == D.ring_width(MAX_NEW) and not first.capture
    assert first.cache.self_k.shape[-2] == 3 + MAX_NEW
    assert graphs.take(model, cfg, 2, 3, FRAMES, True, "cpu") is None   # held
    graphs.release(first)
    assert graphs.take(model, cfg, 2, 3, FRAMES, True, "cpu") is first
    graphs.release(first)
    for P in (32, 64, 224):                      # no budget on the CPU: all kept
        graphs.release(graphs.take(model, cfg, 2, P, FRAMES, True, "cpu"))
    assert graphs.take(model, cfg, 2, 3, FRAMES, True, "cpu") is first
    graphs.release(first)
    # a budget of two entries: the least recently used goes
    two = D.WindowGraphs()
    a = two.take(model, cfg, 2, 3, FRAMES, True, "cpu")
    two.release(a)
    two.budget_bytes = 2 * a.nbytes + a.nbytes // 2
    b = two.take(model, cfg, 2, 32, FRAMES, True, "cpu")
    two.release(b)
    assert two.take(model, cfg, 2, 3, FRAMES, True, "cpu") is a        # both kept
    two.release(a)
    two.release(two.take(model, cfg, 2, 64, FRAMES, True, "cpu"))       # b goes
    assert two.take(model, cfg, 2, 3, FRAMES, True, "cpu") is a
    two.release(a)
    assert two.take(model, cfg, 2, 32, FRAMES, True, "cpu") is not b
    assert D.WindowGraphs(budget_bytes=a.nbytes - 1).take(
        model, cfg, 2, 3, FRAMES, True, "cpu") is None


NEVER = dict(compute_dtype="float32", best_of=1, compression_ratio_thold=1e9,
             logprob_thold=-1e9, entropy_thold=-1.0, cross_kv_int8=True, self_kv_int8=True)


class _Recorder:
    """A stand-in for the engine's `D.WindowGraphs`: records each `take`
    and hands out no entry, so the batch decodes eagerly."""

    def __init__(self):
        self.taken = []

    def take(self, *args):
        self.taken.append(args)
        return None


@pytest.mark.parametrize("case", ["cpu", "hot", "bf16_pages", "mesh", "greedy_int8"])
def test_other_callers_count_steps_and_replay_none(case, monkeypatch):
    """Through the engine's window path, which hands `transcribe_window` its
    graphs: every case outside the condition decodes eagerly. Past the CPU
    case, the condition is asked as for a CUDA card, so that each case is
    left out by its own term; greedy rows over int8 pages (the last case)
    ask the engine's graphs for an entry, the others never do."""
    model = W.init_random(TINY, torch.Generator().manual_seed(3), device="cpu",
                          dtype=torch.float32)
    config = dict(NEVER, self_kv_int8=case != "bf16_pages")
    engine = WhisperEngine(model, TOK, config=EngineConfig(**config), name="tiny", seed=0)
    if case == "mesh":
        model.mesh = types.SimpleNamespace(shape={"dp": 1, "tp": 1})
    engine._window_graphs = graphs = _Recorder()
    real, asked = D.graphs_engage, []

    def engage(model, device, self_kv_int8, temperature):
        asked.append(real(model, device if case == "cpu" else "cuda", self_kv_int8,
                          temperature))
        return asked[-1]

    monkeypatch.setattr(D, "graphs_engage", engage)
    rng = np.random.default_rng(5)
    mels = engine.compute_mel((0.1 * rng.standard_normal((2, 16000 * 30))).astype(np.float32))
    temps = [0.0, 0.7] if case == "hot" else None
    steps, graph_steps = _count(STEPS), _count(GRAPH_STEPS)
    # 3 prompt tokens and 130 new ones pass the 128 columns of int8 pages
    out = engine.decode_windows(mels, "en", max_new_tokens=130, temperatures=temps)
    assert len(out) == 2
    assert _count(STEPS) > steps
    assert _count(GRAPH_STEPS) == graph_steps
    engaged = case == "greedy_int8"
    assert asked == [engaged]                   # one batch, one attempt
    assert len(graphs.taken) == engaged


def _parents_loop(model, cfg, suppress_mask, first_logits, cache, prompt_len, gen_base,
                  temperature, generator=None) -> dict:
    """`decode_loop` as it was before its state moved into `LoopState`:
    the eager loop every caller outside the graphs' condition ran."""
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
    hot = bool((temperature > 0).any())
    for step in range(L):
        filtered = D.apply_logit_rules(logits, cfg, suppress_mask, n_sampled, last, penult,
                                       last_ts)
        tok = D._sample(filtered, temperature, generator, hot)
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


@pytest.mark.parametrize("pages", ["int8", "bf16"])
@pytest.mark.parametrize("hot", [False, True], ids=["greedy", "hot"])
def test_eager_loop_is_the_loop_it_replaced(tiny, pages, hot):
    """The callers outside the condition keep their results: the eager
    `decode_loop` gives the bits of the loop before this state moved into
    buffers, over int8 pages with their ring and over bf16 pages, greedy
    and with Gumbel sampling at t > 0."""
    cfg = D.RuleConfig.from_tokenizer(TOK, max_new_tokens=MAX_NEW)
    suppress = torch.as_tensor(TOK.suppress_mask(suppress_non_speech=True))
    mel, prompt, plen = _batch(4, True)
    P = prompt.shape[1]
    temps = torch.tensor([0.0, 0.5, 0.0, 1.0, 0.2, 0.0]) if hot else torch.zeros(B)
    enc = W.encode(tiny, mel)
    outs = []
    for loop in (_parents_loop, D.decode_loop):
        cache = W.init_cache(tiny, enc, t_cap=P + MAX_NEW, cross_int8=True,
                             self_int8=pages == "int8", ring_width=WIDTH)
        first = W.decode_prefill(tiny, prompt, cache)[torch.arange(B), plen - 1]
        outs.append(loop(tiny, cfg, suppress, first, cache, plen, P, temps,
                         torch.Generator().manual_seed(11)))
    for name in ("tokens", "n_sampled", "sum_logprob"):
        assert torch.equal(outs[1][name], outs[0][name]), name


# ---------------------------------------------------------------------------
# the card: graphs against the eager loop at large-v3-turbo's widths
# ---------------------------------------------------------------------------

# the widths and the 4 decoder layers of large-v3-turbo; 2 encoder layers
TURBO = dataclasses.replace(W.MODEL_DIMS["large-v3-turbo"], n_audio_layer=2)
TURBO_TOK = Tokenizer.synthetic(TURBO.n_vocab)
ROWS, TOKENS = 64, 224


@pytest.fixture(scope="module")
def turbo():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: CUDA graphs have no CPU mode")
    model = W.init_random(TURBO, torch.Generator("cuda").manual_seed(0), device="cuda",
                          dtype=torch.bfloat16)
    cfg = D.RuleConfig.from_tokenizer(TURBO_TOK, max_new_tokens=TOKENS)
    suppress = torch.as_tensor(TURBO_TOK.suppress_mask(suppress_non_speech=True), device="cuda")
    return model, cfg, suppress


def _turbo_window(turbo, seed: int, graphs, context: int = 0) -> dict:
    """One batch of ROWS windows; with `context` previous-text tokens
    before the SOT sequence, padded to a multiple of 32 as the engine
    pads them."""
    model, cfg, suppress = turbo
    g = torch.Generator("cuda").manual_seed(seed)
    mel = torch.randn((ROWS, 3000, TURBO.n_mels), generator=g, device="cuda")
    sot = TURBO_TOK.sot_sequence("en", task="transcribe", timestamps=True)
    row = ([TURBO_TOK.sot_prev] + list(range(300, 300 + context)) if context else []) + sot
    P = -(-len(row) // 32) * 32 if context else len(row)
    prompt = torch.full((ROWS, P), TURBO_TOK.eot, dtype=torch.long, device="cuda")
    prompt[:, :len(row)] = torch.tensor(row, device="cuda")
    out = D.transcribe_window(model, cfg, suppress, mel, prompt,
                              torch.zeros(ROWS, device="cuda"), sot_index=len(row) - len(sot),
                              prompt_len=torch.full((ROWS,), len(row), device="cuda"),
                              cross_kv_int8=True, self_kv_int8=True, graphs=graphs)
    return {k: v.cpu() for k, v in out.items()}


def _same(got: dict, want: dict, what: str) -> None:
    assert torch.equal(got["tokens"], want["tokens"]), what
    assert torch.equal(got["n_sampled"], want["n_sampled"]), what
    gap = (got["sum_logprob"] - want["sum_logprob"]).abs().max().item()
    print(f"{what}: tokens equal, largest |sum_logprob| difference {gap:.3e}, "
          f"n_sampled {want['n_sampled'].min().item()}-{want['n_sampled'].max().item()}")
    assert gap <= 1e-6, what


@pytest.mark.cuda
def test_graphs_match_the_eager_steps_over_two_batches(turbo):
    graphs = D.WindowGraphs()
    for seed in (1, 2):
        want = _turbo_window(turbo, seed, None)
        steps, replayed, captures = _count(STEPS), _count(GRAPH_STEPS), _count(CAPTURES)
        got = _turbo_window(turbo, seed, graphs)
        ran, replayed = _count(STEPS) - steps, _count(GRAPH_STEPS) - replayed
        _same(got, want, f"batch {seed}")
        if seed == 1:       # the first batch warms up and captures every ring row
            assert _count(CAPTURES) - captures == min(16, ran)
        else:               # the second replays every step but the last
            assert _count(CAPTURES) == captures
            assert replayed == min(ran, TOKENS - 1)


@pytest.mark.cuda
def test_a_batch_that_ends_early_then_a_full_one(turbo, monkeypatch):
    ends = torch.full((ROWS,), 40, dtype=torch.long, device="cuda")
    _eot_after(monkeypatch, ends, turbo[1].eot)
    graphs = D.WindowGraphs()
    for what, end in (("ends early", 40), ("full", 10 ** 6), ("ends early again", 57)):
        ends.fill_(end)
        want = _turbo_window(turbo, 3, None)
        got = _turbo_window(turbo, 3, graphs)
        _same(got, want, what)
        if end < TOKENS:       # favoured from the logits of step `end`: sampled one later
            assert want["n_sampled"].max().item() <= end + 1


@pytest.mark.cuda
def test_a_failed_capture_decodes_eagerly(turbo, monkeypatch):
    want = _turbo_window(turbo, 4, None)
    real = W.decode_step

    def step(model, token, *args, **kw):
        if torch.cuda.is_current_stream_capturing():
            token.sum().item()              # a host read: no capture survives it
        return real(model, token, *args, **kw)

    monkeypatch.setattr(W, "decode_step", step)
    graphs = D.WindowGraphs()
    replayed, captures = _count(GRAPH_STEPS), _count(CAPTURES)
    _same(_turbo_window(turbo, 4, graphs), want, "capture failed")
    _same(_turbo_window(turbo, 4, graphs), want, "after the failure")   # the key stays eager
    assert _count(GRAPH_STEPS) == replayed and _count(CAPTURES) == captures
    monkeypatch.undo()
    _same(_turbo_window(turbo, 4, graphs), want, "key still eager")
    assert _count(GRAPH_STEPS) == replayed


@pytest.mark.cuda
def test_prompt_buckets_keep_their_entries(turbo):
    """Prompts padded to 3, 64, 3, 64 and 224 tokens: each length captures
    its entry's graphs in its first batch and replays them after, the
    entries all kept (turbo's fit the budget many times over)."""
    graphs = D.WindowGraphs()
    for context, first in ((0, True), (60, True), (0, False), (60, False), (200, True)):
        want = _turbo_window(turbo, 5, None, context)
        captures, replayed = _count(CAPTURES), _count(GRAPH_STEPS)
        got = _turbo_window(turbo, 5, graphs, context)
        _same(got, want, f"{context} context tokens")
        assert _count(CAPTURES) - captures == (16 if first else 0)
        assert _count(GRAPH_STEPS) > replayed
    held = sum(e.nbytes for e in graphs._entries.values())
    print(f"{len(graphs._entries)} entries, {held / 1e9:.3f} GB")
    assert len(graphs._entries) == 3
