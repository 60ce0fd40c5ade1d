"""The port's beam slot pool (speaksense_tpu_torch.runtime.beam_slots) against
the JAX package on shared tiny weights on the CPU: its best hypothesis
against the JAX window beam search in float32 and in bfloat16, the pool
with int8 cross-KV and int8 self pages against the JAX beam pool stepped in
lockstep (float32: XLA:CPU cannot run the JAX beam pool in bfloat16, see
test_beam_pool_bf16_matches_jax_window_beam), slot isolation, the token
budget, and the engine's stream surface on a beam pool
(`enable_slot_serving` defaults, t = 0 only, the window-path retry ladder,
stream chunks)."""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speaksense_tpu.asr import AsrParams as JParams
from speaksense_tpu.asr.engine import WhisperEngine as JEngine
from speaksense_tpu.config import EngineConfig
from speaksense_tpu.models import decode as JD
from speaksense_tpu.models import whisper as JW
from speaksense_tpu.models.beam import beam_decode, transcribe_window_beam
from speaksense_tpu.models.tokenizer import Tokenizer as JTokenizer
from speaksense_tpu.runtime.beam_slots import BeamSlotPool as JBeamPool
from speaksense_tpu.runtime.slots import _StreamJob as JJob
from speaksense_tpu.utils.metrics import REGISTRY as JMETRICS
from speaksense_tpu_torch.asr import AsrParams
from speaksense_tpu_torch.asr.engine import WhisperEngine as TEngine
from speaksense_tpu_torch.models import whisper as TW
from speaksense_tpu_torch.models.tokenizer import Tokenizer
from speaksense_tpu_torch.runtime.beam_slots import BeamSlotPool
from speaksense_tpu_torch.runtime.slots import SlotPool, StreamingDecodeServer, _StreamJob
from speaksense_tpu_torch.utils.metrics import REGISTRY as TMETRICS
from test_torch_beam import (BF16_AVG_LOGPROB_ATOL, _bf16_params, _gelu_rounded_once,
                             _jax_bf16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU ops: the parallel test run
    puts several workers on the cores, and torch's thread pool then spins
    against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DIMS = JW.WhisperDims(n_mels=80, n_vocab=51865, n_audio_ctx=1500, n_audio_state=64,
                      n_audio_head=4, n_audio_layer=2, n_text_ctx=448, n_text_state=64,
                      n_text_head=4, n_text_layer=2)
TDIMS = TW.WhisperDims(**DIMS.__dict__)
TOK = Tokenizer.synthetic(DIMS.n_vocab)
JTOK = JTokenizer.synthetic(DIMS.n_vocab)
NEVER = dict(compute_dtype="float32", compression_ratio_thold=1e9, logprob_thold=-1e9,
             entropy_thold=-1.0)
# every candidate fails the logprob gate and none is silent
ALWAYS = dict(logprob_thold=1e9, no_speech_thold=2.0)
# f32 on both sides, summed in different orders: scores agree to a few f32
# ulps per token (1e-3 over the sum); with int8 pages a value that the two
# summation orders put on either side of an int8 rounding boundary lands
# one step apart, so the int8 comparison allows 1e-4 on the average
SUM_LOGPROB_ATOL = 1e-3
AVG_LOGPROB_ATOL = 1e-4
N = 512 * 160


@pytest.fixture(scope="module")
def np_params():
    return JW.init_params_np(DIMS, seed=0)


@pytest.fixture(scope="module")
def engines(np_params):
    cfg = EngineConfig(**NEVER)
    return (JEngine(np_params, DIMS, JTOK, config=cfg),
            TEngine.from_jax_params(np_params, TDIMS, TOK, config=cfg, device="cpu"))


def _audio(seed: int, scale: float = 0.1, n: int = N) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(n) * scale).astype(np.float32)


def _mel(jeng, seed: int, scale: float) -> np.ndarray:
    return np.asarray(jeng.compute_mel(_audio(seed, scale, 16000), pad_to=512))[0]


def test_beam_pool_matches_window_beam(engines):
    """The pool's best hypothesis is the JAX window beam search's on the
    same window (pages in the compute dtype, K = 3), as
    tests/test_beam_slots.py holds the JAX pool: tokens and n_sampled
    equal, sum_logprob within 1e-3."""
    jeng, teng = engines
    cfg = JD.RuleConfig.from_tokenizer(JTOK, max_initial_ts=jeng.config.max_initial_ts,
                                       max_new_tokens=16)
    prompt = jnp.asarray([JTOK.sot_sequence("en")], jnp.int32)
    ref = jax.jit(lambda p, m: transcribe_window_beam(
        p, DIMS, cfg, jeng._suppress[(False, False)], m, prompt, beam_size=3,
        n_audio_ctx=256))
    server = StreamingDecodeServer(teng, n_slots=2, t_mel=512, max_new=16, beam_size=3)
    try:
        assert isinstance(server.pool, BeamSlotPool) and server.pool.K == 3
        assert server.pool.state.pages.self_k.dtype == torch.float32
        for seed, scale in ((1, 0.1), (2, 0.3)):
            mel = _mel(jeng, seed, scale)
            r = server.submit(mel).result(timeout=300)
            want = {k: np.asarray(v)[0] for k, v in ref(jeng.params, jnp.asarray(mel[None])).items()}
            assert r["n_sampled"] == int(want["n_sampled"])
            np.testing.assert_array_equal(r["tokens"], want["tokens"])
            assert abs(r["sum_logprob"] - float(want["sum_logprob"])) <= SUM_LOGPROB_ATOL
            assert abs(r["no_speech_prob"] - float(want["no_speech_prob"])) <= 1e-6
    finally:
        server.stop()


@pytest.mark.parametrize("int8_kv", [False, True])
def test_beam_pool_bf16_matches_jax_window_beam(engines, np_params, monkeypatch, int8_kv):
    """The pool in bfloat16 (pages in the compute dtype, K = 3, int8
    cross-KV or not) against the JAX window beam search in bfloat16 on the
    same windows: tokens and n_sampled equal, avg_logprob within
    BF16_AVG_LOGPROB_ATOL, with the reference adjusted and run one window
    at a time from the pool's encoder states rounded to bf16, as
    tests/test_torch_beam.py states. The JAX beam pool itself fails on
    XLA:CPU in bfloat16 at every pool size (its cross-attention product,
    "Unsupported element type for DotThunk::Execute: BF16 x BF16 = F32"),
    so its int8 self pages have no bfloat16 reference here."""
    jeng, _ = engines
    teng = TEngine.from_jax_params(np_params, TDIMS, TOK, config=EngineConfig(
        **{**NEVER, "compute_dtype": "bfloat16"}), device="cpu")
    cfg = JD.RuleConfig.from_tokenizer(JTOK, max_initial_ts=jeng.config.max_initial_ts,
                                       max_new_tokens=16)
    prompt = jnp.asarray([JTOK.sot_sequence("en")], jnp.int32)
    jparams = _bf16_params(JW.fuse_qkv_weights(np_params))
    monkeypatch.setattr(jax.nn, "gelu", _gelu_rounded_once)
    server = StreamingDecodeServer(teng, n_slots=2, t_mel=512, max_new=16, beam_size=3,
                                   int8_kv=int8_kv)
    try:
        assert server.pool.state.pages.self_k.dtype == torch.bfloat16
        for seed, scale in ((1, 0.1), (2, 0.3)):
            mel = _mel(jeng, seed, scale)
            r = server.submit(mel).result(timeout=300)
            enc = TW.encode(teng.model, torch.from_numpy(mel[None].copy()), n_ctx_out=256)
            enc = jnp.asarray(enc.to(torch.bfloat16).float().numpy())
            want = _jax_bf16(lambda p, e: beam_decode(
                p, DIMS, cfg, jeng._suppress[(False, False)], e, prompt, beam_size=3,
                cross_kv_int8=int8_kv), jparams, enc)
            want = {k: np.asarray(v)[0] for k, v in want.items()}
            assert r["n_sampled"] == int(want["n_sampled"])
            np.testing.assert_array_equal(r["tokens"], want["tokens"])
            assert abs(r["avg_logprob"] - float(want["avg_logprob"])) <= BF16_AVG_LOGPROB_ATOL
            assert abs(r["no_speech_prob"] - float(want["no_speech_prob"])) <= 1e-6
    finally:
        server.stop()


@pytest.mark.parametrize("kw", [dict(int8_kv=True, self_int8=True), dict(self_int8=True)])
def test_beam_pool_matches_jax_beam_pool(engines, kw):
    """The pool with int8 self pages (flushed every 16 pool steps, the
    ancestor table flushed beside them) and int8 cross-KV against the JAX
    beam pool stepped in lockstep, one step per dispatch: two jobs admitted
    together and a third after 5 steps (mid-chunk). Every job's best
    hypothesis: tokens equal, avg_logprob within 1e-4; the no-speech
    probability to 1e-6. Some hypotheses end before the budget."""
    jeng, teng = engines
    jpool = JBeamPool(jeng, 3, 512, 24, beam_size=3, **kw)
    tpool = BeamSlotPool(teng, 3, 512, 24, beam_size=3, **kw)
    assert tpool.state.pages.self_k.dtype == torch.int8
    assert tpool.state.pages.self_ks.shape == (2, 3, 4, 3, 128)
    assert tpool.state.pages.ring_k.dtype == torch.float32
    assert tpool.state.pages.cross_k.shape[3] == 256         # once per slot, not per beam
    sot = list(TOK.sot_sequence("en"))
    inputs = [_audio(1, 0.15), _audio(2, 0.25), _audio(3, 0.4)]
    jjobs = [JJob(a, sot, is_audio=True) for a in inputs]
    tjobs = [_StreamJob(a, sot, is_audio=True) for a in inputs]
    assert jpool.admit_many(jjobs[:2]) == tpool.admit_many(tjobs[:2]) == 2
    for step in range(40):
        if step == 5:
            assert jpool.admit_many(jjobs[2:]) == tpool.admit_many(tjobs[2:]) == 1
        if not (jpool.jobs or tpool.jobs):
            break
        if jpool.jobs:
            jpool.step(retire=True, k=1)
        if tpool.jobs:
            tpool.step()
    ns = []
    for jj, tj in zip(jjobs, tjobs):
        w, g = jj.future.result(timeout=1), tj.future.result(timeout=1)
        assert g["n_sampled"] == w["n_sampled"] > 3
        np.testing.assert_array_equal(g["tokens"], np.asarray(w["tokens"]))
        assert abs(g["avg_logprob"] - w["avg_logprob"]) <= AVG_LOGPROB_ATOL
        assert abs(g["no_speech_prob"] - w["no_speech_prob"]) <= 1e-6
        assert g["tokens"][0] >= TOK.ts_begin
        ns.append(g["n_sampled"])
    assert min(ns) < 24


def test_beam_pool_slot_isolation(engines):
    """The same window gives the same best hypothesis alone and beside other
    windows, in another slot, admitted after them."""
    jeng, teng = engines
    server = StreamingDecodeServer(teng, n_slots=2, t_mel=512, max_new=12, beam_size=2)
    try:
        target = _mel(jeng, 1, 0.1)
        alone = server.submit(target).result(timeout=300)
        others = [server.submit(_mel(jeng, 5, 0.4)), server.submit(target),
                  server.submit(_mel(jeng, 6, 0.5))]
        again = others[1].result(timeout=300)
        for f in others:
            f.result(timeout=300)
        assert again["n_sampled"] == alone["n_sampled"]
        np.testing.assert_array_equal(again["tokens"], alone["tokens"])
        assert server.pool.n_active == 0 and sorted(server.pool.free) == [0, 1]
    finally:
        server.stop()


def test_beam_pool_retires_every_job_at_its_budget(engines):
    """A slot retires at the step that reaches max_new steps since its
    admission, whatever its hypotheses: after 7 steps of a budget of 8
    nothing has retired and `all_jobs_at_budget` is False; the 8th step
    retires both jobs with at most 8 tokens."""
    _, teng = engines
    pool = BeamSlotPool(teng, n_slots=2, t_mel=512, max_new=8, beam_size=3)
    sot = list(TOK.sot_sequence("en"))
    jobs = [_StreamJob(_audio(s, 0.2), sot, is_audio=True) for s in (1, 2)]
    assert pool.admit_many(list(jobs)) == 2
    for _ in range(7):
        assert pool.step() == []
        assert not pool.all_jobs_at_budget()
    assert sorted(id(j) for j in pool.step()) == sorted(id(j) for j in jobs)
    assert pool.n_active == 0 and not pool.state.active.any()
    for j in jobs:
        r = j.future.result(timeout=1)
        assert 0 < r["n_sampled"] <= 8 and np.isfinite(r["sum_logprob"])


@pytest.mark.parametrize("beam_size, self_int8, want", [
    (None, None, (BeamSlotPool, 2, True)), (1, None, (SlotPool, 1, False)),
    (3, False, (BeamSlotPool, 3, False))])
def test_enable_slot_serving_beam_defaults(np_params, beam_size, self_int8, want):
    """beam_size=None inherits config.beam_size; self_int8=None means int8
    self pages on a beam pool and not on a greedy one; int8 cross-KV
    follows config.cross_kv_int8. A beam pool refuses t > 0."""
    cfg = EngineConfig(**NEVER, beam_size=2, cross_kv_int8=True)
    teng = TEngine.from_jax_params(np_params, TDIMS, TOK, config=cfg, device="cpu")
    teng.enable_slot_serving(n_slots=2, max_new=6, beam_size=beam_size, self_int8=self_int8)
    try:
        pool = teng._slot_server.pool
        kind, K, int8_pages = want
        assert type(pool) is kind and getattr(pool, "K", 1) == K
        assert pool.self_int8 == int8_pages and pool.int8_kv
        assert (pool.state.pages.self_k.dtype == torch.int8) == int8_pages
        if K > 1:
            with pytest.raises(ValueError, match="t=0 only"):
                teng._slot_server.submit_audio(_audio(1), temperature=0.2)
        r = teng._slot_server.submit_audio(_audio(1)).result(timeout=300)
        assert 0 < r["n_sampled"] <= 6
    finally:
        teng.disable_slot_serving()


@contextlib.contextmanager
def _beam_serving(np_params, **cfg):
    config = EngineConfig(**{**NEVER, "beam_size": 2, "best_of": 2, **cfg})
    jeng = JEngine(np_params, DIMS, JTOK, config=config)
    teng = TEngine.from_jax_params(np_params, TDIMS, TOK, config=dataclasses.replace(config),
                                   device="cpu")
    for eng in (jeng, teng):
        eng.enable_slot_serving(n_slots=2, t_mel=512, max_new=12)
    try:
        yield jeng, teng
    finally:
        for eng in (jeng, teng):
            eng.disable_slot_serving()


def _counter(metrics, name: str) -> float:
    return metrics.snapshot()["counters"].get(name, 0.0)


def test_beam_retry_ladder_structure_matches_jax(np_params):
    """Trip-everything thresholds on a beam pool: on both packages a chunk's
    first retry goes through the window path (decode_windows at t = 0.2,
    beam_size=1, the pool's token budget), which climbs the rest of the
    ladder with best_of rows itself; the chunk keeps that t = 1.0 window
    candidate as it came back (quality features included), and the
    counters move alike. Sampled tokens differ (two RNGs), so only the
    structure is compared."""
    audio = _audio(7, 0.2, 16000 * 3)
    seen = []
    with _beam_serving(np_params, **ALWAYS) as (jeng, teng):
        for eng, metrics, params in ((jeng, JMETRICS, JParams), (teng, TMETRICS, AsrParams)):
            calls, finals = [], []
            real_dw, real_gate = eng.decode_windows, eng._pool_quality_gate

            def spy(mel, language, *a, real=real_dw, calls=calls, **kw):
                calls.append((tuple(kw.get("temperatures") or ()), kw.get("beam_size"),
                              kw.get("max_new_tokens")))
                return real(mel, language, *a, **kw)

            def gate(raw, retry, real=real_gate, finals=finals):
                cand = real(raw, retry)
                finals.append((cand["temperature"], "compression_ratio" in cand))
                return cand

            eng.decode_windows, eng._pool_quality_gate = spy, gate
            b_pool = _counter(metrics, "asr_pool_fallback_retries_total")
            b_all = _counter(metrics, "asr_fallback_retries_total")
            try:
                res = eng.transcribe_with_state(eng.create_state(), audio,
                                                params(language="en", stream_mode=True))
            finally:
                del eng.decode_windows, eng._pool_quality_gate
            seen.append((calls, _counter(metrics, "asr_pool_fallback_retries_total") - b_pool,
                         _counter(metrics, "asr_fallback_retries_total") - b_all, finals,
                         res.language))
    assert seen[0] == seen[1]
    calls, pool_retries, all_retries, finals, lang = seen[1]
    assert calls == [((0.2,), 1, 12)]
    assert pool_retries == 1.0 and all_retries == 5.0
    assert finals == [(1.0, True)] and lang == "en"


def test_stream_chunks_ride_the_beam_pool_like_jax(np_params):
    """With config.beam_size = 2 the engine's stream chunks decode through
    the beam pool (int8 self pages by default), sequentially and pipelined
    (`submit_stream_chunk`), with the JAX engine's text and token counts."""
    with _beam_serving(np_params) as (jeng, teng):
        assert isinstance(teng._slot_server.pool, BeamSlotPool)
        assert teng._slot_server.pool.self_int8
        audio = _audio(8, 0.1, 16000 * 3)
        out = []
        for eng, params in ((jeng, JParams), (teng, AsrParams)):
            state = eng.create_state()
            p = params(language="en", stream_mode=True)
            first = eng.transcribe_with_state(state, audio, p)
            second = eng.submit_stream_chunk(state, audio, p).settle()
            out.append([(r.full_text, r.n_tokens, len(r.segments)) for r in (first, second)])
        assert out[0] == out[1]
        assert teng._slot_server.pool.step_calls > 0
