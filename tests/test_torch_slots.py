"""The port's slot pool (speaksense_tpu_torch.runtime.slots) against the JAX
package's `StreamingDecodeServer` on shared tiny weights (float32 on the
CPU, JAX on its own CPU programs as tests/test_slots.py runs them), and the
pool's mechanics: slot isolation, admission mid-decode, recycling, failure
handling, the int8 and beam options, and the option that is not ported."""

import time

import numpy as np
import pytest
import torch

from speaksense_tpu.asr.engine import WhisperEngine as JEngine
from speaksense_tpu.config import EngineConfig
from speaksense_tpu.models import whisper as JW
from speaksense_tpu.models.tokenizer import Tokenizer as JTokenizer
from speaksense_tpu.runtime.slots import StreamingDecodeServer as JServer
from speaksense_tpu_torch.asr.engine import WhisperEngine as TEngine
from speaksense_tpu_torch.models import whisper as TW
from speaksense_tpu_torch.models.tokenizer import Tokenizer
from speaksense_tpu_torch.runtime.slots import SlotPool, StreamingDecodeServer, _StreamJob

DIMS = JW.WhisperDims(n_mels=80, n_vocab=51865, n_audio_ctx=1500, n_audio_state=64,
                      n_audio_head=4, n_audio_layer=2, n_text_ctx=448, n_text_state=64,
                      n_text_head=4, n_text_layer=2)
TDIMS = TW.WhisperDims(**DIMS.__dict__)
# quality ladder neutralized: every chunk is one greedy pool job
NEVER = dict(compute_dtype="float32", compression_ratio_thold=1e9, logprob_thold=-1e9,
             entropy_thold=-1.0)
# f32 on both sides, summed in different orders: per-token log-probs agree
# to a few f32 ulps, so their mean over a dozen tokens to 1e-4 (measured
# 0.0), and the no-speech softmax entry to 1e-6 (measured 7e-12)
LOGPROB_ATOL = 1e-4
NO_SPEECH_ATOL = 1e-6
N = 512 * 160                       # samples in the pool's 512-frame bucket


@pytest.fixture(scope="module")
def np_params():
    return JW.init_params_np(DIMS, seed=0)


@pytest.fixture(scope="module")
def teng(np_params):
    return TEngine.from_jax_params(np_params, TDIMS, Tokenizer.synthetic(DIMS.n_vocab),
                                   config=EngineConfig(**NEVER), device="cpu")


@pytest.fixture(scope="module")
def jeng(np_params):
    return JEngine(np_params, DIMS, JTokenizer.synthetic(DIMS.n_vocab),
                   config=EngineConfig(**NEVER))


@pytest.fixture(scope="module")
def servers(jeng, teng):
    js = JServer(jeng, n_slots=2, t_mel=512, max_new=12)
    ts = StreamingDecodeServer(teng, n_slots=2, t_mel=512, max_new=12)
    yield js, ts
    js.stop()
    ts.stop()


def _audio(seed: int, scale: float = 0.1, n: int = 16000 * 3) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(n) * scale).astype(np.float32)


def _pcm(seed: int) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(N) * 3000).astype(np.int16)


def _assert_same(want: dict, got: dict):
    assert got["n_sampled"] == want["n_sampled"]
    np.testing.assert_array_equal(np.asarray(got["tokens"]), np.asarray(want["tokens"]))
    assert abs(got["avg_logprob"] - want["avg_logprob"]) <= LOGPROB_ATOL
    assert abs(got["no_speech_prob"] - want["no_speech_prob"]) <= NO_SPEECH_ATOL
    assert got["avg_logprob"] == pytest.approx(got["sum_logprob"] / (got["n_sampled"] + 1))


@pytest.mark.parametrize("kind", ["mel", "f32", "s16", "s16_denoise", "conditioned"])
def test_pool_matches_jax_pool(jeng, servers, kind):
    js, ts = servers
    if kind == "mel":
        mels = [np.asarray(jeng.compute_mel(_audio(s), pad_to=512))[0] for s in (1, 2, 3)]
        want = [js.submit(m) for m in mels]
        got = [ts.submit(m) for m in mels]
    elif kind == "conditioned":
        # the 16-token pool keeps the newest context tokens that fit
        ctx = [100 + i for i in range(40)]
        want = [js.submit_audio(_audio(s), context=ctx) for s in (1, 2)]
        got = [ts.submit_audio(_audio(s), context=ctx) for s in (1, 2)]
    else:
        inputs = [_audio(s, 0.05 + 0.1 * s) if kind == "f32" else _pcm(s) for s in (1, 2, 3)]
        denoise = kind == "s16_denoise"
        want = [js.submit_audio(a, denoise=denoise) for a in inputs]
        got = [ts.submit_audio(a, denoise=denoise) for a in inputs]
    for w, g in zip(want, got):
        _assert_same(w.result(timeout=300), g.result(timeout=300))


@pytest.mark.parametrize("denoise", [False, True])
def test_submit_audio_s16_equals_f32(servers, denoise):
    _, ts = servers
    pcm = _pcm(5)
    r16 = ts.submit_audio(pcm, denoise=denoise).result(timeout=300)
    r32 = ts.submit_audio(pcm.astype(np.float32) / 32767.0, denoise=denoise).result(timeout=300)
    assert r16["n_sampled"] == r32["n_sampled"]
    np.testing.assert_array_equal(r16["tokens"], r32["tokens"])
    assert r16["sum_logprob"] == pytest.approx(r32["sum_logprob"], abs=1e-5)


def test_conditioned_prompt_matches_jax_pool(jeng, teng):
    """A max_prompt=64 pool carries previous-text conditioning in its
    prompt (the 64-wide prompt bucket) with the JAX pool's tokens."""
    js = JServer(jeng, n_slots=2, t_mel=512, max_new=12, max_prompt=64)
    ts = StreamingDecodeServer(teng, n_slots=2, t_mel=512, max_new=12, max_prompt=64)
    try:
        assert ts.pool.t_text == 128 >= 64 + 12
        ctx = [100 + i for i in range(40)]
        for a in (_audio(1), _audio(4, 0.3)):
            _assert_same(js.submit_audio(a, context=ctx).result(timeout=300),
                         ts.submit_audio(a, context=ctx).result(timeout=300))
        prompt, sot_index = ts._build_prompt("en", "transcribe", ctx)
        assert len(prompt) <= 64 and prompt[0] == teng.tokenizer.sot_prev
        assert prompt[sot_index] == teng.tokenizer.sot
    finally:
        js.stop()
        ts.stop()


def _job(teng, seed: int, scale: float = 0.1) -> _StreamJob:
    return _StreamJob(_audio(seed, scale, N), list(teng.tokenizer.sot_sequence("en")),
                      is_audio=True)


def _run(pool: SlotPool, max_steps: int = 200) -> None:
    for _ in range(max_steps):
        if not pool.jobs:
            return
        pool.step()
        assert not pool.all_jobs_at_budget()   # nothing outlives its budget
    raise AssertionError("pool did not drain")


def _alone(teng, seed: int, scale: float = 0.1, max_new: int = 10) -> dict:
    pool = SlotPool(teng, n_slots=1, t_mel=512, max_new=max_new)
    job = _job(teng, seed, scale)
    assert pool.admit_many([job]) == 1
    _run(pool)
    return job.future.result()


def _same_tokens(a: dict, b: dict):
    assert a["n_sampled"] == b["n_sampled"]
    np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_slot_isolation_and_admission_mid_decode(teng):
    """The same window decodes to the same tokens whichever slot it lands
    in, whatever shares the pool, and when it is admitted while another
    slot is mid-decode (or joins one that is)."""
    ref_a, ref_b = _alone(teng, 1), _alone(teng, 2, 0.3)
    pool = SlotPool(teng, n_slots=3, t_mel=512, max_new=10)
    a, filler = _job(teng, 1), _job(teng, 9, 0.5)
    assert pool.admit_many([filler, a]) == 2
    for _ in range(4):
        pool.step()
    b = _job(teng, 2, 0.3)
    assert pool.admit_many([b]) == 1          # joins mid-decode
    assert len({a.slot, b.slot, filler.slot}) == 3
    assert pool.n_active == 3
    _run(pool)
    _same_tokens(a.future.result(), ref_a)
    _same_tokens(b.future.result(), ref_b)
    # admission batching and occupancy telemetry
    assert (pool.admit_calls, pool.admit_rows) == (2, 3)
    assert pool.step_calls == pool.total_steps >= 10
    assert pool.occupancy_sum >= 3 * 4


def test_recycled_slot_reports_its_new_occupant(teng):
    """A one-slot pool serves more windows than slots: each recycled slot
    reports its own occupant's values, never the previous one's."""
    refs = [_alone(teng, s, 0.05 + 0.1 * s) for s in (1, 2, 3)]
    server = StreamingDecodeServer(teng, n_slots=1, t_mel=512, max_new=10)
    try:
        futs = [server.submit_audio(_audio(s, 0.05 + 0.1 * s, N)) for s in (1, 2, 3)]
        for f, ref in zip(futs, refs):
            _same_tokens(f.result(timeout=300), ref)
        assert server.pool.free == [0] and server.pool.n_active == 0
        assert server.pool.admit_rows == 3
    finally:
        server.stop()


def test_inactive_rows_stay_finite(teng):
    pool = SlotPool(teng, n_slots=4, t_mel=512, max_new=6)
    job = _job(teng, 1)
    pool.admit_many([job])
    _run(pool)
    st = pool.state
    assert torch.isfinite(st.last_logits).all() and torch.isfinite(st.sum_lp).all()
    assert not st.active.any() and (st.temp == 0).all()


def test_hot_slot_samples_while_greedy_slots_stay_exact(teng):
    """Per-slot temperature: a t > 0 slot samples with the engine's seeded
    generator while a greedy slot beside it keeps its greedy tokens; the
    retired hot slot's temperature and the host's hot mirror are cleared."""
    ref = _alone(teng, 1)
    pool = SlotPool(teng, n_slots=2, t_mel=512, max_new=10)
    greedy, hot = _job(teng, 1), _job(teng, 1)
    hot.temperature = 1.0
    pool.admit_many([greedy, hot])
    assert pool._hot == {hot.slot}
    _run(pool)
    _same_tokens(greedy.future.result(), ref)
    assert hot.future.result()["temperature"] == 1.0
    assert not pool._hot and (pool.state.temp == 0).all()


def test_admission_failure_does_not_kill_server(teng):
    server = StreamingDecodeServer(teng, n_slots=2, t_mel=512, max_new=6)
    try:
        bad = server.submit(np.zeros((7, 3), np.float32))   # wrong mel shape
        with pytest.raises(ValueError, match="shape"):
            bad.result(timeout=120)
        assert server._thread.is_alive()
        r = server.submit_audio(_audio(1)).result(timeout=300)
        assert 0 <= r["n_sampled"] <= 6
        assert sorted(server.pool.free) == [0, 1]
    finally:
        server.stop()


@pytest.mark.parametrize("where", ["queued", "waiting_for_a_slot"])
def test_stop_resolves_stranded_futures(teng, where):
    """stop() fails every future it strands: jobs still on the submit queue,
    and jobs the loop took off the queue while the pool was full."""
    if where == "queued":
        server = StreamingDecodeServer(teng, n_slots=2, t_mel=512, max_new=6)
        server._stop.set()            # freeze the loop before it can drain
        server._thread.join(timeout=10)
        futs = [server.submit_audio(_audio(1))]
    else:
        server = StreamingDecodeServer(teng, n_slots=1, t_mel=512, max_new=6)

        def step_that_never_finishes():
            time.sleep(0.01)
            return []

        # the one slot stays busy, so the other two jobs wait in the loop
        server.pool.step = step_that_never_finishes
        futs = [server.submit_audio(_audio(s)) for s in (1, 2, 3)]
        def settled():   # the first job admitted, the other two waiting
            return len(server._pending) == 2 and server.pool.n_active == 1

        deadline = time.monotonic() + 120
        while not settled() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert settled(), (len(server._pending), server.pool.n_active)
    server.stop()
    for fut in futs:
        with pytest.raises(RuntimeError, match="slot server stopped"):
            fut.result(timeout=10)
    with pytest.raises(RuntimeError, match="slot server dead"):
        server.submit_audio(_audio(1))


def test_reset_fails_registered_jobs_and_rebuilds(teng):
    pool = SlotPool(teng, n_slots=2, t_mel=512, max_new=6)
    job = _job(teng, 1)
    assert pool.admit_many([job]) == 1 and pool.n_active == 1
    pool.reset(RuntimeError("boom"))
    with pytest.raises(RuntimeError, match="boom"):
        job.future.result(timeout=10)
    assert pool.n_active == 0 and sorted(pool.free) == [0, 1]
    assert pool.state_healthy() and not pool.state.active.any()


def test_unrecoverable_failure_makes_the_server_dead(teng):
    """A step that fails and a reset that cannot rebuild (as after a sticky
    CUDA error) fail every future and make the server dead, not looping."""
    server = StreamingDecodeServer(teng, n_slots=2, t_mel=512, max_new=6)
    try:
        def boom(*a, **k):
            raise RuntimeError("step boom")

        def reset_boom(*a, **k):
            raise RuntimeError("reset boom (sticky device error)")

        server.pool.step = boom
        server.pool.reset = reset_boom
        fut = server.submit_audio(_audio(1))
        with pytest.raises(RuntimeError):
            fut.result(timeout=120)
        server._thread.join(timeout=30)
        assert not server._thread.is_alive()
        assert server._dead is not None
        with pytest.raises(RuntimeError, match="slot server dead"):
            server.submit_audio(_audio(1))
    finally:
        server.stop()


@pytest.mark.parametrize("kwargs, match", [(dict(dp=2), "multi-GPU")])
def test_options_not_ported_raise(np_params, kwargs, match):
    """The sharded pool is ported: like the JAX pool, it refuses a slot
    count whose S+1 rows do not divide dp (enable_slot_serving rounds it),
    and a server's mesh must be its engine's."""
    from speaksense_tpu_torch.parallel import make_mesh

    eng = TEngine.from_jax_params(np_params, TDIMS, Tokenizer.synthetic(DIMS.n_vocab),
                                  config=EngineConfig(**NEVER), device="cpu")
    with pytest.raises(ValueError, match="engine sharded"):
        StreamingDecodeServer(eng, n_slots=2, t_mel=512, max_new=6,
                              mesh=make_mesh(kwargs["dp"], tp=1))
    eng.shard(make_mesh(kwargs["dp"], tp=1))   # a layout mesh: tp = 1 keeps every weight
    with pytest.raises(ValueError, match=match):
        StreamingDecodeServer(eng, n_slots=2, t_mel=512, max_new=6, mesh=eng.mesh)


@pytest.mark.parametrize("kwargs, pages", [
    (dict(int8_kv=True), ("cross_k", torch.int8)),
    (dict(self_int8=True), ("self_k", torch.int8)),
    (dict(beam_size=5), ("anc", torch.long))])
def test_int8_and_beam_options_serve(jeng, teng, kwargs, pages):
    """int8 cross-KV, int8 self pages and a K = 5 beam pool (once options
    that raised) build their pools and serve a window; the int8 pools give
    the JAX pool's tokens with the same option (beam: tests of
    test_torch_beam_slots.py)."""
    ts = StreamingDecodeServer(teng, n_slots=2, t_mel=512, max_new=6, **kwargs)
    js = JServer(jeng, n_slots=2, t_mel=512, max_new=6, **kwargs)
    try:
        name, dtype = pages
        st = ts.pool.state
        assert getattr(st.pages if hasattr(st.pages, name) else st, name).dtype == dtype
        got = ts.submit_audio(_audio(1)).result(timeout=300)
        want = js.submit_audio(_audio(1)).result(timeout=300)
        assert 0 < got["n_sampled"] <= 6 and np.isfinite(got["sum_logprob"])
        if "beam_size" not in kwargs:
            _assert_same(want, got)
    finally:
        ts.stop()
        js.stop()
