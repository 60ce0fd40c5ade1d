"""The full-depth parity fixture's helpers (`speaksense_tpu_torch.tools.golden`)
at tiny dims: `pool_readings` of the port's greedy and beam servers against
the same helper on the JAX servers (float32 on the CPU, the slot tests'
bounds), `projection` against a numpy float64 reference, `pool_errors` on
planted differences, and the committed `tests/golden/large_v3_32l_f32.json`
holding what the chip smoke's ckpt phase reads from it."""

import dataclasses
import json
from pathlib import Path

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
from speaksense_tpu_torch.runtime.slots import StreamingDecodeServer
from speaksense_tpu_torch.tools import golden as G

FULL_FIXTURE = Path(__file__).parent / "golden" / "large_v3_32l_f32.json"
DIMS = JW.WhisperDims(n_mels=80, n_vocab=51865, n_audio_ctx=1500, n_audio_state=64,
                      n_audio_head=4, n_audio_layer=2, n_text_ctx=448, n_text_state=64,
                      n_text_head=4, n_text_layer=2)
# the slot tests' bounds (tests/test_torch_slots.py, test_torch_beam_slots.py)
LOGPROB_ATOL = 1e-4
NO_SPEECH_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU ops: the parallel test run
    puts several workers on the cores, and torch's thread pool then spins
    against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines():
    params = JW.init_params_np(DIMS, seed=0)
    cfg = EngineConfig(compute_dtype="float32")
    return (JEngine(params, DIMS, JTokenizer.synthetic(DIMS.n_vocab), config=cfg),
            TEngine.from_jax_params(params, TW.WhisperDims(**dataclasses.asdict(DIMS)),
                                    Tokenizer.synthetic(DIMS.n_vocab), config=cfg,
                                    device="cpu"))


@pytest.mark.parametrize("spec", [
    dict(n_slots=2, t_mel=512, max_new=12),
    dict(n_slots=2, t_mel=512, max_new=12, beam_size=3, int8_kv=True, self_int8=True),
], ids=["greedy", "beam_int8"])
def test_pool_readings_match_jax(engines, spec):
    """The same seeded s16 chunks with the denoise through the JAX server
    (one step per dispatch, as the fixture's) and the port's: tokens and
    n_sampled equal per chunk, the mean log-probability within 1e-4 and
    the no-speech probability within 1e-6."""
    jeng, teng = engines
    chunks = [G.seeded_chunk(5.0, s) for s in (31, 32, 33)]
    assert all(c.dtype == np.int16 and c.size == 80000 for c in chunks)
    js = JServer(jeng, steps_per_dispatch=1, **spec)
    ts = StreamingDecodeServer(teng, **spec)
    try:
        want, got = G.pool_readings(js, chunks), G.pool_readings(ts, chunks)
    finally:
        js.stop()
        ts.stop()
    errs = G.pool_errors(got, want)
    assert all(errs["tokens_equal"]), errs
    assert errs["avg_logprob"] <= LOGPROB_ATOL and errs["no_speech_prob"] <= NO_SPEECH_ATOL
    for r in got:
        assert r["avg_logprob"] == pytest.approx(r["sum_logprob"] / (r["n_sampled"] + 1))
        assert 0 < r["n_sampled"] <= 12 and len(r["tokens"]) == 12


def test_seeded_chunk_is_seeded_speech():
    a, b = G.seeded_chunk(5.0, 31), G.seeded_chunk(5.0, 32)
    assert np.array_equal(a, G.seeded_chunk(5.0, 31)) and not np.array_equal(a, b)
    assert 1000 < np.abs(a.astype(np.float64)).mean() < 16000


@pytest.mark.parametrize("as_tensor", [False, True])
def test_projection_matches_numpy_f64(as_tensor):
    """k unit directions, each from generator [seed, i], dotted in f64 with
    every value of x; a change to one value moves the reading."""
    x = np.random.default_rng(3).standard_normal((2, 50, 24)).astype(np.float32)
    dirs = np.stack([np.random.default_rng([5, i]).standard_normal(x.size) for i in range(4)])
    want = (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)) @ x.astype(np.float64).ravel()
    got = G.projection(torch.from_numpy(x) if as_tensor else x, seed=5, k=4)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    y = x.copy()
    y[1, 49, 23] += 1.0
    assert G.rel_l2(G.projection(y, seed=5, k=4), want) > 1e-3


def test_projection_error_estimates_the_tensors_error():
    """The projections' relative L2 estimates the whole tensor's (random
    directions): within a factor of 2 at k = 16."""
    x = np.random.default_rng(4).standard_normal((1500, 64))
    e = 1e-3 * np.random.default_rng(5).standard_normal(x.shape)
    ratio = G.rel_l2(G.projection(x + e), G.projection(x)) / G.rel_l2(x + e, x)
    assert 0.5 < ratio < 2.0, ratio


@pytest.mark.parametrize("change, equal, prefix", [
    (None, [True, True], [4, 3]),
    ("token", [False, True], [1, 3]),
    ("n_sampled", [True, False], [4, 3]),
])
def test_pool_errors(change, equal, prefix):
    want = [dict(tokens=[5, 6, 7, 8, 9], n_sampled=3, avg_logprob=-1.0, no_speech_prob=0.1),
            dict(tokens=[5, 6, 9, 0, 0], n_sampled=2, avg_logprob=-2.0, no_speech_prob=0.2)]
    got = [dict(r) for r in want]
    got[0]["avg_logprob"], got[1]["no_speech_prob"] = -1.25, 0.2005
    if change == "token":
        got[0]["tokens"] = [5, 4, 7, 8, 9]
    elif change == "n_sampled":
        got[1]["n_sampled"] = 3
    e = G.pool_errors(got, want)
    assert e["tokens_equal"] == equal and e["common_prefix"] == prefix
    assert e["avg_logprob"] == pytest.approx(0.25) and e["no_speech_prob"] == pytest.approx(5e-4)
    assert e["avg_logprob_delta"] == pytest.approx([-0.25, 0.0])


def test_full_depth_fixture_is_committed():
    """large-v3 at 32 + 32 layers, seed 0, f16, and every key the chip
    smoke's full-depth check reads, with a reading for each chunk."""
    want = json.loads(FULL_FIXTURE.read_text())
    assert want["checkpoint"]["dims"] == dataclasses.asdict(TW.MODEL_DIMS["large-v3"])
    dims = want["checkpoint"]["dims"]
    assert dims["n_audio_layer"] == dims["n_text_layer"] == 32
    assert want["checkpoint"]["seed"] == 0 and want["checkpoint"]["ftype"] == "f16"
    assert set(G.FULL_FIXTURE_KEYS) <= set(want), set(G.FULL_FIXTURE_KEYS) - set(want)
    assert len(want["enc_projection"]) == want["projection"]["k"] == G.PROJECTION_K
    assert want["projection"]["seed"] == G.PROJECTION_SEED
    assert len(want["tokens"]) == want["n_tokens"] == 24 and len(want["top20_ids"]) == 20
    for pool in ("greedy", "beam"):
        assert len(want[pool]) == len(want["chunks"]["seeds"]) == 3
        assert want["servers"][pool]["max_new"] == 24
        for r in want[pool]:
            assert set(r) == {"tokens", "n_sampled", "sum_logprob", "avg_logprob",
                              "no_speech_prob"} and len(r["tokens"]) == 24
    assert want["servers"]["beam"]["beam_size"] == 5
    assert want["servers"]["beam"]["int8_kv"] and want["servers"]["beam"]["self_int8"]
    assert not (want["servers"]["greedy"]["int8_kv"] or want["servers"]["greedy"]["self_int8"])
    assert want["jax_run"]["seconds"] > 0 and want["jax_run"]["peak_rss_gib"] > 0
