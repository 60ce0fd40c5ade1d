"""The port's word-timestamp alignment (speaksense_tpu_torch.models.align)
against the JAX package's `models/align.py` on shared tiny weights, on the
CPU: the teacher-forced cross-attention weights (f32, int8 decoder weights,
and bf16 from shared encoder states), the DTW, the alignment matrix (the
port's device version against the JAX numpy one), the word split, and
`word_timestamps` end to end."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speaksense_tpu.models import align as JA
from speaksense_tpu.models import whisper as JW
from speaksense_tpu.models.tokenizer import Tokenizer as JTokenizer
from speaksense_tpu_torch.models import align as TA
from speaksense_tpu_torch.models import whisper as TW
from speaksense_tpu_torch.models.tokenizer import Tokenizer
from test_torch_beam import _bf16_params, _gelu_rounded_once, _jax_bf16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU ops: the parallel test run
    puts several workers on the cores, and torch's thread pool then spins
    against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# four text layers, so the alignment's upper half is two of them
DIMS = JW.WhisperDims(n_mels=80, n_vocab=51865, n_audio_ctx=1500, n_audio_state=64,
                      n_audio_head=4, n_audio_layer=2, n_text_ctx=448, n_text_state=64,
                      n_text_head=4, n_text_layer=4)
TDIMS = TW.WhisperDims(**DIMS.__dict__)
# f32 on both sides, summed in different orders: softmax weights of O(1e-3)
# agree to a few f32 ulps (measured below 1e-7)
F32_ATOL = 1e-5
# bf16 weights from the same bf16-valued encoder states, the reference
# compiled without excess precision and its GELU rounded once (as
# tests/test_torch_beam.py states). The first layer's weights agree to f32
# ulps (measured worst 2.1e-6, token seeds 0-11); past it, an f32 sum taken
# in another order now and then rounds a bf16 activation the other way, and
# the later layers' weights then differ by up to 6.5e-4 (measured, token
# seeds 0-11, against weights of up to 0.19)
# the device alignment matrix standardizes in float64: against numpy's
# float64 evaluation of the same f32 weights it is off by the f32 median
# and head mean only (measured 5e-8)
MATRIX_F64_ATOL = 5e-7
BF16_FIRST_LAYER_ATOL = 1e-5
BF16_ATOL = 1.5e-3
# a vocab whose pieces start with a space every third token, so words
# span one to three tokens
VOCAB = [(b" w%d" if i % 3 == 0 else b"x%d") % i for i in range(50257)]
VOCAB += [b""] * (DIMS.n_vocab - len(VOCAB))


@pytest.fixture(scope="module")
def np_params():
    return JW.fuse_qkv_weights(JW.init_params_np(DIMS, seed=4))


@pytest.fixture(scope="module")
def enc():
    """(1, 1500, 64) encoder states, rounded to bf16 so that both packages
    see the same cross-K/V inputs in every dtype."""
    x = np.random.default_rng(11).standard_normal((1, DIMS.n_audio_ctx, DIMS.n_audio_state))
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _forced(tok, n_text: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    text = rng.integers(0, 50000, n_text).tolist()
    return np.asarray([tok.sot_sequence("en", timestamps=False) + text + [tok.eot]], np.int64)


@pytest.mark.parametrize("weights", ["float32", "int8"])
def test_cross_attention_weights_match_jax(np_params, enc, weights):
    jparams = np_params
    tmodel = TW.params_from_jax(np_params, TDIMS, device="cpu", dtype=torch.float32,
                                weights_int8=weights == "int8")
    if weights == "int8":
        jparams = JW.quantize_block_weights(np_params)
        assert TW.weights_are_int8(tmodel)
    tokens = _forced(Tokenizer.synthetic(DIMS.n_vocab), 13)
    want = np.asarray(JA.cross_attention_weights(
        jax.tree.map(jnp.asarray, jparams), DIMS, jnp.asarray(tokens.astype(np.int32)),
        jnp.asarray(enc)))
    got = TA.cross_attention_weights(tmodel, torch.from_numpy(tokens), torch.from_numpy(enc))
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (4, 1, 4, tokens.shape[1], 1500)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F32_ATOL)
    np.testing.assert_allclose(got.numpy().sum(-1), 1.0, rtol=0, atol=1e-5)


def test_cross_attention_weights_bf16_match_jax(np_params, enc, monkeypatch):
    """bf16 matrices (norms and biases f32) from shared bf16-valued encoder
    states: the cross K/V are then the same f32 products in both packages;
    the weights agree within the measured bounds above."""
    monkeypatch.setattr(jax.nn, "gelu", _gelu_rounded_once)
    tmodel = TW.params_from_jax(np_params, TDIMS, device="cpu", dtype=torch.bfloat16)
    tokens = _forced(Tokenizer.synthetic(DIMS.n_vocab), 21, seed=1)
    want = np.asarray(_jax_bf16(lambda p, t, e: JA.cross_attention_weights(p, DIMS, t, e),
                                _bf16_params(np_params), jnp.asarray(tokens.astype(np.int32)),
                                jnp.asarray(enc)))
    got = TA.cross_attention_weights(tmodel, torch.from_numpy(tokens), torch.from_numpy(enc))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy()[0], want[0], rtol=0, atol=BF16_FIRST_LAYER_ATOL)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=BF16_ATOL)


@pytest.mark.parametrize("costs", ["random", "ties"])
def test_dtw_path_matches_jax(costs):
    rng = np.random.default_rng(3)
    if costs == "random":
        cases = [rng.standard_normal(s).astype(np.float32) for s in ((1, 1), (7, 40), (33, 300))]
    else:   # quantized costs force equal-cost alternatives
        cases = [np.round(rng.standard_normal(s) * 2) / 2 for s in ((12, 18), (20, 90))]
        cases.append(np.zeros((5, 9)))
    for cost in cases:
        ti, fi = TA.dtw_path(cost)
        jti, jfi = JA.dtw_path(cost)
        np.testing.assert_array_equal(ti, jti)
        np.testing.assert_array_equal(fi, jfi)
        assert ti[-1] == cost.shape[0] - 1 and fi[-1] == cost.shape[1] - 1


def _softmax_weights(shape, scale: float, seed: int) -> np.ndarray:
    logits = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale
    w = np.exp(logits - logits.max(-1, keepdims=True))
    return (w / w.sum(-1, keepdims=True)).astype(np.float32)


def test_alignment_matrix_on_device_matches_jax_numpy():
    """The port's torch `_alignment_matrix_torch` against the JAX numpy
    `_alignment_matrix` (and the median filters alone) on softmax-like
    weights, within F32_ATOL; the std's ddof matters: torch's default
    Bessel-corrected std departs by far more. On nearly flat weights the
    f32 numpy evaluation loses digits in (x - mean) / std (measured 7.3e-6
    from its float64 evaluation); the port standardizes in float64 and
    stays within MATRIX_F64_ATOL of numpy's float64 evaluation of the same
    f32 weights (measured 5e-8)."""
    w = _softmax_weights((4, 4, 9, 400), 3.0, seed=5)
    for n_frames in (400, 151):
        want = JA._alignment_matrix(w, n_frames)
        got = TA._alignment_matrix_torch(torch.from_numpy(w), n_frames).numpy()
        assert got.shape == want.shape == (9, n_frames)
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)
        np.testing.assert_array_equal(TA._alignment_matrix(w, n_frames), want)
    flat = _softmax_weights((8, 2, 33, 1500), 0.01, seed=6)
    got = TA._alignment_matrix_torch(torch.from_numpy(flat), 1500).numpy()
    exact = JA._alignment_matrix(flat.astype(np.float64), 1500)
    np.testing.assert_allclose(got, exact, rtol=0, atol=MATRIX_F64_ATOL)
    assert np.abs(JA._alignment_matrix(flat, 1500) - exact).max() > 10 * MATRIX_F64_ATOL
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 5, 50)).astype(np.float32)
    np.testing.assert_array_equal(TA._median_filter_torch(torch.from_numpy(x)).numpy(),
                                  JA._median_filter(x, 7))
    # the same matrix with the Bessel-corrected std (torch's default)
    sel = w[2:].reshape(-1, 9, 400)
    bessel = JA._median_filter((sel - sel.mean(-2, keepdims=True))
                               / (sel.std(-2, ddof=1, keepdims=True) + 1e-9), 7).mean(0)
    assert np.abs(bessel - JA._alignment_matrix(w, 400)).max() > 100 * F32_ATOL


@pytest.mark.parametrize("language", ["en", "zh"])
def test_split_words_matches_jax(language):
    """Spaced scripts split on leading spaces; space-free ones (zh) give one
    word per token, empty pieces dropped."""
    vocab = [b"Hel", b"lo", b" wor", b"ld", b"\xe4\xbd\xa0", b"\xe5\xa5\xbd", b"", b" x"]
    tok = Tokenizer(vocab=vocab, n_vocab=51865, multilingual=True, num_languages=99)
    jtok = JTokenizer(vocab=vocab, n_vocab=51865, multilingual=True, num_languages=99)
    ids = [0, 1, 2, 3, 4, 5, 6, 7, 7, 3]
    got = TA._split_words(tok, ids, language)
    assert got == JA._split_words(jtok, ids, language)
    want = ({"en": ["Hello", " world你好", " x", " xld"],
             "zh": ["Hel", "lo", " wor", "ld", "你", "好", " x", " x", "ld"]}[language])
    assert [w for w, _ in got] == want


def test_word_timestamps_match_jax(np_params, enc):
    """End to end in f32: the same words and the same times (exact) as the
    JAX function, on a window of 9.3 s at an offset of 12.5 s, timestamp
    and special tokens among the sampled ones."""
    tok, jtok = Tokenizer.from_vocab(VOCAB), JTokenizer.from_vocab(VOCAB)
    tmodel = TW.params_from_jax(np_params, TDIMS, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(8)
    tokens = ([tok.ts_begin] + rng.integers(0, 50000, 17).tolist() + [tok.ts_begin + 200]
              + rng.integers(0, 50000, 9).tolist() + [tok.ts_begin + 460, tok.eot])
    kw = dict(language="en", audio_seconds=9.3, time_offset=12.5)
    want = JA.word_timestamps(jax.tree.map(jnp.asarray, np_params), DIMS, jtok, tokens,
                              jnp.asarray(enc), **kw)
    got = TA.word_timestamps(tmodel, tok, tokens, torch.from_numpy(enc), **kw)
    assert got == want
    assert len(got) >= 8
    starts = [w["start"] for w in got]
    assert starts == sorted(starts)
    assert all(12.5 <= w["start"] <= w["end"] <= 12.5 + 9.3 for w in got)
    assert TA.word_timestamps(tmodel, tok, [tok.ts_begin, tok.eot],
                              torch.from_numpy(enc), **kw) == []
