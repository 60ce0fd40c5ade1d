"""The port's beam search (speaksense_tpu_torch.models.beam) against the JAX
package's `beam_decode` / `transcribe_window_beam` on shared tiny weights on
the CPU: K = 1 (greedy), 2 and 5, a conditioning prompt, int8 cross-KV, in
float32 and in bfloat16 (one step's logits and whole searches), the joint
top-k's tie order, and the engine's `decode_windows(beam_size=5)`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speaksense_tpu.asr.engine import WhisperEngine as JEngine
from speaksense_tpu.config import EngineConfig
from speaksense_tpu.models import beam as JB
from speaksense_tpu.models import decode as JD
from speaksense_tpu.models import whisper as JW
from speaksense_tpu.models.tokenizer import Tokenizer as JTokenizer
from speaksense_tpu_torch.asr.engine import WhisperEngine as TEngine
from speaksense_tpu_torch.models import beam as TB
from speaksense_tpu_torch.models import decode as TD
from speaksense_tpu_torch.models import whisper as TW
from speaksense_tpu_torch.models.tokenizer import Tokenizer


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
MAX_NEW = 24
SUPPRESS = TOK.suppress_mask()
# f32 on both sides, summed in different orders: the hypotheses' scores are
# sums of MAX_NEW log-probabilities that agree to a few f32 ulps each
# (measured below 2e-5); the no-speech probability to 1e-6
SUM_LOGPROB_ATOL = 1e-3
NO_SPEECH_ATOL = 1e-6

# bfloat16 on both sides. The port rounds where the reference program
# rounds, which the bf16 tests hold bit for bit after two adjustments on the
# JAX side, each for XLA:CPU rather than for the program:
# - `xla_allow_excess_precision` off: XLA:CPU otherwise skips some of the
#   program's bf16 roundings (a value stays f32 between two ops);
# - GELU evaluated in f32 and rounded once: `jax.nn.gelu` on bf16 rounds its
#   inner steps (erfc's argument, the product), so a quarter of its outputs
#   lie one ulp from the exactly rounded GELU that torch (and the port) give.
# XLA:CPU cannot run the JAX beam search's batched bf16 cross-attention
# product ("Unsupported element type for DotThunk::Execute: BF16 x BF16 =
# F32" at B > 1), so the reference searches one window at a time, and both
# sides start from the same encoder states rounded to bf16 (the port's
# products round their f32 operands to bf16, as the TPU's default precision
# does; XLA:CPU multiplies them in f32).
# One step's logits then agree to f32 rounding (measured 1.5e-7; 1e-6). A
# whole search agrees token for token; its log-probabilities move only where
# an f32 sum taken in another order (softmax, GEMM) lands on the other side
# of a bf16 rounding boundary, so the bound is per token, on avg_logprob =
# sum_logprob / (n_sampled + 1): in this file's three bf16 searches three
# of six rows have equal sums, the largest moved 9.5e-4 over 25 tokens, and
# at most 5.3e-5 a token; the greedy window decode of
# tests/test_torch_decode.py moved 6.8e-3 over 49 (1.4e-4 a token).
BF16_LOGIT_ATOL = 1e-6
BF16_AVG_LOGPROB_ATOL = 5e-4
# the unadjusted reference (its own bf16 GELU, excess precision on): one
# ulp of a hidden state apart; one step's logits measured 3.7e-3 to 7.1e-3
BF16_RAW_LOGIT_ATOL = 1.5e-2
EXACT_ROUNDING = {"xla_allow_excess_precision": False}


def _gelu_rounded_once(x, approximate=True):
    return _JAX_GELU(x.astype(jnp.float32), approximate=approximate).astype(x.dtype)


_JAX_GELU = jax.nn.gelu


def _jax_bf16(fn, *args, exact=True):
    """fn(*args) jitted, with the program's bf16 roundings kept when exact."""
    return jax.jit(fn).lower(*args).compile(compiler_options=EXACT_ROUNDING if exact else {})(*args)


def _bf16_params(np_params):
    """The JAX engine's device placement in bf16: matrices in the compute
    dtype, vectors (norms, biases) in f32."""
    return jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16 if np.ndim(x) >= 2
                                              else jnp.float32), np_params)


@pytest.fixture(scope="module")
def np_params():
    return JW.fuse_qkv_weights(JW.init_params_np(DIMS, seed=3))


@pytest.fixture(scope="module")
def models(np_params):
    return (jax.tree.map(jnp.asarray, np_params),
            TW.params_from_jax(np_params, TDIMS, device="cpu", dtype=torch.float32))


@pytest.fixture(scope="module")
def models_bf16(np_params):
    return (_bf16_params(np_params),
            TW.params_from_jax(np_params, TDIMS, device="cpu", dtype=torch.bfloat16))


@pytest.fixture(scope="module")
def mel():
    return np.random.default_rng(0).standard_normal((2, 1024, 80)).astype(np.float32) * 0.3


def _cfgs(max_new=MAX_NEW):
    jcfg = JD.RuleConfig.from_tokenizer(JTOK, max_new_tokens=max_new)
    tcfg = TD.RuleConfig.from_tokenizer(TOK, max_new_tokens=max_new)
    assert jcfg.__dict__ == tcfg.__dict__
    return jcfg, tcfg


def _prompts(contexts):
    """Right-padded [<|startofprev|> ctx] + sot rows, their lengths and the
    positions of <|sot|>."""
    sot = TOK.sot_sequence("en")
    rows = [([TOK.sot_prev] + c if c else []) + sot for c in contexts]
    P = max(len(r) for r in rows) + (4 if any(contexts) else 0)
    prompt = np.full((len(rows), P), TOK.eot, np.int64)
    for i, r in enumerate(rows):
        prompt[i, :len(r)] = r
    lens = np.array([len(r) for r in rows])
    return prompt, lens, lens - len(sot)


def _both(models, mel, K, contexts=([], []), cross_kv_int8=False):
    jparams, tmodel = models
    jcfg, tcfg = _cfgs()
    prompt, lens, sots = _prompts(list(contexts))
    j = jax.jit(lambda p, m, pr, pl, si: JB.transcribe_window_beam(
        p, DIMS, jcfg, jnp.asarray(SUPPRESS), m, pr, beam_size=K, n_audio_ctx=512,
        prompt_len=pl, sot_index=si, cross_kv_int8=cross_kv_int8))(
        jparams, jnp.asarray(mel), jnp.asarray(prompt.astype(np.int32)),
        jnp.asarray(lens.astype(np.int32)), jnp.asarray(sots.astype(np.int32)))
    t = TB.transcribe_window_beam(
        tmodel, tcfg, torch.from_numpy(SUPPRESS), torch.from_numpy(mel),
        torch.from_numpy(prompt), beam_size=K, n_audio_ctx=512,
        prompt_len=torch.from_numpy(lens), sot_index=torch.from_numpy(sots),
        cross_kv_int8=cross_kv_int8)
    return ({k: np.asarray(v) for k, v in j.items()}, {k: v.numpy() for k, v in t.items()})


def _both_bf16(models_bf16, enc, K, contexts, cross_kv_int8):
    """beam_decode in bf16 from the same encoder states: the JAX search one
    window at a time (see BF16_LOGIT_ATOL), the port's on the batch."""
    jparams, tmodel = models_bf16
    jcfg, tcfg = _cfgs()
    prompt, lens, sots = _prompts(list(contexts))
    rows = []
    for b in range(prompt.shape[0]):
        rows.append(_jax_bf16(
            lambda p, e, pr, pl, si: JB.beam_decode(
                p, DIMS, jcfg, jnp.asarray(SUPPRESS), e, pr, beam_size=K, prompt_len=pl,
                sot_index=si, cross_kv_int8=cross_kv_int8),
            jparams, jnp.asarray(enc[b:b + 1]), jnp.asarray(prompt[b:b + 1].astype(np.int32)),
            jnp.asarray(lens[b:b + 1].astype(np.int32)),
            jnp.asarray(sots[b:b + 1].astype(np.int32))))
    j = {k: np.concatenate([np.asarray(r[k]) for r in rows]) for k in rows[0]}
    t = TB.beam_decode(tmodel, tcfg, torch.from_numpy(SUPPRESS), torch.from_numpy(enc),
                       torch.from_numpy(prompt), beam_size=K, prompt_len=torch.from_numpy(lens),
                       sot_index=torch.from_numpy(sots), cross_kv_int8=cross_kv_int8)
    return j, {k: v.float().numpy() for k, v in t.items()}


@pytest.fixture(scope="module")
def enc_bf16(models, mel):
    """The f32 JAX encoder's states of `mel`, rounded to bf16."""
    enc = JW.encode(models[0], DIMS, jnp.asarray(mel), n_ctx_out=512)
    return np.asarray(enc.astype(jnp.bfloat16), np.float32)


def _assert_same(j, t):
    np.testing.assert_array_equal(t["n_sampled"], j["n_sampled"])
    np.testing.assert_array_equal(t["tokens"], j["tokens"])
    np.testing.assert_allclose(t["sum_logprob"], j["sum_logprob"], atol=SUM_LOGPROB_ATOL, rtol=0)
    np.testing.assert_allclose(t["avg_logprob"], t["sum_logprob"] / (t["n_sampled"] + 1),
                               rtol=1e-6)
    np.testing.assert_allclose(t["no_speech_prob"], j["no_speech_prob"], atol=NO_SPEECH_ATOL,
                               rtol=0)


@pytest.mark.parametrize("K, kind", [(2, "plain"), (5, "plain"), (3, "conditioned"),
                                     (3, "cross_kv_int8"), (5, "bf16"),
                                     (3, "bf16_conditioned"), (3, "bf16_cross_kv_int8")])
def test_beam_decode_matches_jax(models, models_bf16, mel, enc_bf16, monkeypatch, K, kind):
    """Tokens equal and sum_logprob within 1e-3 of the JAX beam search (in
    bf16 avg_logprob within BF16_AVG_LOGPROB_ATOL, with the reference
    adjusted as stated there). At K = 5 hypotheses finish before the budget (the
    frozen-EOT path); the conditioned case has rows of different prompt
    lengths padded past the longest (the padding gap is masked); int8
    cross-KV folds its scales into the query and the output on both
    sides."""
    contexts = ([], [11, 22, 33]) if kind.endswith("conditioned") else ([], [])
    int8 = kind.endswith("cross_kv_int8")
    if kind.startswith("bf16"):
        monkeypatch.setattr(jax.nn, "gelu", _gelu_rounded_once)
        j, t = _both_bf16(models_bf16, enc_bf16, K, contexts, int8)
        np.testing.assert_array_equal(t["n_sampled"], j["n_sampled"])
        np.testing.assert_array_equal(t["tokens"], j["tokens"])
        np.testing.assert_allclose(t["avg_logprob"], j["avg_logprob"],
                                   atol=BF16_AVG_LOGPROB_ATOL, rtol=0)
        np.testing.assert_allclose(t["no_speech_prob"], j["no_speech_prob"],
                                   atol=NO_SPEECH_ATOL, rtol=0)
    else:
        j, t = _both(models, mel, K, contexts, cross_kv_int8=int8)
        _assert_same(j, t)
    assert t["n_sampled"].min() > 3
    if K == 5:
        assert t["n_sampled"].max() < MAX_NEW     # the best hypotheses ended in EOT
    for row in t["tokens"]:
        assert row[0] >= TOK.ts_begin              # the initial-timestamp rule held


def test_beam_one_equals_greedy(models, mel):
    """beam_size = 1 is the greedy trajectory: the port's beam search at
    K = 1 gives the port's greedy window decode's tokens and scores, and
    both the JAX beam search's."""
    j, t = _both(models, mel, 1)
    _assert_same(j, t)
    _, tcfg = _cfgs()
    prompt, lens, _ = _prompts([[], []])
    g = TD.transcribe_window(models[1], tcfg, torch.from_numpy(SUPPRESS), torch.from_numpy(mel),
                             torch.from_numpy(prompt), torch.zeros(2), n_audio_ctx=512,
                             prompt_len=torch.from_numpy(lens))
    np.testing.assert_array_equal(t["tokens"], g["tokens"].numpy())
    np.testing.assert_allclose(t["sum_logprob"], g["sum_logprob"].numpy(), atol=1e-4, rtol=0)


@pytest.mark.parametrize("cross_kv_int8", [False, True])
def test_beam_step_bf16_matches_jax(models_bf16, monkeypatch, cross_kv_int8):
    """One bf16 step of K = 3 hypotheses: the port's `beam_forward` against
    the JAX beam block (`_beam_block_factory`, scanned over the layers, and
    `_decoder_tail`) on the same encoder states, prompt pages, generated
    rows, ancestor tables and tokens. Each hypothesis reads the page row
    its ancestor wrote at every column, and its own key and value with an
    unrounded softmax weight. Logits within BF16_LOGIT_ATOL of the adjusted
    reference and within BF16_RAW_LOGIT_ATOL of the reference as it is."""
    jparams, tmodel = models_bf16
    rng = np.random.default_rng(4)
    K, plen, P, n, T, Wr, B = 3, 5, 7, 6, 128, 16, 1
    L, H = DIMS.n_text_layer, DIMS.n_text_head
    Dh = DIMS.n_text_state // H

    def bf16(*shape):
        return np.asarray(jnp.asarray(rng.standard_normal(shape) * 0.7, jnp.bfloat16),
                          np.float32)

    enc = bf16(B, 256, DIMS.n_audio_state)
    pk, pv = bf16(L, B, K, H, T, Dh), bf16(L, B, K, H, T, Dh)    # prompt columns [0, P)
    pk[..., P:, :] = pv[..., P:, :] = 0
    rk, rv = bf16(L, B, K, H, Wr, Dh), bf16(L, B, K, H, Wr, Dh)  # generated rows [0, n)
    rk[..., n:, :] = rv[..., n:, :] = 0
    anc_c = rng.integers(0, K, (B, K, T))
    anc_r = rng.integers(0, K, (B, K, Wr))
    tok = rng.integers(0, 50000, (B, K))
    pos = np.full((B, K), plen + n)
    own = np.arange(K)[None, None, :, None]
    oh_cache = ((anc_c[:, :, None, :] == own) & (np.arange(T) < plen)).astype(np.float32)
    oh_ring = ((anc_r[:, :, None, :] == own) & (np.arange(Wr) < n)).astype(np.float32)
    def jax_step(p, enc):
        if cross_kv_int8:
            ck, cv, cks, cvs = JW.compute_cross_kv(p, DIMS, enc, int8=True)
        else:
            (ck, cv), cks, cvs = JW.compute_cross_kv(p, DIMS, enc, dtype=jnp.bfloat16), None, None
        x = (p["decoder"]["tok_emb"][tok.reshape(-1)][:, None, :]
             + p["decoder"]["pos"][pos.reshape(-1)][:, None, :].astype(jnp.bfloat16))
        sk, sv = (jnp.asarray(a.swapaxes(-1, -2), jnp.bfloat16) for a in (pk, pv))
        (x, _, _, _), _ = jax.lax.scan(
            JB._beam_block_factory(DIMS, B, K), (x, jnp.asarray(pos.reshape(-1)), oh_cache,
                                                 oh_ring),
            (p["decoder"]["blocks"], sk, sv, jnp.asarray(rk, jnp.bfloat16),
             jnp.asarray(rv, jnp.bfloat16), ck, cv, cks, cvs))
        return JW._decoder_tail(p, x)[:, 0, :]

    # new function objects (the step and its block) for each reference, so
    # that neither reuses the other's trace
    raw = np.asarray(_jax_bf16(lambda p, e: jax_step(p, e), jparams, jnp.asarray(enc),
                               exact=False), np.float32)
    monkeypatch.setattr(jax.nn, "gelu", _gelu_rounded_once)
    want = np.asarray(_jax_bf16(lambda p, e: jax_step(p, e), jparams, jnp.asarray(enc)),
                      np.float32)

    # the port: the generated rows at columns [P, P + n), the step's at P + n
    col = P + n
    keys, values = pk.copy(), pv.copy()
    keys[..., P:col, :], values[..., P:col, :] = rk[..., :n, :], rv[..., :n, :]
    pages = TW.new_cache(tmodel, TW.compute_cross_kv(tmodel, torch.from_numpy(enc),
                                                     int8=cross_kv_int8), T, beams=K)
    pages.self_k.copy_(torch.from_numpy(keys.swapaxes(2, 3).copy()))
    pages.self_v.copy_(torch.from_numpy(values.swapaxes(2, 3).copy()))
    anc = anc_c.copy()
    anc[:, :, P:col] = anc_r[:, :, :n]
    anc[:, :, col] = np.arange(K)
    t_idx = np.arange(T)
    valid = ((t_idx < plen) | ((t_idx >= P) & (t_idx < col)))[None]
    got = TB.beam_forward(tmodel, torch.from_numpy(tok), torch.from_numpy(pos), pages,
                          torch.from_numpy(anc), torch.from_numpy(valid), col=col).numpy()
    np.testing.assert_allclose(got, want, atol=BF16_LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(got, raw, atol=BF16_RAW_LOGIT_ATOL, rtol=0)
    assert np.abs(got - raw).max() > 10 * BF16_LOGIT_ATOL     # the adjustments matter


def test_topk_ties_go_to_the_lower_index():
    """The joint top-k orders equal scores by index, as jax.lax.top_k does:
    at a pool's first step every hypothesis but the first sits at -1e30,
    so most entries tie."""
    rng = np.random.default_rng(1)
    x = np.round(rng.standard_normal((4, 300)), 1).astype(np.float32)
    x[0, 100:] = -1e30
    x[1] = -1e30
    x[2, ::3] = 0.0
    x[3, 7] = -0.0
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), 7)
    got_v, got_i = TB._topk_lowest_index(torch.from_numpy(x), 7)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("cross_kv_int8", [False, True])
def test_decode_windows_beam_matches_jax(cross_kv_int8):
    """The engine's window path with beam_size=5 (`_beam_fn` and the beam
    branch of decode_windows): each row's beam candidate, with the ladder
    neutralized so only the beam attempt runs."""
    cfg = EngineConfig(compute_dtype="float32", logprob_thold=-1e9, entropy_thold=-1.0,
                       compression_ratio_thold=1e9, cross_kv_int8=cross_kv_int8)
    np_params = JW.init_params_np(DIMS, seed=0)
    jeng = JEngine(np_params, DIMS, JTOK, config=cfg)
    teng = TEngine.from_jax_params(np_params, TDIMS, TOK, config=cfg, device="cpu")
    audio = (np.random.default_rng(2).standard_normal((2, 16000)) * 0.1).astype(np.float32)
    mels = np.asarray(jeng.compute_mel(audio))
    want = jeng.decode_windows(mels, "en", beam_size=5, max_new_tokens=12)
    got = teng.decode_windows(mels, "en", beam_size=5, max_new_tokens=12)
    for w, g in zip(want, got):
        assert g["n_sampled"] == w["n_sampled"] and g["text"] == w["text"]
        np.testing.assert_array_equal(g["tokens"], w["tokens"])
        assert g["temperature"] == w["temperature"] == 0.0
        assert abs(g["avg_logprob"] - w["avg_logprob"]) <= SUM_LOGPROB_ATOL / 13
        assert g["compression_ratio"] == w["compression_ratio"]
    # config.beam_size reaches decode_windows when the caller passes none
    teng.config = EngineConfig(**{**cfg.__dict__, "beam_size": 5})
    again = teng.decode_windows(mels, "en", max_new_tokens=12)
    for g, a in zip(got, again):
        np.testing.assert_array_equal(a["tokens"], g["tokens"])
