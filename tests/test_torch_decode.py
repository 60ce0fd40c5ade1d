"""Parity of the port's decoding (speaksense_tpu_torch.models.decode) with the
JAX reference on shared tiny weights, both sides in float32 on the CPU: the
logit rules, greedy window decoding (tokens exact), and the host-side
segment split."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speaksense_tpu.models import decode as JD
from speaksense_tpu.models import whisper as JW
from speaksense_tpu.models.tokenizer import Tokenizer as JTokenizer
from speaksense_tpu_torch.models import decode as TD
from speaksense_tpu_torch.models import whisper as TW
from speaksense_tpu_torch.models.tokenizer import Tokenizer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU ops: the parallel test run
    puts several workers on the cores, and torch's thread pool then spins
    against them, slowing these small ops tenfold or more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DIMS = JW.WhisperDims(n_mels=80, n_vocab=51865, n_audio_ctx=1500, n_audio_state=128,
                      n_audio_head=2, n_audio_layer=2, n_text_ctx=448, n_text_state=128,
                      n_text_head=2, n_text_layer=2)
TDIMS = TW.WhisperDims(**DIMS.__dict__)
MAX_NEW = 48

# f32 both sides: a 2-layer decoder's logits agree to ~1e-5, so per-token
# logprobs (and their average) agree to ~1e-5 and the softmax probability of
# <|nospeech|> to ~1e-7; argmax ties closer than that do not occur here
AVG_LOGPROB_ATOL = 1e-4
NO_SPEECH_ATOL = 1e-5

TOK = Tokenizer.synthetic(DIMS.n_vocab)
JTOK = JTokenizer.synthetic(DIMS.n_vocab)


@pytest.fixture(scope="module")
def models():
    np_params = JW.fuse_qkv_weights(JW.init_params_np(DIMS, seed=7))
    jparams = jax.tree.map(jnp.asarray, np_params)
    return jparams, TW.params_from_jax(np_params, TDIMS, device="cpu", dtype=torch.float32)


def _prompts(contexts):
    """Right-padded [<|startofprev|> ctx] + sot-sequence rows, as
    WhisperEngine.decode_windows builds them."""
    sot = TOK.sot_sequence("en")
    rows = [([TOK.sot_prev] + c if c else []) + sot for c in contexts]
    P = max(len(r) for r in rows)
    if P > len(sot):
        P = -(-P // 32) * 32
    prompt = np.full((len(rows), P), TOK.eot, np.int64)
    for i, r in enumerate(rows):
        prompt[i, :len(r)] = r
    lens = np.array([len(r) for r in rows])
    sots = lens - len(sot)
    return prompt, lens, sots


def _run_both(models, mel, contexts, with_ts=True):
    jparams, tmodel = models
    prompt, lens, sots = _prompts(contexts)
    B = mel.shape[0]
    n_ctx = mel.shape[1] // 2
    jcfg = JD.RuleConfig.from_tokenizer(JTOK, with_timestamps=with_ts, max_new_tokens=MAX_NEW)
    tcfg = TD.RuleConfig.from_tokenizer(TOK, with_timestamps=with_ts, max_new_tokens=MAX_NEW)
    assert jcfg.__dict__ == tcfg.__dict__
    sup = TOK.suppress_mask(suppress_non_speech=False, allow_speaker_turn=False)
    j = jax.jit(lambda p, m, pr, pl, si: JD.transcribe_window(
        p, DIMS, jcfg, jnp.asarray(sup), m, pr, jnp.zeros((B,), jnp.float32),
        jax.random.PRNGKey(0), sot_index=si, n_audio_ctx=n_ctx, prompt_len=pl))(
        jparams, jnp.asarray(mel), jnp.asarray(prompt.astype(np.int32)),
        jnp.asarray(lens.astype(np.int32)), jnp.asarray(sots.astype(np.int32)))
    t = TD.transcribe_window(
        tmodel, tcfg, torch.from_numpy(sup), torch.from_numpy(mel), torch.from_numpy(prompt),
        torch.zeros(B), sot_index=torch.from_numpy(sots), n_audio_ctx=n_ctx,
        prompt_len=torch.from_numpy(lens))
    return ({k: np.asarray(v) for k, v in j.items()}, {k: v.numpy() for k, v in t.items()})


@pytest.fixture(scope="module")
def mel():
    return np.random.default_rng(5).standard_normal((3, 3000, 80)).astype(np.float32) * 0.5


@pytest.fixture(scope="module")
def greedy_plain(models, mel):
    return _run_both(models, mel, [[], [], []])


@pytest.fixture(scope="module")
def greedy_context(models, mel):
    # variable-length previous-text prompts: rows of 4, 14 and 38 tokens
    # padded to 64, which exercises the padding-gap mask and the per-row
    # positions of the decode steps
    ctx = [[], [11, 22, 33, 44, 55, 66, 77, 88, 99, 111], list(range(300, 334))]
    return _run_both(models, mel, ctx)


@pytest.mark.parametrize("which", ["greedy_plain", "greedy_context"])
def test_greedy_transcribe_window_matches_jax(which, request):
    j, t = request.getfixturevalue(which)
    np.testing.assert_array_equal(t["n_sampled"], j["n_sampled"])
    np.testing.assert_array_equal(t["tokens"], j["tokens"])
    assert t["n_sampled"].max() > 3       # the rows really decoded something
    np.testing.assert_allclose(t["avg_logprob"], j["avg_logprob"], atol=AVG_LOGPROB_ATOL, rtol=0)
    np.testing.assert_allclose(t["no_speech_prob"], j["no_speech_prob"], atol=NO_SPEECH_ATOL,
                               rtol=0)


def test_greedy_without_timestamps_matches_jax(models, mel):
    j, t = _run_both(models, mel[:2, :1000], [[], [5, 6, 7]], with_ts=False)
    np.testing.assert_array_equal(t["tokens"], j["tokens"])
    np.testing.assert_array_equal(t["n_sampled"], j["n_sampled"])
    assert (t["tokens"] < TOK.eot).sum() + (t["tokens"] == TOK.eot).sum() == t["tokens"].size


def _random_state(rng, B, V):
    logits = rng.standard_normal((B, V)).astype(np.float32) * 3
    # bias some rows towards timestamps so the forcing rule fires
    logits[: B // 2, TOK.ts_begin:] += 6.0
    n_sampled = rng.integers(0, 4, B)
    last = np.where(rng.random(B) < 0.5, rng.integers(TOK.ts_begin, V, B), rng.integers(0, 1000, B))
    penult = np.where(rng.random(B) < 0.5, rng.integers(TOK.ts_begin, V, B),
                      rng.integers(0, 1000, B))
    last_ts = np.where(rng.random(B) < 0.5, rng.integers(TOK.ts_begin, V, B), 0)
    return logits, n_sampled, last, penult, last_ts


@pytest.mark.parametrize("with_ts", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_logit_rules_matches_jax(seed, with_ts):
    rng = np.random.default_rng(seed)
    V = DIMS.n_vocab
    state = _random_state(rng, 16, V)
    sup = TOK.suppress_mask(suppress_non_speech=bool(seed % 2), allow_speaker_turn=False)
    jcfg = JD.RuleConfig.from_tokenizer(JTOK, with_timestamps=with_ts)
    tcfg = TD.RuleConfig.from_tokenizer(TOK, with_timestamps=with_ts)
    want = np.asarray(JD.apply_logit_rules(jnp.asarray(state[0]), jcfg, jnp.asarray(sup),
                                           *(jnp.asarray(x.astype(np.int32)) for x in state[1:])))
    got = TD.apply_logit_rules(torch.from_numpy(state[0]), tcfg, torch.from_numpy(sup),
                               *(torch.from_numpy(x) for x in state[1:])).numpy()
    # every output entry is either the input logit or the mask value, so the
    # two must agree exactly
    np.testing.assert_array_equal(got, want)
    assert (got == TD.NEG_INF).any() and (got != TD.NEG_INF).any()


def test_sample_is_greedy_at_zero_and_seeded_above():
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.standard_normal((4, 1000)).astype(np.float32))
    logits[:, :500] = TD.NEG_INF
    temps = torch.tensor([0.0, 0.0, 1.0, 1.0])
    a = TD._sample(logits, temps, torch.Generator().manual_seed(1))
    b = TD._sample(logits, temps, torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(a[:2].numpy(), logits[:2].argmax(-1).numpy())
    assert (a >= 500).all()     # never a masked token
    np.testing.assert_array_equal(
        TD._sample(logits, torch.zeros(4), None).numpy(), logits.argmax(-1).numpy())


def _random_window_tokens(rng, n):
    """A plausible sampled-token row: text runs between timestamp pairs,
    sometimes ending on an open timestamp."""
    out, ts = [], TOK.ts_begin
    while len(out) < n:
        ts += int(rng.integers(0, 40))
        out.append(ts)
        out.extend(int(x) for x in rng.integers(0, 1000, int(rng.integers(1, 6))))
        ts += int(rng.integers(1, 40))
        if rng.random() < 0.8:
            out.append(ts)
    return np.array(out[:n] + [TOK.eot] * 4, np.int32)


@pytest.mark.parametrize("seed", range(6))
def test_segments_from_tokens_matches_jax(seed):
    rng = np.random.default_rng(seed)
    toks = _random_window_tokens(rng, int(rng.integers(0, 40)))
    n = len(toks) - 4
    want = JD.segments_from_tokens(toks, n, JTOK, window_offset=12.5)
    got = TD.segments_from_tokens(toks, n, TOK, window_offset=12.5)
    assert got == want
