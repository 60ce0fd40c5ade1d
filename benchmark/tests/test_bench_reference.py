"""The plain reference against the program at tiny widths on the CPU:
log-mel, encoder, decoder logits and the decoding rules. The program runs
in float32 here, so the two agree to float32 rounding; what the served
precision costs is the cell's check on the card."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import program, weights
from benchmark.generators.window_backlog import clip_bank, window_audio
from benchmark.reference import whisper as R

TINY = R.Shape(n_mels=80, n_vocab=51866, d=64, heads=2, enc_layers=2, dec_layers=2,
               audio_ctx=1500, text_ctx=448)


TRAFFIC = {"clips": 4, "audio_rms": 0.05, "level_spread": 0.7}


@pytest.fixture(scope="module")
def bank():
    return clip_bank(9, TRAFFIC, "cpu")


@pytest.fixture(scope="module")
def drawn():
    return weights.draw(TINY, 20260418, "cpu")


@pytest.fixture(scope="module")
def port_model(drawn):
    from speaksense_tpu_torch.models import whisper as W

    model = W.Whisper(program.dims(TINY), device="cpu", dtype=torch.float32)
    weights.into_program(model, drawn, TINY)
    return model


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def test_windows_differ_and_repeat(bank):
    a = window_audio(bank, 3, 0, 0)
    assert a.shape == (480000,) and a.dtype == np.float32
    assert np.array_equal(a, window_audio(bank, 3, 0, 0))
    assert not np.array_equal(a, window_audio(bank, 3, 0, 1))
    # a run keeps the bank it made for both sides; made again, the CPU's FFT
    # may round differently with the buffers' alignment
    np.testing.assert_allclose(bank, clip_bank(9, TRAFFIC, "cpu"), rtol=0, atol=1e-6)
    assert np.array_equal(bank[:, :480000], bank[:, 480000:])
    levels = np.sqrt((bank ** 2).mean(axis=1))
    assert levels.min() > 0.005 and levels.max() < 0.5 and levels.std() > 0


def test_draw_is_the_seed_s():
    a = weights.draw(TINY, 7, "cpu")
    b = weights.draw(TINY, 7, "cpu")
    c = weights.draw(TINY, 8, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["dec.0.q.w"], c["dec.0.q.w"])
    assert a["dec.0.q.w"].dtype == torch.bfloat16 and a["dec.0.q.b"].dtype == torch.float32


def test_log_mel_matches_the_program(bank):
    from speaksense_tpu_torch.audio import mel as MEL

    audio = window_audio(bank, 5, 1, 2)
    ref = R.log_mel(torch.from_numpy(audio), 128)
    got = MEL.log_mel_spectrogram(audio, n_mels=128)[0]
    assert ref.shape == got.shape == (3000, 128)
    assert float((ref - got).abs().max()) < 2e-4
    np.testing.assert_allclose(R.mel_filters(128), MEL.mel_filter_bank(128), rtol=1e-5,
                               atol=1e-8)


def test_encoder_and_decoder_match_the_program(bank, drawn, port_model):
    from speaksense_tpu_torch.models import whisper as W

    mel = R.log_mel(torch.from_numpy(window_audio(bank, 1, 0, 0)), TINY.n_mels)
    ref_enc = R.encode(drawn, mel, TINY)
    enc = W.encode(port_model, mel[None])[0]
    assert _rel(enc, ref_enc) < 1e-5
    # the control's float8 encoder moves its states far more than rounding
    assert _rel(R.encode(drawn, mel, TINY, lower=True), ref_enc) > 1e-2

    vocab = R.Vocab.multilingual(TINY.n_vocab)
    tokens = vocab.prompt() + [vocab.ts_begin, 17, 4242, 901, vocab.ts_begin + 30]
    ref = R.decoder_logits(drawn, ref_enc, tokens, TINY)
    t = torch.as_tensor([tokens])
    cache = W.init_cache(port_model, enc[None], t_cap=len(tokens))
    got = W.decode_prefill(port_model, t, cache)[0]
    assert _rel(got, ref) < 1e-5
    # the control's float8 products and 4-bit keys and values move the
    # logits far more than rounding
    assert _rel(R.decoder_logits(drawn, ref_enc, tokens, TINY, lower=True), ref) > 1e-2


def _greedy_by_program(logits, vocab, max_initial):
    """Greedy tokens of the program's rules over a fixed (n, V) logits
    sequence, with its per-step log-probabilities."""
    from speaksense_tpu_torch.models import decode as D

    cfg = D.RuleConfig(eot=vocab.eot, ts_begin=vocab.ts_begin,
                       no_timestamps=vocab.no_timestamps, no_speech=vocab.no_speech,
                       blank=vocab.eot, max_initial_ts_tok=vocab.ts_begin + max_initial)
    suppress = torch.zeros(vocab.n_vocab, dtype=torch.bool)
    suppress[vocab.suppressed()] = True
    one = torch.zeros(1, dtype=torch.long)
    n_sampled, last, penult, last_ts = one.clone(), one.clone(), one.clone(), one.clone()
    out, lps = [], []
    for row in logits:
        f = D.apply_logit_rules(row[None], cfg, suppress, n_sampled, last, penult, last_ts)
        tok = int(f.argmax())
        out.append(tok)
        lps.append(float(torch.log_softmax(f, dim=-1)[0, tok]))
        if tok == vocab.eot:
            break
        penult, last = last, torch.tensor([tok])
        if tok >= vocab.ts_begin:
            last_ts = torch.tensor([tok])
        n_sampled = n_sampled + 1
    return out, lps


@pytest.mark.parametrize("seed", range(6))
def test_rules_match_the_program(seed):
    vocab = R.Vocab.multilingual(51866)
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn(40, vocab.n_vocab, generator=g)
    # lean towards timestamps in some rows so pairs, forcing and EOT all occur
    logits[:, vocab.ts_begin:] += torch.rand(40, 1, generator=g) * 6 - 2.5
    logits[:, vocab.eot] += 3.0 * (seed % 2)
    served, lps = _greedy_by_program(logits, vocab, 50)
    lp = R.history_logprobs(logits[:len(served)], served, vocab, 50)
    assert R.choices(lp, vocab) == served
    assert float(R.gaps(lp, served, vocab).max()) == 0.0
    # a token the rules would not have put first lies below the best
    if len(served) > 3:
        wrong = list(served)
        wrong[3] = served[3] + 1 if served[3] < vocab.eot - 1 else 5
        assert float(R.gaps(lp, wrong, vocab).max()) > 0.0
