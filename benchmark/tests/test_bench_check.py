"""The check's comparisons as each cell's limits file names them, the
log-probability reading, the rate read from any generator's record, the
pairing of a configuration with a mix that no cell names, and the traced
stretches taken on the batcher's thread; on the CPU at the size of
`tiny.py`."""

from __future__ import annotations

import math
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import control, devtrace, run, spec, weights
from benchmark.generators import window_backlog as B
from benchmark.reference import whisper as R
from benchmark.tests import tiny

SEED = 3_000_000_019        # larger than 32 signed bits hold
TURBO = "large-v3-turbo.batch64"


def _run(cell=None, seed=SEED, **kw):
    torch.set_num_threads(4)
    return run.run_cell(cell or tiny.cell(check_windows=64), seed, 8.0, False, "cpu", **kw)


@pytest.fixture(scope="module")
def sound():
    return _run()


def _greedy_answer(w, s, audio, cfg, max_new):
    """A window decoded by the program's own sampling step (its rules, its
    greedy choice, its running log-probability sum) on the plain
    reference's logits: the answer of a program whose every log-probability
    is the reference's."""
    from speaksense_tpu_torch.models import decode as D
    from speaksense_tpu_torch.models.tokenizer import Tokenizer

    tok = Tokenizer.synthetic(s.n_vocab)
    rules = D.RuleConfig.from_tokenizer(tok, max_initial_ts=cfg["decoding"]
                                        ["max_initial_timestamp_s"], max_new_tokens=max_new)
    suppress = torch.as_tensor(tok.suppress_mask(suppress_non_speech=False))
    vocab = R.Vocab.multilingual(s.n_vocab)
    prompt = vocab.prompt(0)
    enc = R.encode(w, R.log_mel(torch.from_numpy(audio), s.n_mels), s)
    logits = R.decoder_logits(w, enc, prompt, s)
    no_speech = math.exp(R.no_speech_logprob(logits, vocab))
    st = D.LoopState.empty(1, s.n_vocab, max_new, "cpu").start(logits[-1:], rules.eot)
    served: list[int] = []
    for step in range(max_new):
        served.append(int(D.sample_token(st, rules, suppress, torch.zeros(1), None, False)[0]))
        if bool(st.finished.all()) or step + 1 == max_new:
            break
        st.logits = R.decoder_logits(w, enc, prompt + served, s)[-1:].clone()
        st.step += 1
    n = int(st.n_sampled[0])
    return {"tokens": st.tokens[0].numpy(), "n_sampled": n, "no_speech_prob": no_speech,
            "avg_logprob": float((st.sum_lp / (st.n_sampled + 1).float())[0])}


def test_logprob_diff_is_nought_for_the_references_own_logprobs():
    """Tokens chosen by the program's sampling step from the reference's
    logits, with its running sum, read a log-probability difference of
    float32 rounding and no gap: the check counts end-of-text, applies the
    timestamp forcing and divides as the program does."""
    cell = tiny.cell(check_windows=3)
    s = R.Shape.from_config(cell.config)
    max_new = cell.config["decoding"]["max_new_tokens"]
    w = weights.draw(s, SEED, "cpu")
    bank = B.clip_bank(SEED, cell.traffic, "cpu")
    keys = [(t, 0) for t in range(3)]
    answers = {k: _greedy_answer(w, s, B.window_audio(bank, SEED, *k), cell.config, max_new)
               for k in keys}
    assert sum(a["n_sampled"] for a in answers.values()) > 100
    served = B.Served(t_open=0.0, t_close=1.0, windows=keys, attempted=3, failed=0,
                      answers=answers, batch_of={}, batch_t={}, snaps={}, max_batch=4,
                      bank=bank)
    got = B.check(served, cell.config, cell.traffic, SEED, "cpu", w)["program"]
    assert got["windows"] == 3
    assert got["logprob_diff"] < 2e-6, got
    assert got["gap"] < 1e-4 and got["no_speech_diff"] < 1e-5, got


@pytest.mark.parametrize("served, text, eot, stamps, forced", [
    ("stamp", -1.0, -5.0, (-2.0, -3.0), True),      # the timestamps' total below the best text
    ("text", -1.0, -5.0, (-0.5, -3.0), False),      # a text token served: never forced
    ("eot", -1.0, -3.0, (-1.1, -9.0), True),        # the forcing's tie (0.1) the nearer
    ("eot", -1.0, -1.05, (-3.0, -9.0), False),      # the choice's tie (0.05) the nearer
    ("eot", -2.0, -1.0, (-3.0, -4.0), False),       # the best token, the timestamps below it
    ("eot", -2.0, -1.0, (-0.5, -4.0), True),        # the best token, the timestamps above it
])
def test_served_logprobs_read_the_forcing_from_the_token(served, text, eot, stamps, forced):
    """A served token's log-probability renormalised over the tokens that
    are not text where the decoder forced a timestamp: always for a
    timestamp, never for a text token, for end-of-text by the nearer tie."""
    vocab = R.Vocab.multilingual(51866)
    logits = torch.full((1, 51866), -1e4)
    logits[0, 100], logits[0, vocab.eot] = text, eot
    logits[0, vocab.ts_begin], logits[0, vocab.ts_begin + 1] = stamps
    lp = torch.log_softmax(logits, dim=-1)
    tok = {"stamp": vocab.ts_begin, "text": 100, "eot": vocab.eot}[served]
    own = lp[0, tok]
    want = own - torch.logsumexp(lp[0, vocab.eot:], dim=-1) if forced else own
    assert float(R.served_logprobs(lp, [tok], vocab)[0]) == pytest.approx(float(want))


@pytest.mark.parametrize("fault", B.FAULTS[:2])
def test_logprob_diff_grows_with_a_fault(sound, fault):
    """A stale step state and an altered token each move a window's
    average log-probability away from the reference's far beyond a sound
    run's, and past the tiny cell's limit."""
    with spec.generator(tiny.cell().traffic["generator"]).planted(fault):
        out = _run()
    base = sound["readings"]["program"]["logprob_diff"]
    got = out["readings"]["program"]["logprob_diff"]
    assert got > 10 * base and got > tiny.cell().limits["rms_logprob_diff"]["limit"], (got, base)


def test_every_control_reads_a_logprob_diff():
    """Each control reads the difference at the program's tokens, beyond
    the program's own and past the tiny cell's limit."""
    out = _run(controls=B.CONTROLS)
    program = out["readings"]["program"]["logprob_diff"]
    limit = tiny.cell().limits["rms_logprob_diff"]["limit"]
    assert program < limit
    for name in B.CONTROLS:
        assert out["readings"][name]["logprob_diff"] > max(5 * program, limit), name


def test_judge_fails_a_reading_the_run_lacks():
    limits = {"rms_logprob_diff": {"reading": "logprob_diff", "limit": 1.0},
              "max_logit_gap": {"reading": "gap", "limit": 1.0}}
    readings = {"gap": 0.0, "windows": 4}
    correct, checks = run.judge(readings, limits, 0)
    assert correct is False and checks["rms_logprob_diff"]["value"] is None
    assert run.judge({**readings, "logprob_diff": 0.5}, limits, 0)[0] is True
    assert run.judge({**readings, "logprob_diff": 0.5}, limits, 1)[0] is False
    assert run.judge({**readings, "logprob_diff": math.inf}, limits, 0)[0] is False
    assert run.judge(readings, {}, 0) == (False, {"failed": {"value": 0, "limit": 0}})


def test_turbo_keeps_its_three_comparisons():
    """The three comparisons the cell had keep their names, readings and
    limits, and judge a run as before; the fourth reads `logprob_diff`."""
    cell = spec.cell(spec.load_json(spec.ROOT / "BENCHMARK.json"), TURBO)
    before = {"max_logit_gap": ("gap", 0.07), "mean_logit_gap": ("mean_gap", 3.5e-5),
              "max_no_speech_logprob_diff": ("no_speech_diff", 0.065)}
    for name, (reading, limit) in before.items():
        assert (cell.limits[name]["reading"], cell.limits[name]["limit"]) == (reading, limit)
    assert set(cell.limits) - set(before) == {"rms_logprob_diff"}
    assert cell.limits["rms_logprob_diff"]["reading"] == "logprob_diff"
    readings = {"gap": 0.02, "mean_gap": 1e-5, "no_speech_diff": 0.01, "logprob_diff": 0.0,
                "windows": 64}
    correct, checks = run.judge(readings, cell.limits, 0)
    assert correct is True
    assert [checks[n]["value"] for n in before] == [0.02, 1e-5, 0.01]
    for name, (reading, limit) in before.items():
        over = {**readings, reading: limit * 1.01}
        assert run.judge(over, cell.limits, 0)[0] is False, name


def test_batch_rtf_reads_any_record_that_states_audio_s():
    read = spec.reader("batch_rtf")
    served = B.Served(t_open=1.0, t_close=5.0, windows=[(0, 0), (1, 0), (2, 0)], attempted=3,
                      failed=0, answers={}, batch_of={}, batch_t={}, snaps={}, max_batch=4)
    assert read(SimpleNamespace(generator="window_backlog", served=served)) == 30.0 * 3 / 4.0
    other = SimpleNamespace(audio_s=10.0, seconds=4.0)
    assert read(SimpleNamespace(generator="another", served=other)) == 2.5
    assert read(SimpleNamespace(generator="another", served=SimpleNamespace(seconds=4.0))) is None


def test_control_builds_a_pairing_no_cell_names():
    args = control.parse(["--config", "benchmark/configs/large-v3.json", "--traffic", "batch64",
                          "--seconds", "38", "--seeds", "1,2"])
    cell = control.cell_of(args)
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    assert cell.name == "large-v3.batch64"
    assert cell.name not in {w["name"] for w in bench["workloads"]}
    assert "large-v3" not in {c["name"] for c in bench["configs"]}
    assert cell.limits == {} and cell.chips == 1
    assert (cell.config["decoder_layers"], cell.config["encoder_layers"]) == (32, 32)
    turbo = spec.load_json(spec.ROOT / "benchmark/configs/large-v3-turbo.json")
    assert {k: v for k, v in cell.config.items() if k not in ("name", "source", "decoder_layers")} \
        == {k: v for k, v in turbo.items() if k not in ("name", "source", "decoder_layers")}
    assert control.cell_of(control.parse(["--workload", TURBO, "--seconds", "8"])).name == TURBO
    with pytest.raises(SystemExit):
        control.parse(["--config", "benchmark/configs/large-v3.json", "--seconds", "8"])


def test_a_generator_provides_what_the_harness_reads(monkeypatch):
    """The window generator provides every name of `spec.GENERATOR`: its
    check's readings hold each of `READINGS` and its faults each plant;
    a generator that lacks one is refused by name."""
    gen = spec.generator("window_backlog")
    assert set(B.READINGS) <= set(B.summarize([])) and "windows" in B.READINGS
    for fault in gen.FAULTS:
        with gen.planted(fault):
            pass
    with pytest.raises(KeyError):
        with gen.planted("no such fault"):
            pass
    monkeypatch.delattr(B, "FAULTS")
    with pytest.raises(AttributeError, match="FAULTS"):
        spec.generator("window_backlog")


def test_stretches_start_and_stop_on_the_batcher_thread(monkeypatch):
    """Every start and stop of a traced stretch runs on the batcher's
    thread, at a batch's completion."""
    calls = []

    class Trace:
        running = False
        info = None

        def prepare(self, device):
            pass

        def start(self):
            calls.append(("start", threading.current_thread().name))

        def stop(self):
            calls.append(("stop", threading.current_thread().name))

        def summary(self):
            name = B.TRACE_HOLDS
            return devtrace.Summary(window_s=1.0, busy_s=0.5, kernels={name: 0.5},
                                    durations={name: [0.5]})

    monkeypatch.setattr(devtrace, "DeviceTrace", Trace)
    torch.set_num_threads(4)
    out = run.run_cell(tiny.cell(), SEED, 8.0, True, "cpu")
    assert calls == [("start", "batch-engine"), ("stop", "batch-engine")]
    assert out["trace"] is not None and out["correct"] is True, out["checks"]


@pytest.mark.parametrize("events, idle", [
    ([(1100, 200), (1200, 300), (1700, 100), (1950, 100)],
     [[1000, 1100], [1500, 1700], [1800, 1950]]),
    ([(1010, 5), (1012, 10), (1040, 5), (1090, 30)],
     [[1000, 1010], [1022, 1040], [1045, 1090], [1120, 2000]]),
])
def test_summary_keeps_the_idle_intervals(events, idle):
    """Every interval of the traced window with nothing on the device, in
    time order on the spans' clock; with the busy time they fill the
    window."""
    from torch.autograd import DeviceType

    t = devtrace.DeviceTrace()
    t._marks = [1000, 2000]
    evs = [SimpleNamespace(name=lambda: "k", start_ns=lambda s=s: s, duration_ns=lambda d=d: d,
                           device_type=lambda: DeviceType.CUDA) for s, d in events]
    t._prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: evs)))
    s = t.summary()
    assert s.idle.tolist() == idle and s.idle.dtype == np.int64
    idle_ns = int((s.idle[:, 1] - s.idle[:, 0]).sum())
    assert idle_ns / 1e9 + s.busy_s == pytest.approx(s.window_s)
    assert devtrace.Summary(window_s=1.0, busy_s=1.0).idle.shape == (0, 2)
