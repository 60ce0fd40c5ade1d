"""Whole runs of a cell cut to CPU size (`tiny.py`): the shape of the last
line, both controls (the reference one precision step down in the
program's place, and the program's own int8 decoder weights) and each
fault the cell can have turning `correct` false, and the import boundary.
`run_cell` is what `run.py` runs after its look for a card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from benchmark import faults, run, spec
from benchmark.tests import tiny

SEED = 3_000_000_019        # larger than 32 signed bits hold


def _run(cell=None, seed=SEED, **kw):
    torch.set_num_threads(4)
    return run.run_cell(cell or tiny.cell(), seed, 8.0, False, "cpu", **kw)


@pytest.fixture(scope="module")
def sound():
    return _run()


def test_last_line_shape(sound):
    line = run.result_line(sound, 1, "NVIDIA H100 80GB HBM3")
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {"batch_rtf", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert line["device"] == {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                              "memory_peak_bytes": 0}
    assert list(line["checks"]) == ["max_logit_gap", "mean_logit_gap",
                                    "max_no_speech_logprob_diff", "failed"]
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    json.loads(json.dumps(line))


def test_control_is_not_correct():
    """The reference one precision step down (float8 products in the
    encoder and the decoder, 4-bit keys and values), put in the program's
    place, comes out not correct by the harness's own comparison, every
    answered window checked; the program's run of the same seed is
    correct."""
    cell = tiny.cell(check_windows=64)
    out = _run(cell, judged="control")
    assert out["correct"] is False, out["checks"]
    program, control = out["readings"]["program"], out["readings"]["control"]
    assert run.judge(program, cell.limits, out["failed"])[0] is True
    assert program["windows"] == control["windows"] >= 8 and program["tokens"] > 1000
    assert control["mean_gap"] > 30 * program["mean_gap"]


def test_int8_weights_are_not_correct():
    """The program's own lower precision, int8 decoder weights, is the
    other control: on a seed where it stands apart at this size (7 of 12
    do, `tiny.py`) it comes out not correct, and the program's sound run of
    that seed is correct."""
    cell = tiny.cell(check_windows=64)
    sound = _run(cell, seed=45)
    assert sound["correct"] is True, sound["checks"]
    out = _run(cell, seed=45, overrides={"weights_int8": True})
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_fault_is_not_correct(fault):
    """Every answer of the window is checked here, so a fault in any row
    shows; on the card the sample of 64 is drawn from the seed."""
    with faults.planted(fault):
        out = _run(tiny.cell(check_windows=64))
    assert out["correct"] is False, (fault, out["checks"])


def test_seed_gives_the_same_answers(monkeypatch):
    """Two runs of one seed serve the same windows the same tokens (which
    windows fall inside the window follows the host's clock)."""
    from benchmark.generators import window_backlog as B

    got = []
    drive = B.serve

    def keep(*a, **k):
        got.append(drive(*a, **k))
        return got[-1]
    monkeypatch.setattr(B, "serve", keep)
    _run(), _run()
    a, b = got
    both = set(a.answers) & set(b.answers)
    assert len(both) >= 4
    for key in both:
        assert (a.answers[key]["tokens"] == b.answers[key]["tokens"]).all()
    assert (a.bank == b.bank).all()


def test_trace_without_kernel_1_is_taken_again(monkeypatch):
    """A traced stretch whose trace holds no launch of kernel #1 lost the
    batcher thread's kernels: the stretch after the next is traced, and
    only a trace that holds the batch is kept."""
    from benchmark import devtrace
    from benchmark.generators import window_backlog as B

    class Trace:
        sessions = 0

        def __init__(self):
            self.on, self.info = False, None

        running = property(lambda self: self.on)

        def prepare(self, device):
            pass

        def start(self):
            Trace.sessions += 1
            self.on, self.n = True, Trace.sessions

        def stop(self):
            self.on = False

        def summary(self):
            name = "flash_attn_fwd_ws" if self.n > 1 else "Memcpy DtoH (Device -> Pinned)"
            return devtrace.Summary(window_s=1.0, busy_s=0.5, kernels={name: 0.5},
                                    durations={name: [0.5]})

    got = []
    drive = B.serve

    def keep(*a, **k):
        got.append(drive(*a, **k))
        return got[-1]
    monkeypatch.setattr(devtrace, "DeviceTrace", Trace)
    monkeypatch.setattr(B, "serve", keep)
    torch.set_num_threads(4)
    out = run.run_cell(tiny.cell(), SEED, 8.0, True, "cpu")
    served = got[0]
    (a0, b0), (a1, b1) = served.trace_tries
    assert a1 > b0 and served.trace_batches == (a1, b1)
    assert out["trace"].launches_of(B.TRACE_HOLDS) == [0.5]
    assert out["correct"] is True, out["checks"]


def test_imports_stay_inside_the_boundary():
    """The reference loads nothing of the program; a whole run loads no
    JAX and nothing of the JAX package (top-level names compared whole)."""
    code = ("import sys, torch; sys.path.insert(0, '.');"
            "import benchmark.reference.whisper, benchmark.weights, benchmark.flops;"
            "print(sorted(m for m in sys.modules if m.split('.')[0].startswith('speaksense')))")
    got = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=spec.ROOT, timeout=120, check=True)
    assert got.stdout.strip() == "[]"
    code = ("import sys; sys.path.insert(0, '.'); import torch; torch.set_num_threads(2);"
            "from benchmark import run; from benchmark.tests import tiny;"
            "run.run_cell(tiny.cell(), 11, 8.0, False, 'cpu');"
            "print(run.forbidden_modules(),"
            " any(m.split('.')[0] == 'speaksense_tpu_torch' for m in sys.modules))")
    got = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=spec.ROOT, timeout=300, check=True)
    assert got.stdout.strip().splitlines()[-1] == "[] True"


def test_no_card_no_result():
    """Without a CUDA card run.py exits with code 2 and prints nothing."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    got = subprocess.run([sys.executable, "benchmark/run.py", "--workload", tiny.WORKLOAD,
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=spec.ROOT, timeout=120)
    assert got.returncode == 2 and got.stdout == ""
