"""The yardstick's arithmetic against hand counts, the trace reduction on
made-up events, and the lookup of a cell's files by name."""

from __future__ import annotations

import json
import math

import pytest

from benchmark import devtrace, flops, spec
from benchmark.reference.whisper import Shape

LARGE_V3 = Shape(n_mels=128, n_vocab=51866, d=1280, heads=20, enc_layers=32, dec_layers=32,
                 audio_ctx=1500, text_ctx=448)
H100 = flops.peaks("NVIDIA H100 80GB HBM3")


def test_encoder_flops_by_hand():
    # conv1: 3000 frames x 1280 outputs x (128 x 3) taps; conv2: 1500 x 1280 x 3840
    conv = 2 * 3000 * 1280 * 384 + 2 * 1500 * 1280 * 3840
    # a block: q k v o (4 d^2), MLP (8 d^2) per frame, then QK^T and PV
    block = 2 * 1500 * (4 * 1280 ** 2 + 8 * 1280 ** 2) + 2 * 2 * 1500 * 1500 * 1280
    assert flops.encoder_flops(LARGE_V3) == conv + 32 * block
    assert flops.encoder_flops(LARGE_V3) == pytest.approx(2.2738e12, rel=1e-4)


def test_decoder_flops_by_hand():
    d, V = 1280, 51866
    # two positions: 14 d^2 products (q k v o, cross q and out, MLP 8 d^2) and
    # cross-attention over 1500 frames
    # each, self-attention over 1 then 2 keys, logits at both
    per_layer = 2 * (2 * 14 * d * d + 4 * 1500 * d) + 4 * d * (1 + 2)
    assert flops.decoder_flops(LARGE_V3, 2) == 32 * per_layer + 2 * 2 * d * V
    cross = 32 * 2 * 2 * 1500 * d * d
    assert flops.cross_kv_flops(LARGE_V3) == cross
    # a window of 3 prompt tokens and 224 chosen: 226 positions are fed
    assert flops.window_flops(LARGE_V3, 3, 224) == (flops.encoder_flops(LARGE_V3) + cross
                                                     + flops.decoder_flops(LARGE_V3, 226))


def test_attention_bound_by_hand():
    # (64, 20, 1500, 64): 2 products of 2 T^2 Dh flops per head at 989e12
    secs, which = flops.attention_bound_s((64, 20, 1500, 64), H100)
    assert which == "operations"
    assert secs == pytest.approx(4 * 64 * 20 * 1500 ** 2 * 64 / 989e12)
    assert secs == pytest.approx(7.4548e-4, rel=1e-4)
    # a short sequence is bound by the bytes: q, k, v, out in bf16 at 3.35e12
    secs, which = flops.attention_bound_s((8, 20, 64, 64), H100)
    assert which == "bytes"
    assert secs == pytest.approx(4 * 8 * 20 * 64 * 64 * 2 / 3.35e12)


def test_peaks_refuse_an_unknown_card():
    with pytest.raises(KeyError):
        flops.peaks("cpu")


def test_trace_union_and_gaps():
    t = devtrace.DeviceTrace()
    t._marks = [1000, 2000]

    class Ev:
        def __init__(self, name, start, dur):
            self.n, self.s, self.d = name, start, dur

        def name(self):
            return self.n

        def start_ns(self):
            return self.s

        def duration_ns(self):
            return self.d

        def device_type(self):
            from torch.autograd import DeviceType
            return DeviceType.CUDA

    events = [Ev("a", 1100, 200), Ev("b", 1200, 300), Ev("flash_attn_fwd_ws", 1700, 100),
              Ev("c", 1950, 100)]

    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return events

    t._prof = Prof
    s = t.summary()
    # busy: [1100, 1500) + [1700, 1800) + [1950, 2000) = 550 ns of 1000
    assert s.window_s == pytest.approx(1e-6)
    assert s.busy_s == pytest.approx(550e-9)
    assert s.idle_gaps[0] == ["after b", pytest.approx(200e-9)]
    assert [g[1] for g in s.idle_gaps] == pytest.approx([200e-9, 150e-9, 100e-9])
    assert s.launches_of("flash_attn_fwd") == [pytest.approx(100e-9)]
    assert s.device_ops(2) == [["b", pytest.approx(300e-9)], ["a", pytest.approx(200e-9)]]
    # events stamped on another clock cannot be placed in the window
    t._marks = [10_000, 20_000]
    with pytest.raises(RuntimeError):
        t.summary()


def test_new_files_are_found_by_name(tmp_path):
    """A later cell, mix and metric are files and entries only."""
    here = tmp_path / "bench"
    for sub in ("configs", "traffic", "limits", "metrics"):
        (here / sub).mkdir(parents=True)
    (here / "configs" / "m.json").write_text(json.dumps({"d_model": 8}))
    (here / "traffic" / "mix.json").write_text(json.dumps({"generator": "window_backlog"}))
    (here / "limits" / "m.mix.json").write_text(json.dumps({"max_logit_gap": {"limit": 1}}))
    (here / "metrics" / "new.metric.py").write_text("def read(ctx):\n    return ctx.x * 2\n")
    (here / "metrics" / "quiet.py").write_text("def read(ctx):\n    return None\n")
    bench = {"configs": [{"name": "m", "file": "bench/configs/m.json"}],
             "workloads": [{"name": "m.mix", "config": "m", "traffic": "mix", "chips": 1}],
             "end_to_end": [{"name": "quiet", "unit": "s", "moves": None},
                            {"name": "other", "unit": "s", "workloads": ["x"]}],
             "per_layer": [{"name": "new.metric", "unit": "%", "moves": "quiet"},
                           {"name": "elsewhere", "unit": "%", "moves": "other"}]}
    c = spec.cell(bench, "m.mix", root=tmp_path, here=here)
    assert c.config == {"d_model": 8, "name": "m"}
    assert c.traffic["generator"] == "window_backlog"
    assert [m["name"] for m in c.end_to_end] == ["quiet"]
    assert [m["name"] for m in c.per_layer] == ["new.metric"]

    class Ctx:
        x = 21
    got = spec.read_all(c.per_layer + c.end_to_end, Ctx, here=here)
    assert got == {"new.metric": {"value": 42, "unit": "%"}}   # a reader with nothing is left out
    with pytest.raises(KeyError):
        spec.cell(bench, "m.other", root=tmp_path, here=here)


def test_benchmark_json_names_its_files():
    """Every cell's metrics have readers, and every entry of its limits
    file names a reading of its traffic's generator, with a finite limit."""
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    for w in bench["workloads"]:
        c = spec.cell(bench, w["name"])
        assert c.end_to_end and c.per_layer
        for m in c.end_to_end + c.per_layer:
            assert (spec.HERE / "metrics" / f"{m['name']}.py").is_file()
        gen = spec.generator(c.traffic["generator"])
        assert c.limits
        for name, entry in c.limits.items():
            assert entry["reading"] in gen.READINGS, (w["name"], name)
            assert math.isfinite(entry["limit"]), (w["name"], name)


def test_profiler_stretch_and_untraced_idle():
    """The traced batch against the window's other batches."""
    from types import SimpleNamespace

    from benchmark.generators.window_backlog import Served, untraced_batch_s

    # batch 1 opens the window at t = 10; batch 3 is traced (2 -> 3), and
    # 3 -> 4 pays the profiler's stop
    served = Served(t_open=10.0, t_close=56.0, windows=[], attempted=0, failed=0, answers={},
                    batch_of={}, batch_t={1: 10.0, 2: 20.0, 3: 32.0, 4: 47.0, 5: 57.0, 6: 66.0},
                    snaps={2: {}, 3: {}}, max_batch=64, trace_batches=(2, 3),
                    trace_tries=[(2, 3)], window_batches=[2, 3, 4, 5, 6])
    assert untraced_batch_s(served) == 10.0          # median of 10, 10 and 9
    ctx = SimpleNamespace(generator="window_backlog", served=served,
                          trace=devtrace.Summary(window_s=12.0, busy_s=8.0))
    assert spec.reader("profiler.stretch.batch")(ctx) == pytest.approx(120.0)
    assert spec.reader("device.idle_untraced.batch")(ctx) == pytest.approx(20.0)
    assert spec.reader("device.idle.batch")(ctx) == pytest.approx(100.0 / 3)
    # a first trace (2 -> 3) came out short; 4 -> 5 was traced and kept
    served.trace_batches, served.trace_tries = (4, 5), [(2, 3), (4, 5)]
    served.batch_t = {1: 10.0, 2: 20.0, 3: 32.0, 4: 47.0, 5: 57.0, 6: 66.0, 7: 75.0, 8: 83.0}
    served.window_batches = [2, 3, 4, 5, 6, 7, 8]
    assert untraced_batch_s(served) == 9.0           # median of 10, 9 and 8
    served.trace_batches, served.trace_tries = (2, 3), [(2, 3)]
    served.window_batches = [2, 3]                   # nothing but the traced batch
    assert untraced_batch_s(served) == 10.0
    served.batch_t, served.window_batches = {1: 10.0, 2: 20.0}, [2]
    served.trace_batches, served.trace_tries = (1, 2), [(1, 2)]
    assert untraced_batch_s(served) is None
    assert spec.reader("profiler.stretch.batch")(ctx) is None
