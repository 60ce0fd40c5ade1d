"""The reader of `decode.graph_share.batch` on a hand-made run: the share of
the traced stretch's decode steps that the program replayed from CUDA
graphs, and nothing where the program does not count them."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import spec
from benchmark.generators.window_backlog import Served


def _ctx(snaps: dict, generator: str = "window_backlog") -> SimpleNamespace:
    served = Served(t_open=10.0, t_close=40.0, windows=[], attempted=0, failed=0, answers={},
                    batch_of={}, batch_t={1: 10.0, 2: 13.0, 3: 16.0, 4: 19.0}, snaps=snaps,
                    max_batch=64, trace_batches=(2, 4), trace_tries=[(2, 4)],
                    window_batches=[2, 3, 4])
    return SimpleNamespace(generator=generator, served=served)


def test_graph_share_over_the_traced_stretch():
    read = spec.reader("decode.graph_share.batch")
    # batches 3 and 4: 448 steps, 446 of them replayed (each batch's last
    # step runs eagerly)
    snaps = {2: {"asr_decode_steps_total": 448.0, "asr_decode_graph_steps_total": 431.0},
             4: {"asr_decode_steps_total": 896.0, "asr_decode_graph_steps_total": 877.0}}
    assert read(_ctx(snaps)) == pytest.approx(100.0 * 446 / 448)
    # every step eager: zero, not missing
    snaps[4]["asr_decode_graph_steps_total"] = 431.0
    assert read(_ctx(snaps)) == 0.0
    # the counters first appear inside the stretch
    assert read(_ctx({2: {}, 4: {"asr_decode_steps_total": 224.0,
                                 "asr_decode_graph_steps_total": 223.0}})) == pytest.approx(
        100.0 * 223 / 224)


def test_graph_share_is_none_without_the_counters():
    read = spec.reader("decode.graph_share.batch")
    assert read(_ctx({2: {"windows_run": 64.0}, 4: {"windows_run": 192.0}})) is None
    assert read(_ctx({2: {}, 4: {"asr_decode_steps_total": 224.0}})) is None
    snaps = {2: {"asr_decode_steps_total": 448.0, "asr_decode_graph_steps_total": 0.0},
             4: {"asr_decode_steps_total": 448.0, "asr_decode_graph_steps_total": 0.0}}
    assert read(_ctx(snaps)) is None                  # no step in the stretch
    assert read(_ctx(snaps, generator="other")) is None
    no_trace = _ctx(snaps)
    no_trace.served.trace_batches = None
    assert read(no_trace) is None
