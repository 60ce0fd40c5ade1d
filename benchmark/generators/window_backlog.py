"""Long-form transcription tasks as REST and CLI users send them: a backlog
of 30 s windows through the window batcher.

Each of `tasks` concurrent tasks holds one recording and submits its
windows one after another, as `transcribe_audio` does with a fixed seek of
30 s: the window's log-mel by `engine.compute_mel`, then
`BatchedEngine.submit_window`, and the task's next window once the answer
is back. One client thread does this for every task; the batcher's
completion callbacks only queue the answers to it. With twice `max_batch`
tasks a full batch is always waiting when one ends, so the card sets the
pace.

The first batch warms up every shape the cell uses and ends set-up; the
window opens at its completion and closes at the last batch completed
within `seconds`. The rate is every window of the batches completed in
between over that time. A traced run traces the stretch between the next
two batch completions inside the window. Every batch encodes its windows,
so that trace holds kernel #1's launches; one without them lost the
batcher thread's kernels, and the stretch after the next is traced instead,
up to `TRACE_TRIES` stretches.

Parameters (the traffic file): tasks, language, clips, audio_rms and
level_spread (the recordings the windows are cut from and their levels,
`clip_bank`), check_windows (answers the plain reference checks after the
window; the longest is always among them).
"""

from __future__ import annotations

import concurrent.futures as cf
import math
import queue
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from benchmark import program as P
from benchmark.reference import whisper as R

WINDOW_SAMPLES = 30 * R.SAMPLE_RATE
STALL_S = 600.0
TRACE_HOLDS = "flash_attn_fwd"   # kernel #1, launched by every batch's encode
TRACE_TRIES = 3


def clip_bank(seed: int, traffic: dict, device) -> np.ndarray:
    """`clips` distinct 30 s recordings, made on `device` from the seed in a
    few large calls: noise under a random spectral envelope (24 knots of
    log-gain over the band) and a random loudness contour (a knot every
    half second, down to near silence), each at its own level around
    `audio_rms` (log-normal, sigma `level_spread`). Each row holds its
    recording twice over, (clips, 2 x samples) float32, so that a window
    starting anywhere in it is a view."""
    n, size = traffic["clips"], WINDOW_SAMPLES
    g = torch.Generator(device=device).manual_seed((seed ^ 0x5EED) & (2 ** 63 - 1))
    noise = torch.randn(n, size, generator=g, device=device)
    knots = torch.randn(n, 1, 24, generator=g, device=device) * 1.5
    shape = torch.nn.functional.interpolate(knots, size=size // 2 + 1, mode="linear",
                                            align_corners=True)[:, 0]
    audio = torch.fft.irfft(torch.fft.rfft(noise) * torch.exp(shape), n=size)
    del noise
    contour = torch.rand(n, 1, 61, generator=g, device=device)
    audio *= torch.nn.functional.interpolate(torch.exp(5.0 * (contour - 1.0)), size=size,
                                             mode="linear", align_corners=True)[:, 0]
    level = traffic["audio_rms"] * torch.exp(
        traffic["level_spread"] * torch.randn(n, 1, generator=g, device=device))
    audio *= level / audio.square().mean(dim=1, keepdim=True).sqrt()
    return torch.cat([audio, audio], dim=1).cpu().numpy()


def window_audio(bank: np.ndarray, seed: int, task: int, index: int) -> np.ndarray:
    """The index-th 30 s window of task `task`'s recording: one of the
    bank's recordings from a random offset on (a view, no copy), the same
    for the same (seed, task, index)."""
    rng = np.random.default_rng([seed % 2 ** 64, task, index])
    row, start = int(rng.integers(len(bank))), int(rng.integers(WINDOW_SAMPLES))
    return bank[row, start:start + WINDOW_SAMPLES]


@dataclass
class Served:
    """What a run of the backlog leaves for the metrics and the check."""

    t_open: float
    t_close: float
    windows: list            # (task, index) answered in the window
    attempted: int
    failed: int
    answers: dict            # (task, index) -> the program's answer
    batch_of: dict           # (task, index) -> the batch that answered it
    batch_t: dict            # batch number -> host time of its completion
    snaps: dict              # batch number -> program counters at completion
    max_batch: int
    trace_batches: tuple | None = None   # (first, last) batch of the traced stretch kept
    trace_tries: list = field(default_factory=list)   # every traced stretch, that one among them
    window_batches: list = field(default_factory=list)

    bank: np.ndarray | None = None       # the recordings the windows were cut from

    @property
    def seconds(self) -> float:
        return self.t_close - self.t_open

    def timeline(self) -> dict:
        """Batch completions in seconds after the window opened, the batches
        inside the window and the traced ones."""
        return {"batches": {b: round(t - self.t_open, 4) for b, t in sorted(self.batch_t.items())},
                "window_batches": self.window_batches, "trace_batches": self.trace_batches,
                "trace_tries": self.trace_tries}


def holds_the_batch(tracer) -> bool:
    """Whether the last traced stretch recorded the batcher thread's
    kernels: kernel #1's launches are among its device events."""
    s = tracer.summary()
    return s is not None and bool(s.launches_of(TRACE_HOLDS))


def emitted(answer: dict, max_new: int) -> int:
    """Tokens the decode chose: every sampled one, and end-of-text when it
    came before the cap."""
    n = int(answer["n_sampled"])
    return min(n + 1, max_new)


def serve(engine, traffic: dict, seed: int, seconds: float, tracer=None) -> Served:
    from speaksense_tpu_torch.runtime.batcher import BatchedEngine

    bank = clip_bank(seed, traffic, engine.device)
    serving = BatchedEngine(engine)
    events: queue.Queue = queue.Queue()
    futures: dict = {}
    snaps: dict = {}
    lang = traffic["language"]

    def on_done(key, fut):
        batch = serving.batches_run
        if fut.exception() is None and batch not in snaps:
            snaps[batch] = {**P.counters(), "batches_run": serving.batches_run,
                            "windows_run": serving.windows_run}
        events.put((key, time.perf_counter(), batch, fut))

    def mel(task, index):
        return engine.compute_mel(window_audio(bank, seed, task, index))[0]

    def submit(task, index, m=None):
        fut = serving.submit_window(mel(task, index) if m is None else m, lang, "transcribe",
                                    False)
        futures[(task, index)] = fut
        fut.add_done_callback(lambda f, key=(task, index): on_done(key, f))

    try:
        first = [mel(t, 0) for t in range(traffic["tasks"])]
        for t, m in enumerate(first):
            submit(t, 0, m)
        del first
        done: dict = {}
        batch_t: dict = {}
        t_open = deadline = None
        open_batch = None
        trace_from = trace_to = None
        tries: list = []
        while True:
            now = time.perf_counter()
            if deadline is not None and now >= deadline:
                break
            wait = STALL_S if deadline is None else min(STALL_S, deadline - now)
            try:
                key, t, batch, fut = events.get(timeout=wait)
            except queue.Empty:
                if deadline is None:
                    raise TimeoutError(f"no window answered in {STALL_S:.0f} s") from None
                continue
            done[key] = (t, batch, fut)
            if fut.exception() is not None:
                continue
            batch_t.setdefault(batch, t)
            if t_open is None:
                t_open, open_batch = t, batch
                deadline = t_open + seconds
            if tracer is not None and trace_to is None and len(tries) < TRACE_TRIES:
                if tracer.running:
                    if batch > trace_from:
                        tracer.stop()
                        tries.append((trace_from, batch))
                        kept = holds_the_batch(tracer)
                        print(f"trace of batches {trace_from} -> {batch}: {tracer.info}, "
                              f"{'kept' if kept else 'no ' + TRACE_HOLDS + ' launch'}",
                              file=sys.stderr)
                        if kept:
                            trace_to = batch
                elif batch > (tries[-1][1] if tries else open_batch):
                    tracer.start()
                    trace_from = batch
            submit(key[0], key[1] + 1)
        if tracer is not None and tracer.running:
            tracer.stop()
    finally:
        serving.stop()
        cf.wait(list(futures.values()), timeout=STALL_S)
    t_end = time.perf_counter() + 60.0
    while len(done) < len(futures) and time.perf_counter() < t_end:
        try:
            key, t, batch, fut = events.get(timeout=1.0)
        except queue.Empty:
            continue
        done[key] = (t, batch, fut)
        if fut.exception() is None:
            batch_t.setdefault(batch, t)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)

    in_window = [b for b, t in sorted(batch_t.items()) if b > open_batch and t <= deadline]
    if not in_window:
        raise RuntimeError(f"no batch completed within {seconds} s after the first: "
                           "the window is too short for this cell")
    t_close = batch_t[in_window[-1]]
    windows = sorted(k for k, (t, b, f) in done.items()
                     if f.exception() is None and b in in_window)
    failures = [k for k, (t, b, f) in done.items()
                if f.exception() is not None and t_open < t <= t_close]
    answers = {k: done[k][2].result() for k in windows}
    return Served(t_open=t_open, t_close=t_close, windows=windows,
                  attempted=len(windows) + len(failures), failed=len(failures),
                  answers=answers, batch_of={k: done[k][1] for k in windows},
                  batch_t=batch_t, snaps=snaps, max_batch=serving.max_batch,
                  trace_batches=(trace_from, trace_to) if trace_to is not None else None,
                  trace_tries=tries, window_batches=in_window, bank=bank)


def sample(served: Served, seed: int, n: int, max_new: int) -> list:
    """n answered windows drawn from the seed, the longest among them."""
    rng = np.random.default_rng([seed % 2 ** 64, 0x5A])
    order = [served.windows[i] for i in rng.permutation(len(served.windows))]
    longest = max(order, key=lambda k: emitted(served.answers[k], max_new))
    rest = [k for k in order if k != longest]
    return [longest] + rest[:n - 1]


CONTROLS = ("control", "control.encoder")


def _row(gap: torch.Tensor, no_speech_diff: float) -> dict:
    g = gap.double()
    return {"tokens": g.numel(), "max": float(g.max()), "sum": float(g.sum()),
            "ns": no_speech_diff}


def summarize(rows: list) -> dict:
    """The check's readings over the windows it ran: `gap`, the widest gap
    in nats by which a served token lies below the reference's best;
    `mean_gap`, the gaps' mean over every served token; `no_speech_diff`,
    the widest difference between a window's no-speech log-probability
    and the reference's."""
    n = sum(r["tokens"] for r in rows)
    return {"gap": max((r["max"] for r in rows), default=0.0),
            "mean_gap": sum(r["sum"] for r in rows) / max(n, 1),
            "no_speech_diff": max((r["ns"] for r in rows), default=0.0),
            "tokens": n, "windows": len(rows)}


def check(served: Served, cfg: dict, traffic: dict, seed: int, device, weights: dict,
          controls: tuple = ()) -> dict:
    """The sampled windows' prompts and served tokens run once through the
    plain reference: {"program": readings (`summarize`)}. Each name in
    `controls` adds the same readings of the reference one precision step
    down put in the program's place, read at the same prompts and tokens
    (the gaps of the tokens it puts first at each position, and its
    no-speech log-probability): "control" lowers the encoder and the
    decoder (`lower=True`; keys and values at 4 bits where the
    configuration holds them in int8), "control.encoder" the encoder
    alone."""
    s = R.Shape.from_config(cfg)
    dec = cfg["decoding"]
    vocab = R.Vocab.multilingual(s.n_vocab, blank=dec.get("blank_token"))
    max_new = dec["max_new_tokens"]
    max_initial = round(dec["max_initial_timestamp_s"] / 0.02)
    prompt = vocab.prompt(dec["language_index"])
    kv_bits = {"self_bits": 4 if cfg["engine"].get("self_kv_int8") else None,
               "cross_bits": 4 if cfg["engine"].get("cross_kv_int8") else None}
    rows: dict = {name: [] for name in ("program",) + tuple(controls)}
    keys = sample(served, seed, traffic["check_windows"], max_new)
    with torch.no_grad():
        for key in keys:
            answer = served.answers[key]
            n = emitted(answer, max_new)
            tokens = [int(t) for t in answer["tokens"][:n]]
            audio = torch.from_numpy(window_audio(served.bank, seed, *key)).to(device)
            mel = R.log_mel(audio, s.n_mels)
            enc = R.encode(weights, mel, s)
            fed = prompt + tokens[:-1]
            logits = R.decoder_logits(weights, enc, fed, s)
            lp = R.history_logprobs(logits[len(prompt) - 1:], tokens, vocab, max_initial)
            ref_ns = R.no_speech_logprob(logits, vocab)
            ns = math.log(max(float(answer["no_speech_prob"]), 1e-300))
            rows["program"].append(_row(R.gaps(lp, tokens, vocab), abs(ns - ref_ns)))
            low_enc = R.encode(weights, mel, s, lower=True) if controls else None
            for name in controls:
                low = R.decoder_logits(weights, low_enc, fed, s, lower=name == "control",
                                       **kv_bits)
                low_lp = R.history_logprobs(low[len(prompt) - 1:], tokens, vocab, max_initial)
                rows[name].append(_row(R.gaps(lp, R.choices(low_lp, vocab), vocab),
                                       abs(R.no_speech_logprob(low, vocab) - ref_ns)))
    return {name: summarize(r) for name, r in rows.items()}


def traced_stretch(served: Served):
    """(counters at its start, counters at its end, host seconds, windows
    answered by its last batch, which ran inside it) of the traced stretch,
    or None where the run traced none."""
    if served.trace_batches is None:
        return None
    a, b = served.trace_batches
    if a not in served.snaps or b not in served.snaps:
        return None
    windows = [k for k, batch in served.batch_of.items() if batch == b]
    return served.snaps[a], served.snaps[b], served.batch_t[b] - served.batch_t[a], windows


def untraced_batch_s(served: Served) -> float | None:
    """The median host seconds between two batch completions inside the
    window, every traced stretch and the one after each (which pays the
    profiler's stop) left out: what a batch takes without the profiler.
    None where the run kept no trace or the window holds no other batch."""
    if served.trace_batches is None:
        return None
    order = sorted(b for b, t in served.batch_t.items() if t == served.t_open)
    order += served.window_batches
    traced_ends = {end for _, end in served.trace_tries}
    spans = [served.batch_t[b] - served.batch_t[a] for a, b in zip(order, order[1:])
             if a not in traced_ends and b not in traced_ends]
    if not spans:
        return None
    spans.sort()
    mid = len(spans) // 2
    return spans[mid] if len(spans) % 2 else (spans[mid - 1] + spans[mid]) / 2
