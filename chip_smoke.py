"""Chip smoke test for the PyTorch/CUDA port (speaksense_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py              # every phase
    python3 chip_smoke.py --phase kernel
    python3 chip_smoke.py --phase stream

It first compiles the hand-written CUDA kernels from the sources in the
tree, then runs its phases on one set of large-v3-width random weights:
  kernel  hold each kernel against its plain PyTorch version on the card at
          the shapes of the main paths (30 s windows and 5 s slot
          admissions), and time both with CUDA events;
  main    answer 8 concurrent transcribe requests through the window
          batcher of `speaksense_tpu_torch.main.build_engine`, check the
          results and the kernel launch counts, hold the full-depth encoder
          with the kernel against the plain attention, and time the encoder
          with f32 activations against one with bf16 activations;
  stream  drive the shared `StreamSession` from 64 threads over the port's
          64-slot pool (1 s packets, 5 s chunks, device denoise), then 8
          sessions with every fallback gate armed, and check admissions,
          retries, end events, kernel launches and the imports.

Any failure raises and the script exits non-zero. The last line of standard
output is the device JSON; the line before it lists the kernels.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import subprocess
import sys
import threading
import time


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# bf16 output of a softmax-weighted average of O(1) values: one bf16 ulp at
# magnitude 1 is 2^-8; the kernel rounds the unnormalised probabilities and
# the reference the normalised ones, and both round the output, so a few
# ulps of difference are expected
FLASH_ATOL = 2e-2


def phase_kernel(card: str) -> dict:
    import torch

    from speaksense_tpu_torch.ops import flash as F

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=g, device=dev, dtype=torch.float32).to(torch.bfloat16)

    worst = 0.0
    cases = [(8, 20, 1500, 64), (1, 2, 200, 64), (2, 3, 77, 64), (1, 1, 1, 64),
             (2, 4, 64, 64), (1, 2, 1536, 64)]
    for shape in cases:
        q, k, v = rand(*shape), rand(*shape), rand(*shape)
        out = F.flash_attention_full(q, k, v)
        ref = F.flash_attention_ref(q, k, v)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        assert torch.isfinite(out).all().item(), f"non-finite kernel output at {shape}"
        print(f"kernel flash_attn_fwd {shape}: max_abs_err {err:.3e} (bound {FLASH_ATOL})")
        assert err <= FLASH_ATOL, (shape, err)
        worst = max(worst, err)
    # strided views of a fused (B, T, 3*d) projection, as the encoder passes them
    B, T, H = 2, 300, 20
    d = H * 64
    qkv = rand(B, T, 3 * d)
    q, k, v = (qkv[..., i * d:(i + 1) * d].view(B, T, H, 64).transpose(1, 2) for i in range(3))
    out = F.flash_attention_full(q, k, v)
    ref = F.flash_attention_ref(q, k, v)
    err = (out.float() - ref.float()).abs().max().item()
    print(f"kernel flash_attn_fwd strided fused-qkv view {(B, H, T, 64)}: "
          f"max_abs_err {err:.3e} (bound {FLASH_ATOL})")
    assert err <= FLASH_ATOL, err
    worst = max(worst, err)

    # 30 s windows (the record's times) and the slot pool's admissions of
    # 1 and 8 windows of 5.12 s (t = 256)
    times = {}
    for shape in ((8, 20, 1500, 64), (1, 20, 256, 64), (8, 20, 256, 64)):
        q, k, v = rand(*shape), rand(*shape), rand(*shape)
        if shape[2] == 256:
            err = (F.flash_attention_full(q, k, v).float()
                   - F.flash_attention_ref(q, k, v).float()).abs().max().item()
            print(f"kernel flash_attn_fwd {shape}: max_abs_err {err:.3e} (bound {FLASH_ATOL})")
            assert err <= FLASH_ATOL, (shape, err)
            worst = max(worst, err)
        ms = _time_ms(lambda: F.flash_attention_full(q, k, v))
        plain_ms = _time_ms(lambda: F.flash_attention_ref(q, k, v))
        flops = 4 * shape[0] * shape[1] * shape[2] ** 2 * shape[3]
        print(f"kernel flash_attn_fwd {shape} bf16: {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s), plain PyTorch {plain_ms:.4f} ms [{card}]")
        times[shape] = (ms, plain_ms)
    ms, plain_ms = times[(8, 20, 1500, 64)]
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


# Encoder output at full depth, kernel vs plain attention: both runs carry
# an f32 residual through 32 layers and round q/k/v and the attention output
# to bf16, so one-ulp differences in the attention output (bf16 ulp 2^-8 at
# 1.0) reach the residual in every layer; 5% of the output's RMS leaves room
# for that and still catches a wrong kernel, which would decorrelate the two
# runs (relative error near 1.4).
ENC_REL_BOUND = 5e-2


def _speech(seconds: float, seed: int):
    """Seeded pseudo-speech at 16 kHz: voiced harmonics under a syllable-rate
    envelope plus noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000
    f0 = 110 + 20 * (seed % 8) + 30 * np.sin(2 * np.pi * 0.3 * t)
    voiced = sum(np.sin(2 * np.pi * k * np.cumsum(f0) / 16000) / k for k in range(1, 6))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * (3 + 0.2 * (seed % 8)) * t) ** 2
    return (0.2 * voiced * env + 0.02 * rng.standard_normal(t.size)).astype(np.float32)


def _encode_bf16_activations(model, mel):
    """The encoder as the port ran it before it carried f32 activations:
    bf16 mel, conv stem and residual stream. Kept only to time it against
    `W.encode` on the same weights."""
    import torch
    import torch.nn.functional as Fn

    from speaksense_tpu_torch.models import whisper as W

    enc = model.encoder

    def conv(x, c):
        y = Fn.conv1d(x.transpose(1, 2), c.weight, None, stride=c.stride, padding=1)
        return (y.transpose(1, 2).float() + c.bias).to(x.dtype)

    with torch.no_grad():
        x = mel.to(model.dtype)
        x = W._gelu(conv(x, enc.conv1))
        x = W._gelu(conv(x, enc.conv2))
        x = x + enc.pos[:x.shape[1]]
        for blk in enc.blocks:
            q, k, v = W._qkv_proj(W._ln(x, blk.attn_ln), blk, model.dims.n_audio_head)
            x = x + W._linear(W._merge_heads(W.flash_attention_full(q, k, v)), blk.o)
            x = W._mlp(x, blk)
        return W._ln(x, enc.ln_post)


def _count_encodes(W):
    """Wrap W.encode to count its calls; returns (counter, restore)."""
    n = [0]
    real = W.encode

    def counting_encode(*a, **kw):
        n[0] += 1
        return real(*a, **kw)

    W.encode = counting_encode

    def restore():
        W.encode = real

    return n, restore


def phase_main(card: str, engine, n_requests: int = 8) -> int:
    """Drive the port's window path: BatchedEngine.transcribe from
    n_requests threads, as the REST task workers call it."""
    import torch

    from speaksense_tpu.asr import AsrParams, TranscribeResult
    from speaksense_tpu_torch.models import whisper as W
    from speaksense_tpu_torch.ops import flash as F

    dims = engine.engine.dims
    audios = [_speech(30 + 2 * i, seed=i) for i in range(n_requests)]

    batch_sizes: list[int] = []
    real_decode_windows = engine.engine.decode_windows

    def recording_decode_windows(mels, *a, **kw):
        batch_sizes.append(int(mels.shape[0]))
        return real_decode_windows(mels, *a, **kw)

    engine.engine.decode_windows = recording_decode_windows
    results: list = [None] * n_requests
    errors: list = []
    barrier = threading.Barrier(n_requests)

    def worker(i: int) -> None:
        try:
            barrier.wait()
            results[i] = engine.transcribe(audios[i], AsrParams(language="en"))
        except BaseException as e:  # re-raised below, after every thread ends
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n_requests)]
    torch.cuda.reset_peak_memory_stats()
    windows0 = engine.windows_run
    n_encode, restore = _count_encodes(W)
    F.flash_attention_full.launches = 0
    t0 = time.perf_counter()
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        torch.cuda.synchronize()
    finally:
        wall = time.perf_counter() - t0
        launches = F.flash_attention_full.launches
        restore()
        del engine.engine.decode_windows
    if errors:
        raise errors[0]
    peak = torch.cuda.max_memory_allocated()

    for i, r in enumerate(results):
        assert isinstance(r, TranscribeResult), (i, type(r))
        assert r.language == "en", (i, r.language)
        dur = audios[i].size / 16000
        assert all(0.0 <= s.start <= s.end <= dur + 1e-6 for s in r.segments), i
    tokens = sum(r.n_tokens for r in results)
    windows = engine.windows_run - windows0
    assert windows > n_requests, f"no request spanned two windows ({windows} windows)"
    assert max(batch_sizes) == engine.max_batch == 8, batch_sizes
    assert n_encode[0] >= 1 and launches == dims.n_audio_layer * n_encode[0], (
        launches, n_encode[0])
    print(f"main: {n_requests} concurrent transcribe requests ({sum(a.size for a in audios) / 16000:.0f} s "
          f"of audio) in {wall:.2f} s; {windows} windows, "
          f"{len(batch_sizes)} decode_windows calls of sizes {batch_sizes}; "
          f"{n_encode[0]} encoder calls, {launches} flash kernel launches; {tokens} tokens; "
          f"peak memory {peak / 2**30:.2f} GiB [{card}]")
    for i, r in enumerate(results[:2]):
        print(f"main: request {i}: {len(r.segments)} segments, {r.n_tokens} tokens, "
              f"text {r.full_text[:60]!r}")

    # one window's encoder output at full depth, kernel vs plain attention
    model = engine.engine.model
    mel = engine.engine.compute_mel(audios[0][:16000 * 30])
    enc = W.encode(model, mel)
    W.flash_attention_full = F.flash_attention_ref
    try:
        enc_ref = W.encode(model, mel)
    finally:
        W.flash_attention_full = F.flash_attention_full
    assert enc.shape == (1, dims.n_audio_ctx, dims.n_audio_state), enc.shape
    assert enc.dtype == torch.float32, enc.dtype
    assert torch.isfinite(enc).all().item(), "non-finite encoder output"
    diff = (enc.float() - enc_ref.float())
    rel = (diff.norm() / enc_ref.float().norm()).item()
    print(f"main: encoder output (1, {dims.n_audio_ctx}, {dims.n_audio_state}) kernel vs plain "
          f"attention: max_abs_err {diff.abs().max().item():.3e}, relative L2 {rel:.3e} "
          f"(bound {ENC_REL_BOUND})")
    assert rel <= ENC_REL_BOUND, rel

    # encode time at (8, 3000): f32 activations against bf16 activations
    mel8 = engine.engine.compute_mel(torch.stack(
        [torch.from_numpy(a[:16000 * 30]) for a in audios]).numpy())
    f32_ms = _time_ms(lambda: W.encode(model, mel8), iters=5, warmup=2)
    bf16_ms = _time_ms(lambda: _encode_bf16_activations(model, mel8), iters=5, warmup=2)
    f32_ms_2 = _time_ms(lambda: W.encode(model, mel8), iters=5, warmup=1)
    print(f"main: encode (8, 3000) f32 activations {f32_ms:.2f} / {f32_ms_2:.2f} ms, "
          f"bf16 activations {bf16_ms:.2f} ms [{card}]")
    return launches


class _ErrorRecords(logging.Handler):
    """Collects ERROR records: StreamSession only logs the failures of a
    submission or a settle, so the stream phase fails on any of them."""

    def __init__(self):
        super().__init__(level=logging.ERROR)
        self.records: list[logging.LogRecord] = []

    def emit(self, record: logging.LogRecord) -> None:
        self.records.append(record)


def _run_sessions(engine, n_sessions: int, seconds: float):
    """n_sessions StreamSession threads, each ingesting `seconds` of seeded
    pseudo-speech as 1 s base64 s16 packets, then settling every chunk in
    order, then finishing. Returns (wall seconds, per-chunk latencies from
    the ingest that submitted a chunk to its settle, events per session)."""
    import base64

    import numpy as np

    from speaksense_tpu.serving.stream import StreamSession

    packets = []
    for i in range(n_sessions):
        pcm = np.clip(_speech(seconds, seed=i) * 32767, -32768, 32767).astype(np.int16)
        packets.append([base64.standard_b64encode(pcm[j:j + 16000].tobytes())
                        for j in range(0, pcm.size, 16000)])
    events: list = [None] * n_sessions
    latencies: list[float] = []
    errors: list = []
    lock = threading.Lock()
    barrier = threading.Barrier(n_sessions)

    def worker(i: int) -> None:
        try:
            session = StreamSession(engine, language="en", denoise=True)
            barrier.wait()
            pending = []
            for pkt in packets[i]:
                t = time.perf_counter()
                pending += [(t, p) for p in session.ingest(pkt)]
            evs, lat = [], []
            for t, p in pending:
                evs += session.settle(p)
                lat.append(time.perf_counter() - t)
            evs += session.finish()
            with lock:
                latencies.extend(lat)
            events[i] = evs
        except BaseException as e:  # re-raised below, after every thread ends
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n_sessions)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return wall, latencies, events


def phase_stream(card: str, engine) -> int:
    """Drive the port's streaming path: StreamSession over the pooled
    BatchedEngine, a load run with the ladder neutralized and a run with
    every fallback gate armed."""
    import numpy as np
    import torch

    from speaksense_tpu.utils.metrics import REGISTRY as METRICS
    from speaksense_tpu_torch.models import whisper as W
    from speaksense_tpu_torch.ops import flash as F
    from speaksense_tpu_torch.runtime.slots import _StreamJob

    inner = engine.engine
    server = inner._slot_server
    pool = server.pool
    dims = inner.dims
    assert (pool.S, pool.t_mel, pool.max_new, pool.max_prompt) == (64, 512, 96, 16), (
        pool.S, pool.t_mel, pool.max_new, pool.max_prompt)
    assert inner.model.dtype == torch.bfloat16 and engine.device_denoise
    errors = _ErrorRecords()
    loggers = [logging.getLogger(n) for n in ("speaksense_tpu.serving.stream",
                                              "speaksense_tpu_torch")]
    for lg in loggers:
        lg.addHandler(errors)
    base_cfg = inner.config
    step_times: list[float] = []
    real_step = pool.step

    def timed_step():
        t = time.perf_counter()
        out = real_step()   # ends in the retirement copy, which waits for the device
        step_times.append(time.perf_counter() - t)
        return out

    pool.step = timed_step

    def counter(name):
        return METRICS.snapshot()["counters"].get(name, 0.0)

    def run(n_sessions, **thresholds):
        inner.config = dataclasses.replace(base_cfg, **thresholds)
        before = (pool.admit_calls, pool.admit_rows, pool.step_calls, pool.occupancy_sum,
                  counter("asr_pool_fallback_retries_total"))
        step_times.clear()
        torch.cuda.reset_peak_memory_stats()
        n_encode, restore = _count_encodes(W)
        F.flash_attention_full.launches = 0
        try:
            wall, lat, events = _run_sessions(engine, n_sessions, 10.0)
            torch.cuda.synchronize()
        finally:
            launches = F.flash_attention_full.launches
            restore()
        after = (pool.admit_calls, pool.admit_rows, pool.step_calls, pool.occupancy_sum,
                 counter("asr_pool_fallback_retries_total"))
        d = [a - b for a, b in zip(after, before)]
        assert server._dead is None and server._thread.is_alive(), server._dead
        for i, evs in enumerate(events):
            assert evs and evs[-1].end == 1 and sum(e.end for e in evs) == 1, (i, evs)
        assert n_encode[0] == d[0] and launches == dims.n_audio_layer * n_encode[0], (
            launches, n_encode[0], d[0])
        return dict(wall=wall, lat=lat, events=events, admit_calls=d[0], admit_rows=d[1],
                    steps=d[2], occupancy=d[3], retries=d[4], launches=launches,
                    encodes=n_encode[0], peak=torch.cuda.max_memory_allocated(),
                    step_ms=1e3 * float(np.mean(step_times)))

    def report(name, r):
        p50, p95 = np.percentile(r["lat"], [50, 95])
        print(f"stream {name}: wall {r['wall']:.2f} s; chunk latency p50 {p50:.3f} s, "
              f"p95 {p95:.3f} s ({len(r['lat'])} chunks); {r['admit_rows']} rows in "
              f"{r['admit_calls']} admissions; {r['steps']} pool steps at "
              f"{r['step_ms']:.2f} ms per step (host clock, with the retirement copy), "
              f"mean occupancy {r['occupancy'] / max(r['steps'], 1):.2f} of {pool.S}; "
              f"{r['retries']:.0f} pool retries; {r['encodes']} admission encodes, "
              f"{r['launches']} flash kernel launches; peak memory "
              f"{r['peak'] / 2**30:.2f} GiB [{card}]")

    try:
        # load: 64 sessions x 10 s = 2 chunks of 5 s and a 1 s tail each,
        # every chunk one greedy pool job
        load = run(64, logprob_thold=-1e9, entropy_thold=-1.0, compression_ratio_thold=1e9)
        report("load", load)
        assert load["admit_rows"] == 64 * 3, load["admit_rows"]
        assert load["retries"] == 0, load["retries"]

        # ladder: 8 sessions, every gate armed: 24 chunks x 5 rungs x best_of 5
        final_temps: list[float] = []
        real_gate = inner._pool_quality_gate

        def recording_gate(raw, retry):
            cand = real_gate(raw, retry)
            final_temps.append(cand["temperature"])
            return cand

        inner._pool_quality_gate = recording_gate
        try:
            ladder = run(8, logprob_thold=1e9, no_speech_thold=1.0, best_of=5)
        finally:
            del inner._pool_quality_gate
        report("ladder", ladder)
        assert ladder["retries"] == 24 * 5, ladder["retries"]
        assert ladder["admit_rows"] == 24 * (1 + 5 * 5), ladder["admit_rows"]
        assert final_temps == [1.0] * 24, final_temps
    finally:
        inner.config = base_cfg
        del pool.step
        for lg in loggers:
            lg.removeHandler(errors)
    assert not errors.records, [r.getMessage() for r in errors.records]

    # the pool alone, with the server stopped: admissions of 8 windows of
    # 5.12 s (device denoise, mel, encode, cross-KV, prefill) until all 64
    # slots are full, then full-occupancy steps, each timed to a synchronize
    server.stop()
    pool.reset()
    pcm = [(np.clip(_speech(5.12, seed=i), -1, 1) * 32767).astype(np.int16)
           for i in range(8)]
    prompt = list(inner.tokenizer.sot_sequence("en"))
    admit_ms = []
    for _ in range(pool.S // 8):
        jobs = [_StreamJob(p, prompt, is_audio=True, denoise="spectral") for p in pcm]
        torch.cuda.synchronize()
        t = time.perf_counter()
        assert pool.admit_many(jobs) == 8
        torch.cuda.synchronize()
        admit_ms.append(1e3 * (time.perf_counter() - t))
    assert pool.n_active == pool.S
    occ0 = pool.occupancy_sum
    step_ms = []
    for _ in range(20):
        t = time.perf_counter()
        pool.step()
        step_ms.append(1e3 * (time.perf_counter() - t))
    occupancy = (pool.occupancy_sum - occ0) / len(step_ms)
    busy = _device_busy_ms(pool, 10)
    busy_text = ("device busy not measured (the profiler saw no device time)" if busy is None
                 else f"device busy {busy:.2f} ms per step, idle "
                      f"{100 * (1 - busy / np.median(step_ms)):.0f}% of the median step")
    print(f"stream pool: admission of 8 windows {np.mean(admit_ms):.2f} ms "
          f"(median {np.median(admit_ms):.2f}); step at a mean {occupancy:.1f} of {pool.S} "
          f"slots {np.mean(step_ms):.2f} ms (median {np.median(step_ms):.2f}); {busy_text} "
          f"[{card}]")
    pool.reset()

    leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
    assert not leaked, leaked
    return load["launches"] + ladder["launches"]


def _device_busy_ms(pool, n_steps: int) -> float | None:
    """Device time per full pool step: the kernels' own time (the
    profiler's "Self CUDA time total") over n_steps steps, traced with
    device activity only. None when the profiler saw no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(n_steps):
            pool.step()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    return busy / 1e3 / n_steps if busy > 0 else None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase", choices=("kernel", "main", "stream", "all"), default="all")
    args = ap.parse_args()

    import torch

    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the chip smoke test runs only on a GPU")
    card = _card()
    print(card)

    from speaksense_tpu.config import Config, EngineConfig
    from speaksense_tpu_torch.main import build_engine
    from speaksense_tpu_torch.ops import flash as F

    t0 = time.perf_counter()
    so = F.build()
    print(f"build: {so.name} in {time.perf_counter() - t0:.1f} s")
    log = so.with_suffix(".log")
    if log.is_file():
        print(log.read_text().strip())
    record = {"name": "flash_attn_fwd", "route": "cuda",
              "source": "speaksense_tpu_torch/ops/csrc/flash_attn_fwd.cu",
              "replaces": "speaksense_tpu/ops/flash.py:32",
              "launches": None, "max_abs_err": None, "ms": None, "plain_ms": None}
    if args.phase in ("kernel", "all"):
        record.update(phase_kernel(card))
    if args.phase != "kernel":
        config = Config()
        # max_new = max_decode_len // 2 = 96 tokens per window on the window
        # path; every other knob (bf16, max_batch_size 8, best_of 5,
        # thresholds, 64 stream slots) is the default
        config.engine = EngineConfig(max_decode_len=192)
        t0 = time.perf_counter()
        engine = build_engine(config, model="large-v3", device="cuda", seed=0,
                              max_wait_ms=50.0, slot_serving=True)
        torch.cuda.synchronize()
        print(f"engine: large-v3 random weights and a 64-slot pool on the card in "
              f"{time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
              f"[{card}]")
        record["launches"] = 0
        try:
            if args.phase in ("main", "all"):
                record["launches"] += phase_main(card, engine)
            if args.phase in ("stream", "all"):
                record["launches"] += phase_stream(card, engine)
        finally:
            engine.engine.disable_slot_serving()
            engine.stop()
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
