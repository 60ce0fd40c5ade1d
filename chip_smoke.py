"""Chip smoke test for the PyTorch/CUDA port (speaksense_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py              # every phase
    python3 chip_smoke.py --phase kernel    # or main, stream, ckpt

It first compiles the hand-written CUDA kernels from the sources in the
tree, then runs its phases; main and stream share one set of
large-v3-width random weights:
  kernel  hold each kernel against its plain PyTorch version on the card at
          the shapes of the main paths (30 s windows and 5 s slot
          admissions), time both and the one PyTorch call that computes the
          same function (`scaled_dot_product_attention`, a yardstick never
          on the path) with CUDA events, and print each shape's bound;
  main    answer 4 concurrent transcribe requests through the window
          batcher of `speaksense_tpu_torch.main.build_engine`, check the
          results and the kernel launch counts, hold the full-depth encoder
          with the kernel against the plain attention, and time the encoder
          with f32 activations against one with bf16 activations;
  stream  drive the port's `StreamSession` from 64 threads over the 64-slot
          pool (1 s packets, 5 s chunks, device denoise), then 8 sessions
          with every fallback gate armed, and check admissions, retries,
          end events and kernel launches;
  ckpt    write a full-width large-v3 f16 ggml checkpoint from seeded
          weights into a temporary directory (about 3.1 GB, and a 6.2 GB
          weight cache beside it), load it cold through `build_engine` and
          warm from the cache, hold every parameter against the source
          weights after the same f16 round trip, serve 8 concurrent 30 s
          windows and 8 stream sessions on it, and run the port's CLI on it.

The script imports nothing of jax or of the JAX package, and checks that no
such module was loaded. Any failure raises and the script exits non-zero.
The last line of standard output is the device JSON; the line before it
lists the kernels.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import logging
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# the H100 SXM's published dense bf16 rate and HBM bandwidth (the bound's
# denominators; the card's power limit is printed beside every time)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


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
    by_shape = {}
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
        sdpa_ms = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v))
        bound_ms, bound_by = _attention_bound_ms(shape)
        flops = 4 * shape[0] * shape[1] * shape[2] ** 2 * shape[3]
        print(f"kernel flash_attn_fwd {shape} bf16: {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s), plain PyTorch {plain_ms:.4f} ms, "
              f"scaled_dot_product_attention {sdpa_ms:.4f} ms; bound {bound_ms:.4f} ms "
              f"({bound_by}), the kernel at {100 * bound_ms / ms:.1f}% of it [{card}]")
        by_shape["x".join(map(str, shape))] = dict(ms=ms, plain_ms=plain_ms, sdpa_ms=sdpa_ms,
                                                   bound_ms=bound_ms, bound_by=bound_by)
    head = by_shape["8x20x1500x64"]
    return {"max_abs_err": worst, "ms": head["ms"], "plain_ms": head["plain_ms"],
            "library_ms": head["sdpa_ms"], "sdpa_ms": head["sdpa_ms"], "by_shape": by_shape}


def _attention_bound_ms(shape) -> tuple[float, str]:
    """The least time of one bf16 attention call on the card: the larger of
    its operations (4·B·H·T²·Dh for QKᵀ and PV) at the dense bf16 rate and
    its bytes (q, k and v read once, the output written once) at the HBM
    rate."""
    B, H, T, Dh = shape
    by_ops = 4 * B * H * T * T * Dh / PEAK_BF16_FLOPS
    by_bytes = 4 * B * H * T * Dh * 2 / PEAK_BYTES_PER_S
    return 1e3 * max(by_ops, by_bytes), ("operations" if by_ops >= by_bytes else "bytes")


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


def _transcribe_concurrently(engine, audios):
    """engine.transcribe of each audio (language "en") from its own thread,
    all started together, as the REST task workers call it. Returns the
    results and the wall seconds, and fails on any request's error or a
    result that is not a TranscribeResult with segments inside its audio."""
    import torch

    from speaksense_tpu_torch.asr import AsrParams, TranscribeResult

    results: list = [None] * len(audios)
    errors: list = []
    barrier = threading.Barrier(len(audios))

    def worker(i: int) -> None:
        try:
            barrier.wait()
            results[i] = engine.transcribe(audios[i], AsrParams(language="en"))
        except BaseException as e:  # re-raised below, after every thread ends
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(audios))]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    for i, r in enumerate(results):
        assert isinstance(r, TranscribeResult), (i, type(r))
        assert r.language == "en", (i, r.language)
        dur = audios[i].size / 16000
        assert all(0.0 <= s.start <= s.end <= dur + 1e-6 for s in r.segments), i
    return results, wall


def phase_main(card: str, engine, n_requests: int = 4) -> int:
    """Drive the port's window path: BatchedEngine.transcribe from
    n_requests threads, as the REST task workers call it."""
    import numpy as np
    import torch

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
    torch.cuda.reset_peak_memory_stats()
    windows0 = engine.windows_run
    n_encode, restore = _count_encodes(W)
    F.flash_attention_full.launches = 0
    try:
        results, wall = _transcribe_concurrently(engine, audios)
    finally:
        launches = F.flash_attention_full.launches
        restore()
        del engine.engine.decode_windows
    peak = torch.cuda.max_memory_allocated()

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
    mel8 = engine.engine.compute_mel(np.stack([_speech(30, seed=i) for i in range(8)]))
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

    from speaksense_tpu_torch.serving.stream import StreamSession

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
    """Drive the port's streaming path: the port's StreamSession over the
    pooled BatchedEngine, a load run with the ladder neutralized and a run
    with every fallback gate armed."""
    import numpy as np
    import torch

    from speaksense_tpu_torch.utils.metrics import REGISTRY as METRICS
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
    loggers = [logging.getLogger("speaksense_tpu_torch")]
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


def _seeded_ggml_tensors(dims, seed: int):
    """(name, f32 array) of every tensor of a whisper checkpoint of `dims`,
    in whisper.cpp's names, order and (out, in) layout, each drawn from its
    own seeded generator so the set can be drawn again for the check:
    weights at 1/sqrt(fan-in), embeddings at 0.02, layer-norm gains near 1
    and small biases."""
    import numpy as np

    d, dt = dims.n_audio_state, dims.n_text_state
    specs = [("encoder.conv1.weight", (d, dims.n_mels, 3)), ("encoder.conv1.bias", (d,)),
             ("encoder.conv2.weight", (d, d, 3)), ("encoder.conv2.bias", (d,)),
             ("encoder.positional_embedding", (dims.n_audio_ctx, d))]

    def block(pre, width, cross):
        out = [(f"{pre}.attn_ln.weight", (width,)), (f"{pre}.attn_ln.bias", (width,))]
        for attn in ("attn", "cross_attn") if cross else ("attn",):
            if attn == "cross_attn":
                out += [(f"{pre}.cross_attn_ln.weight", (width,)),
                        (f"{pre}.cross_attn_ln.bias", (width,))]
            for proj in ("query", "key", "value", "out"):
                out.append((f"{pre}.{attn}.{proj}.weight", (width, width)))
                if proj != "key":
                    out.append((f"{pre}.{attn}.{proj}.bias", (width,)))
        return out + [(f"{pre}.mlp_ln.weight", (width,)), (f"{pre}.mlp_ln.bias", (width,)),
                      (f"{pre}.mlp.0.weight", (4 * width, width)), (f"{pre}.mlp.0.bias", (4 * width,)),
                      (f"{pre}.mlp.2.weight", (width, 4 * width)), (f"{pre}.mlp.2.bias", (width,))]

    for i in range(dims.n_audio_layer):
        specs += block(f"encoder.blocks.{i}", d, cross=False)
    specs += [("encoder.ln_post.weight", (d,)), ("encoder.ln_post.bias", (d,)),
              ("decoder.token_embedding.weight", (dims.n_vocab, dt)),
              ("decoder.positional_embedding", (dims.n_text_ctx, dt))]
    for i in range(dims.n_text_layer):
        specs += block(f"decoder.blocks.{i}", dt, cross=True)
    specs += [("decoder.ln.weight", (dt,)), ("decoder.ln.bias", (dt,))]

    for idx, (name, shape) in enumerate(specs):
        x = np.random.default_rng([seed, idx]).standard_normal(shape, dtype=np.float32)
        if "embedding" in name:
            x *= 0.02
        elif len(shape) > 1:
            x *= 1.0 / np.sqrt(np.prod(shape[1:]))
        elif "ln" in name.split(".")[-2] and name.endswith("weight"):
            x = 1.0 + 0.02 * x
        else:
            x *= 0.02
        yield name, x


class _SeededTensors:
    """The tensors of `_seeded_ggml_tensors` as `write_ggml` reads them
    (`.items()`), drawn one at a time so the full-width set never sits in
    host memory."""

    def __init__(self, dims, seed: int):
        self.dims, self.seed = dims, seed

    def items(self):
        return _seeded_ggml_tensors(self.dims, self.seed)


def _port_param(model, name: str):
    """The port parameter (or the slice of the fused q/k/v projection) that
    holds the ggml tensor `name`."""
    parts = name.split(".")
    half = getattr(model, parts[0])          # model.encoder or model.decoder
    if name == "decoder.token_embedding.weight":
        return half.tok_emb
    if parts[1] == "positional_embedding":
        return half.pos
    if parts[1] != "blocks":                 # conv1, conv2, ln_post, ln
        return getattr(getattr(half, parts[1]), parts[2])
    blk = half.blocks[int(parts[2])]
    mod, leaf = ".".join(parts[3:-1]), parts[-1]
    qkv = {"attn.query": 0, "attn.key": 1, "attn.value": 2}
    if mod in qkv:
        d = blk.qkv.weight.shape[1]
        return getattr(blk.qkv, leaf)[qkv[mod] * d:(qkv[mod] + 1) * d]
    attr = {"attn_ln": "attn_ln", "attn.out": "o", "mlp_ln": "mlp_ln", "mlp.0": "fc1",
            "mlp.2": "fc2", "cross_attn_ln": "cross_ln", "cross_attn.query": "cq",
            "cross_attn.key": "ck", "cross_attn.value": "cv", "cross_attn.out": "co"}[mod]
    return getattr(getattr(blk, attr), leaf)


def _expected_params(dims, seed: int, dtype) -> dict:
    """name -> the value the loaded parameter must hold, on the host: the
    source weight after write_ggml's f16 round trip (its tensors of two or
    more dimensions), in the port's dtype (`dtype` for those, f32 for
    vectors)."""
    import numpy as np
    import torch

    out = {}
    for name, src in _seeded_ggml_tensors(dims, seed):
        if src.ndim > 1 and src.size % 32 == 0:
            src = src.astype(np.float16).astype(np.float32)
        out[name] = torch.from_numpy(src).to(dtype if src.ndim > 1 else torch.float32)
    return out


def _check_params(model, expected: dict) -> int:
    """Every parameter of the loaded model exactly equal to `expected`
    (`_expected_params`). Returns the number of values checked."""
    import torch

    checked = 0
    for name, want in expected.items():
        got = _port_param(model, name)
        assert got.shape == want.shape and got.dtype == want.dtype, (name, got, want)
        assert torch.equal(got, want.to(got.device)), name
        checked += got.numel()
    for blocks in (model.encoder.blocks, model.decoder.blocks):
        for blk in blocks:          # whisper's key projection has no bias
            d = blk.qkv.weight.shape[1]
            assert torch.count_nonzero(blk.qkv.bias[d:2 * d]).item() == 0
            checked += d
    total = sum(p.numel() for p in model.parameters())
    assert checked == total, (checked, total)
    return checked


def _stop(engine) -> None:
    """Stop a BatchedEngine's collector and its slot pool's server."""
    engine.engine.disable_slot_serving()
    engine.stop()


def _free_device() -> None:
    """Give the device memory of dropped engines back, so the next peak
    belongs to the next engine alone."""
    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase_ckpt(card: str, seed: int = 0) -> int:
    """Load a full-width large-v3 f16 ggml checkpoint through the port's
    composition root, cold and warm, check it, serve windows and streams
    on it, and run the CLI on it."""
    import numpy as np
    import torch

    from speaksense_tpu_torch.audio import mel as MEL
    from speaksense_tpu_torch.audio.io import write_wav
    from speaksense_tpu_torch.ckpt import cache as CK
    from speaksense_tpu_torch.ckpt.ggml import F16, GgmlModel, write_ggml
    from speaksense_tpu_torch.config import Config, EngineConfig
    from speaksense_tpu_torch.main import build_engine
    from speaksense_tpu_torch.models import whisper as W
    from speaksense_tpu_torch.ops import flash as F

    dims = W.MODEL_DIMS["large-v3"]
    tmp = Path(tempfile.mkdtemp(prefix="speaksense-ckpt-"))
    hits: list[bool] = []
    real_load_cached = CK.load_cached

    def recording_load_cached(*a, **kw):
        out = real_load_cached(*a, **kw)
        hits.append(out is not None)
        return out

    def rss_gib() -> float:
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20

    def load(kind: str):
        """build_engine(config) on the checkpoint, timed; every parameter
        checked. kind "cold" converts the file, "warm" reads the cache."""
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        engine = build_engine(config, device="cuda", slot_serving=True, max_wait_ms=50.0)
        torch.cuda.synchronize()
        times[kind] = time.perf_counter() - t0
        assert hits[-1] == (kind == "warm"), (kind, hits)
        inner = engine.engine
        assert inner.dims == dims and inner.device.type == "cuda", (inner.dims, inner.device)
        assert inner.model.dtype == torch.bfloat16 and inner.tokenizer.n_vocab == dims.n_vocab
        peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        if not expected:        # drawn once, after the cold load's peak
            expected.update(_expected_params(dims, seed, inner.model.dtype))
        n_checked = _check_params(inner.model, expected)
        what = ("parse, f16 dequant, conversion, cache write" if kind == "cold"
                else "cache read")
        print(f"ckpt: {kind} load through build_engine(config) {times[kind]:.2f} s ({what} "
              f"and the copy to the card, with the 64-slot pool); every parameter "
              f"({n_checked} values) exactly equal to the source weights after the f16 round "
              f"trip (checked in {time.perf_counter() - t0:.1f} s); peak device memory "
              f"{peak / 2**30:.2f} GiB; peak host RSS so far {rss_gib():.2f} GiB [{card}]")
        return engine

    CK.load_cached = recording_load_cached
    errors = _ErrorRecords()
    logger = logging.getLogger("speaksense_tpu_torch")
    logger.addHandler(errors)
    try:
        path = tmp / "ggml-large-v3.bin"
        t0 = time.perf_counter()
        # the vocab holds the text pieces only; the loader pads the rest
        write_ggml(GgmlModel(dims=dims, ftype=F16, filters=MEL.mel_filter_bank(dims.n_mels),
                             vocab=[b"<%d>" % i for i in range(50257)],
                             tensors=_SeededTensors(dims, seed)), str(path), ftype=F16)
        print(f"ckpt: wrote {path.name} ({path.stat().st_size / 1e9:.3f} GB, f16, large-v3 "
              f"width and depth) in {time.perf_counter() - t0:.1f} s")

        config = Config(model_path=str(path))
        # 96 new tokens per window, the stream slots' budget; the rest default
        config.engine = EngineConfig(max_decode_len=192,
                                     weight_cache_dir=str(tmp / "asr_data" / "weights_cache"))
        times: dict = {}
        expected: dict = {}
        engine = load("cold")
        _stop(engine)
        del engine
        _free_device()
        npz = tmp / "asr_data" / "weights_cache" / "ggml-large-v3.cache.npz"
        npz_mtime = npz.stat().st_mtime_ns
        print(f"ckpt: weight cache {npz.name} {npz.stat().st_size / 1e9:.3f} GB")
        engine = load("warm")
        try:
            inner = engine.engine
            inner.config = dataclasses.replace(inner.config, logprob_thold=-1e9,
                                               entropy_thold=-1.0, compression_ratio_thold=1e9)
            pool = inner._slot_server.pool
            torch.cuda.reset_peak_memory_stats()
            rows0, calls0, windows0 = pool.admit_rows, pool.admit_calls, engine.windows_run
            batches0 = engine.batches_run
            n_encode, restore = _count_encodes(W)
            F.flash_attention_full.launches = 0
            try:
                audios = [_speech(30.0, seed=100 + i) for i in range(8)]
                results, wall_w = _transcribe_concurrently(engine, audios)
                wall_s, lat, events = _run_sessions(engine, 8, 10.0)
                torch.cuda.synchronize()
            finally:
                launches = F.flash_attention_full.launches
                restore()
            rows, calls = pool.admit_rows - rows0, pool.admit_calls - calls0
            windows, batches = engine.windows_run - windows0, engine.batches_run - batches0
            for i, evs in enumerate(events):
                assert evs and evs[-1].end == 1 and sum(e.end for e in evs) == 1, (i, evs)
            assert windows >= 8, windows     # a decoded timestamp may seek short
            assert rows == 24, rows
            assert n_encode[0] == batches + calls, (n_encode[0], batches, calls)
            assert launches == dims.n_audio_layer * n_encode[0], (launches, n_encode[0])
            p50, p95 = np.percentile(lat, [50, 95])
            print(f"ckpt: on the loaded engine, 8 concurrent 30 s transcribe calls in {wall_w:.2f} s "
                  f"({windows} windows in {batches} batches, "
                  f"{sum(r.n_tokens for r in results)} tokens); 8 concurrent 10 s stream sessions "
                  f"in {wall_s:.2f} s (chunk latency p50 {p50:.3f} s, p95 {p95:.3f} s; {rows} rows "
                  f"in {calls} admissions); {n_encode[0]} encodes, {launches} flash kernel "
                  f"launches; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
                  f"GiB [{card}]")
        finally:
            _stop(engine)
        del engine, inner, pool
        _free_device()
        assert not errors.records, [r.getMessage() for r in errors.records]

        # the port's CLI in its own process, on the card; run from the
        # temporary directory, its default weight cache is the one above
        wav = tmp / "speech.wav"
        write_wav(wav, _speech(30.0, seed=200))
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(
            [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])}
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", "speaksense_tpu_torch.cli", "transcribe",
                              str(wav), "--model", str(path), "--language", "en", "--json"],
                             cwd=tmp, env=env, capture_output=True, text=True, timeout=900)
        cli_s = time.perf_counter() - t0
        assert out.returncode == 0, out.stderr[-4000:]
        result = json.loads(out.stdout)
        assert isinstance(result["segments"], list) and "full_text" in result, result
        assert npz.stat().st_mtime_ns == npz_mtime, "the CLI converted again: cache missed"
        print(f"ckpt: python -m speaksense_tpu_torch.cli transcribe (30 s WAV, --json) rc 0 in "
              f"{cli_s:.1f} s from the weight cache: {len(result['segments'])} segments; "
              f"{out.stderr.strip().splitlines()[-1]} [{card}]")
        print(f"ckpt: cold load {times['cold']:.2f} s, warm load {times['warm']:.2f} s; peak host "
              f"RSS {rss_gib():.2f} GiB [{card}]")
    finally:
        CK.load_cached = real_load_cached
        logger.removeHandler(errors)
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase", choices=("kernel", "main", "stream", "ckpt", "all"), default="all")
    args = ap.parse_args()
    phases = ("kernel", "main", "stream", "ckpt") if args.phase == "all" else (args.phase,)

    import torch

    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the chip smoke test runs only on a GPU")
    card = _card()
    print(card)

    from speaksense_tpu_torch.config import Config, EngineConfig
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
              "launches": None, "max_abs_err": None, "ms": None, "plain_ms": None,
              "bound_ms": None, "bound_by": None, "library_ms": None}
    record["bound_ms"], record["bound_by"] = _attention_bound_ms((8, 20, 1500, 64))
    if "kernel" in phases:
        record.update(phase_kernel(card))
    if set(phases) & {"main", "stream", "ckpt"}:
        record["launches"] = 0
    if set(phases) & {"main", "stream"}:
        config = Config()
        # max_new = max_decode_len // 2 = 48 tokens per window on the window
        # path, where random weights climb the whole ladder (82 window
        # calls); every other knob (bf16, max_batch_size 8, best_of 5,
        # thresholds, 64 stream slots of 96 tokens) is the default
        config.engine = EngineConfig(max_decode_len=96)
        t0 = time.perf_counter()
        engine = build_engine(config, model="large-v3", device="cuda", seed=0,
                              max_wait_ms=50.0, slot_serving=True)
        torch.cuda.synchronize()
        print(f"engine: large-v3 random weights and a 64-slot pool on the card in "
              f"{time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
              f"[{card}]")
        try:
            if "main" in phases:
                record["launches"] += phase_main(card, engine)
            if "stream" in phases:
                record["launches"] += phase_stream(card, engine)
        finally:
            _stop(engine)
        del engine
        _free_device()
    if "ckpt" in phases:
        record["launches"] += phase_ckpt(card)
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "speaksense_tpu"))
    assert not leaked, leaked
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
