"""Chip smoke test for the PyTorch/CUDA port (speaksense_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py              # every phase
    python3 chip_smoke.py --phase kernel

It first compiles the hand-written CUDA kernels from the sources in the
tree, then runs its phases:
  kernel  hold each kernel against its plain PyTorch version on the card at
          the shapes of the main path, and time both with CUDA events;
  main    build the engine with `speaksense_tpu_torch.main.build_engine` at
          large-v3 width (random weights from a seed), answer 8 concurrent
          transcribe requests through the window batcher, and check the
          results and the kernel launch counts.

Any failure raises and the script exits non-zero. The last line of standard
output is the device JSON; the line before it lists the kernels.
"""

from __future__ import annotations

import argparse
import json
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

    shape = (8, 20, 1500, 64)
    q, k, v = rand(*shape), rand(*shape), rand(*shape)
    ms = _time_ms(lambda: F.flash_attention_full(q, k, v))
    plain_ms = _time_ms(lambda: F.flash_attention_ref(q, k, v))
    flops = 4 * 8 * 20 * 1500 * 1500 * 64
    print(f"kernel flash_attn_fwd {shape} bf16: {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
          f"plain PyTorch {plain_ms:.4f} ms [{card}]")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


# Encoder output at full depth, kernel vs plain attention: both runs carry
# bf16 activations through 32 layers, so one-ulp differences in the attention
# output (bf16 ulp 2^-8 at 1.0) are re-rounded in every residual add; 5% of
# the output's RMS leaves room for that and still catches a wrong kernel,
# which would decorrelate the two runs (relative error near 1.4).
ENC_REL_BOUND = 5e-2


def _speech(seconds: float, seed: int):
    """Seeded pseudo-speech at 16 kHz: voiced harmonics under a syllable-rate
    envelope plus noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000
    f0 = 110 + 20 * seed + 30 * np.sin(2 * np.pi * 0.3 * t)
    voiced = sum(np.sin(2 * np.pi * k * np.cumsum(f0) / 16000) / k for k in range(1, 6))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * (3 + 0.2 * seed) * t) ** 2
    return (0.2 * voiced * env + 0.02 * rng.standard_normal(t.size)).astype(np.float32)


def phase_main(card: str, n_requests: int = 8) -> int:
    """Drive the port's default path: build_engine -> BatchedEngine.transcribe
    from n_requests threads, as the REST task workers call it."""
    import numpy as np
    import torch

    from speaksense_tpu.asr import AsrParams, TranscribeResult
    from speaksense_tpu.config import Config, EngineConfig
    from speaksense_tpu_torch.main import build_engine
    from speaksense_tpu_torch.models import whisper as W
    from speaksense_tpu_torch.ops import flash as F

    config = Config()
    # max_new = max_decode_len // 2 = 96 tokens per window; every other knob
    # (bf16, max_batch_size 8, best_of 5, fallback thresholds) is the default
    config.engine = EngineConfig(max_decode_len=192)
    t0 = time.perf_counter()
    engine = build_engine(config, model="large-v3", device="cuda", seed=0, max_wait_ms=50.0)
    torch.cuda.synchronize()
    print(f"main: large-v3 random weights on the card in {time.perf_counter() - t0:.1f} s")
    dims = engine.engine.dims
    audios = [_speech(30 + 2 * i, seed=i) for i in range(n_requests)]

    # instrumentation of this run only: encoder calls and batch sizes
    n_encode = [0]
    real_encode = W.encode

    def counting_encode(*a, **kw):
        n_encode[0] += 1
        return real_encode(*a, **kw)

    batch_sizes: list[int] = []
    real_decode_windows = engine.engine.decode_windows

    def recording_decode_windows(mels, *a, **kw):
        batch_sizes.append(int(mels.shape[0]))
        return real_decode_windows(mels, *a, **kw)

    W.encode = counting_encode
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
        W.encode = real_encode
        engine.engine.decode_windows = real_decode_windows
        engine.stop()
    if errors:
        raise errors[0]
    peak = torch.cuda.max_memory_allocated()

    for i, r in enumerate(results):
        assert isinstance(r, TranscribeResult), (i, type(r))
        assert r.language == "en", (i, r.language)
        dur = audios[i].size / 16000
        assert all(0.0 <= s.start <= s.end <= dur + 1e-6 for s in r.segments), i
    tokens = sum(r.n_tokens for r in results)
    windows = engine.windows_run
    assert windows > n_requests, f"no request spanned two windows ({windows} windows)"
    assert max(batch_sizes) == engine.max_batch == 8, batch_sizes
    assert n_encode[0] >= 1 and launches == dims.n_audio_layer * n_encode[0], (
        launches, n_encode[0])
    print(f"main: {n_requests} concurrent transcribe requests ({sum(a.size for a in audios) / 16000:.0f} s "
          f"of audio) in {wall:.2f} s; {windows} windows in {engine.batches_run} batches, "
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
    assert torch.isfinite(enc).all().item(), "non-finite encoder output"
    diff = (enc.float() - enc_ref.float())
    rel = (diff.norm() / enc_ref.float().norm()).item()
    print(f"main: encoder output (1, {dims.n_audio_ctx}, {dims.n_audio_state}) kernel vs plain "
          f"attention: max_abs_err {diff.abs().max().item():.3e}, relative L2 {rel:.3e} "
          f"(bound {ENC_REL_BOUND})")
    assert rel <= ENC_REL_BOUND, rel
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase", choices=("kernel", "main", "all"), default="all")
    args = ap.parse_args()

    import torch

    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the chip smoke test runs only on a GPU")
    card = _card()
    print(card)

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
    if args.phase in ("main", "all"):
        record["launches"] = phase_main(card)
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
