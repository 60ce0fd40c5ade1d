"""Chip smoke test for the PyTorch/CUDA port (speaksense_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py              # every phase
    python3 chip_smoke.py --phase kernel    # or main, stream, grad, words, serve, beam, ckpt

It first compiles the hand-written CUDA kernels from the sources in the
tree, then runs its phases; main, stream, grad, words and serve share one
set of large-v3-width random weights:
  kernel  hold each kernel against its plain PyTorch version on the card at
          the shapes of the main paths (30 s windows and 5 s slot
          admissions), time both and the one PyTorch call that computes the
          same function (`scaled_dot_product_attention`, a yardstick never
          on the path) with CUDA events, and print each shape's bound; the
          forward, and the two backward kernels behind its autograd
          function (dQ with delta in its prologue, then dK/dV); each runs
          its warp-specialised Hopper design, and its first (`mma.sync`)
          design (for dQ: the standalone delta kernel, then dQ) is held and
          timed beside it in the same run; at the admission shapes the
          device time (profiler) of every compiled forward tile stands
          beside the back-to-back host figure; then run the tile sweep tool
          (`speaksense_tpu_torch.tools.microbench_encattn`) in process;
  main    answer 2 concurrent transcribe requests through the window
          batcher of `speaksense_tpu_torch.main.build_engine` (48 new tokens
          a window), check the results and the kernel launch counts, hold
          the full-depth encoder with the kernel against the plain
          attention, and time the encoder with f32 activations against one
          with bf16 activations;
  stream  drive the port's `StreamSession` from 64 threads over the 64-slot
          pool (1 s packets, 5 s chunks, device denoise), then 8 sessions
          with every fallback gate armed, and check admissions, retries,
          end events and kernel launches;
  grad    take the gradient of the full-depth large-v3 encoder on 2 windows
          of 30 s (`encode(..., grad=True)`, one backward from a seeded
          cotangent to the mel and to three blocks' parameters), check the
          launch counts (32 forward, 32 dQ-with-delta and 32 dK/dV, no
          standalone delta) and the gradients against the same encoder with
          the plain attention, then serve one request on the same engine;
  words   VAD segmentation and word timestamps through the window batcher
          (`transcribe_audio_vad` with word timestamps on 67.5 s of
          pseudo-speech with two silent gaps: three spans, four windows,
          the ladder neutralized): check the spans, each segment's words
          (inside its span, non-decreasing starts in a window) and the
          flash forward's launches (32 per decode encode and 32 per aligned
          window's second encode), print each window's decode, align
          encode, cross-attention weights, device alignment matrix, host DTW
          and bytes to the host, hold one window's device alignment matrix
          against the numpy one on 32 heads, then parse a 44.1 kHz stereo
          WAV as a stream and run the CLI's quality, voiceprint, emotion and
          denoise;
  serve   the REST task path of a server built by `main.build_context`
          (SQLite stores, API-key auth, the task manager, 2 Transcribe
          workers over the window batcher, a loopback HTTP server for URL
          inputs and callbacks), the ladder neutralized: a 30 s task by URL
          with a callback, the same audio by local path with emotion labels
          and the dirty-word filter, a URL that answers 404 (retried, then
          failed), a 10 s noise reduction; checks the terminal states,
          results, callbacks, the key's usage and the forward kernel's
          launches, and prints each task's latency from queued to terminal.
          The REST and gRPC front doors themselves (aiohttp, grpc.aio) are
          not driven here: the GPU image has no aiohttp, grpcio or protobuf;
          the CPU tests hold them against the JAX servers, and the script
          checks that none of those packages (nor requests) was imported;
  beam    on an engine with beam_size 5 (BASELINE config 4: 64 streams,
          beam = 5): 2 concurrent 30 s requests through the window beam
          search, 64 session threads through the 64-slot K = 5 beam pool
          (int8 self-KV pages), one session with the gates armed (its
          retries take the window path), the pool's step, admission and
          device busy time, a window beam call at B = 8, int8 against bf16
          pages on one window; then one 30 s window with int8 weights,
          cross-KV and self-KV;
  ckpt    write a full-width large-v3 f16 ggml checkpoint from seeded
          weights into a temporary directory (about 3.1 GB, and a 6.2 GB
          weight cache beside it), load it cold through `build_engine` and
          warm from the cache, hold every parameter against the source
          weights after the same f16 round trip, serve 8 concurrent 30 s
          windows and 8 stream sessions on it, and run the port's CLI on it.

The script imports nothing of jax or of the JAX package, and checks that no
such module was loaded. Any failure raises and the script exits non-zero.
The last line of standard output is the device JSON; the line before it
lists the four kernels.
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

# bf16 output of a softmax-weighted average of O(1) values: one bf16 ulp at
# magnitude 1 is 2^-8; the kernel rounds the unnormalised probabilities and
# the reference the normalised ones, and both round the output, so a few
# ulps of difference are expected
FLASH_ATOL = 2e-2
# the default tile of each kernel's first (mma.sync) design, timed beside
# the design the port runs
FIRST_DESIGN_TILE = (64, 64, 4)


def phase_kernel(card: str) -> dict:
    import torch

    from speaksense_tpu_torch.ops import flash as F
    from speaksense_tpu_torch.tools import microbench_encattn as MB

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=g, device=dev, dtype=torch.float32).to(torch.bfloat16)

    worst = 0.0
    assert F.warp_specialised(F.flash_tile_config(1500).fwd)
    assert not F.warp_specialised(FIRST_DESIGN_TILE) and FIRST_DESIGN_TILE in F.FWD_TILES
    first = F.TileConfig(fwd=FIRST_DESIGN_TILE)
    # these shapes cross every edge of a 192-row CTA, a 64-row warpgroup and
    # a 64-key tile
    cases = [(8, 20, 1500, 64), (1, 2, 200, 64), (2, 3, 77, 64), (1, 1, 1, 64),
             (2, 4, 64, 64), (1, 2, 256, 64), (1, 2, 1536, 64)]
    for shape in cases:
        q, k, v = rand(*shape), rand(*shape), rand(*shape)
        out = F.flash_attention_full(q, k, v)
        ref = F.flash_attention_ref(q, k, v)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        assert torch.isfinite(out).all().item(), f"non-finite kernel output at {shape}"
        first_err = (F.flash_attention_full(q, k, v, first).float() - ref.float()).abs().max().item()
        print(f"kernel flash_attn_fwd {shape}: max_abs_err {err:.3e}, first design "
              f"{first_err:.3e} (bound {FLASH_ATOL})")
        assert err <= FLASH_ATOL and first_err <= FLASH_ATOL, (shape, err, first_err)
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
        # new, first, first, new: the two designs in turns on one card
        ms = MB.time_ms(lambda: F.flash_attention_full(q, k, v))
        first_ms = MB.time_ms(lambda: F.flash_attention_full(q, k, v, first))
        first_ms = min(first_ms, MB.time_ms(lambda: F.flash_attention_full(q, k, v, first)))
        ms = min(ms, MB.time_ms(lambda: F.flash_attention_full(q, k, v)))
        plain_ms = MB.time_ms(lambda: F.flash_attention_ref(q, k, v))
        sdpa_ms = MB.time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v))
        bound_ms, bound_by = MB.bound_ms(shape, *MB.FWD_WORK)
        flops = 4 * shape[0] * shape[1] * shape[2] ** 2 * shape[3]
        print(f"kernel flash_attn_fwd {shape} bf16: {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s), first design {first_ms:.4f} ms, plain PyTorch "
              f"{plain_ms:.4f} ms, scaled_dot_product_attention {sdpa_ms:.4f} ms; bound "
              f"{bound_ms:.4f} ms ({bound_by}), the kernel at {100 * bound_ms / ms:.1f}% of it "
              f"[{card}]")
        rec = dict(ms=ms, first_ms=first_ms, plain_ms=plain_ms, sdpa_ms=sdpa_ms,
                   bound_ms=bound_ms, bound_by=bound_by)
        if shape[2] == 256:
            # back to back these launches are bound by the wrapper's Python;
            # the profiler's kernel time says what the card itself takes
            def device_ms(fn, n=20):
                busy = _profiled_device_ms(lambda: [fn() for _ in range(n)])
                return None if busy is None else busy / n

            dev_ms = {"kernel": device_ms(lambda: F.flash_attention_full(q, k, v)),
                   "first": device_ms(lambda: F.flash_attention_full(q, k, v, first)),
                   "sdpa": device_ms(
                       lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v))}
            text = ", ".join(f"{name} not measured" if t is None else f"{name} {t:.4f} ms"
                             for name, t in dev_ms.items())
            print(f"kernel flash_attn_fwd {shape} bf16 device time (profiler, 20 launches): "
                  f"{text}; the rest of each back-to-back figure above is host time [{card}]")
            rec["device_ms"] = dev_ms
            # every compiled tile's device time, three times in turns: what
            # flash_tile_config(256) may name against the default's spread
            tile_ms = {tile: [] for tile in F.FWD_TILES}
            for _ in range(3):
                for tile in F.FWD_TILES:
                    tiles = F.TileConfig(fwd=tile)
                    tile_ms[tile].append(device_ms(lambda: F.flash_attention_full(q, k, v, tiles)))
            for tile, times in tile_ms.items():
                text = ("not measured" if None in times else
                        f"{min(times):.4f}-{max(times):.4f} ms ({', '.join(f'{t:.4f}' for t in times)})")
                print(f"kernel flash_attn_fwd {shape} bf16 tile {MB._label(tile)}: device time "
                      f"(profiler, 20 launches, 3 runs) {text} [{card}]")
            rec["tile_device_ms"] = {MB._name(t): v for t, v in tile_ms.items()}
        by_shape["x".join(map(str, shape))] = rec
    head = by_shape["8x20x1500x64"]
    return {"max_abs_err": worst, "ms": head["ms"], "plain_ms": head["plain_ms"],
            "library_ms": head["sdpa_ms"], "sdpa_ms": head["sdpa_ms"], "by_shape": by_shape}


def _grads(attn, q, k, v, dout):
    """(dq, dk, dv) of `attn` by autograd."""
    import torch

    q, k, v = (x.detach().requires_grad_(True) for x in (q, k, v))
    return torch.autograd.grad(attn(q, k, v), (q, k, v), dout)


def phase_kernel_bwd(card: str) -> dict:
    """The backward kernels against autograd through the plain attention
    (bound: GRAD_ATOL and GRAD_REL of the sweep tool, with their reasons),
    the forward's log-sum-exp, and the times of each kernel beside its plain
    version, `scaled_dot_product_attention`'s backward and the bound.
    Returns {kernel name: record fields}."""
    import torch

    from speaksense_tpu_torch.ops import flash as F
    from speaksense_tpu_torch.tools import microbench_encattn as MB

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)

    def rand(*shape):
        return torch.randn(*shape, generator=g, device=dev, dtype=torch.float32).to(torch.bfloat16)

    worst = {"flash_attn_bwd_delta": 0.0, "flash_attn_bwd_dkdv": 0.0, "flash_attn_bwd_dq": 0.0}
    assert F.warp_specialised(F.flash_tile_config(1500).dkdv)
    assert F.warp_specialised(F.flash_tile_config(1500).dq)
    assert FIRST_DESIGN_TILE in F.DKDV_TILES and FIRST_DESIGN_TILE in F.DQ_TILES
    first = F.TileConfig(dq=FIRST_DESIGN_TILE)     # the first design's backward: delta, dK/dV, dQ

    def hold(what, q, k, v, dout):
        bare = F.flash_attention_full(q, k, v)
        out, lse = F._flash_fwd(q, k, v, F.flash_tile_config(q.shape[2]).fwd, with_lse=True)
        assert torch.equal(bare, out), f"{what}: out differs with and without lse"
        lse_err = (lse - F.attention_lse_ref(q, k)).abs().max().item()
        delta = F.flash_bwd_delta(out, dout)
        delta_err = (delta - F.flash_bwd_delta_ref(out, dout)).abs().max().item()
        # f32 sums of up to 1536 O(1) terms in another order
        assert lse_err <= 1e-3 and delta_err <= 1e-3, (what, lse_err, delta_err)
        got = _grads(F.flash_attention_full, q, k, v, dout)
        want = _grads(F.flash_attention_ref, q, k, v, dout)
        # dQ with delta alone: its delta against the plain row sum
        dq_ws, delta_ws = F.flash_bwd_dq_delta(q, k, v, out, dout, lse)
        torch.cuda.synchronize()
        delta_ws_err = (delta_ws - F.flash_bwd_delta_ref(out, dout)).abs().max().item()
        assert delta_ws_err <= 1e-3, (what, delta_ws_err)
        dq_err = max(MB.check_grads(what, got[:1], want[:1], ("dq",)),
                     MB.check_grads(f"{what}, dq alone", (dq_ws,), want[:1], ("dq",)))
        dkdv_err = MB.check_grads(what, got[1:], want[1:], ("dk", "dv"))
        first_err = MB.check_grads(
            f"{what}, first design",
            F.flash_bwd_dkdv(q, k, v, dout, lse, delta, FIRST_DESIGN_TILE), want[1:], ("dk", "dv"))
        first_dq_err = MB.check_grads(
            f"{what}, first design",
            (F.flash_bwd_dq(q, k, v, dout, lse, delta, FIRST_DESIGN_TILE),), want[:1], ("dq",))
        print(f"kernel flash_attn_bwd {what}: max_abs_err dq {dq_err:.3e} (first design "
              f"{first_dq_err:.3e}), dk/dv {dkdv_err:.3e} (first design {first_err:.3e}) "
              f"(bound {MB.GRAD_ATOL} of max(1, max |gradient|), relative L2 <= {MB.GRAD_REL}); "
              f"delta in dQ's prologue {delta_ws_err:.3e}, standalone {delta_err:.3e}, "
              f"lse {lse_err:.3e} (bound 1e-3); out bit-identical with and without lse")
        for name, err in (("flash_attn_bwd_delta", delta_ws_err),
                          ("flash_attn_bwd_dkdv", dkdv_err), ("flash_attn_bwd_dq", dq_err)):
            worst[name] = max(worst[name], err)

    for shape in [(8, 20, 1500, 64), (1, 2, 200, 64), (2, 3, 77, 64), (1, 1, 1, 64),
                  (2, 4, 64, 64), (1, 2, 1536, 64), (8, 20, 256, 64)]:
        hold(str(shape), rand(*shape), rand(*shape), rand(*shape), rand(*shape))
    # strided views of a fused (B, T, 3*d) projection and of a (B, T, d) cotangent
    B, T, H = 2, 300, 20
    d = H * 64
    qkv = rand(B, T, 3 * d)
    q, k, v = (qkv[..., i * d:(i + 1) * d].view(B, T, H, 64).transpose(1, 2) for i in range(3))
    hold(f"strided fused-qkv view {(B, H, T, 64)}", q, k, v,
         rand(B, T, d).view(B, T, H, 64).transpose(1, 2))

    by_shape = {}
    for shape in ((8, 20, 1500, 64), (8, 20, 256, 64)):
        q, k, v, dout = rand(*shape), rand(*shape), rand(*shape), rand(*shape)
        out, lse = F._flash_fwd(q, k, v, F.FWD_TILES[0], with_lse=True)
        delta = F.flash_bwd_delta(out, dout)
        # backward alone of the plain version and of the library call: the
        # graph is recorded once, outside the timed region
        leaves = tuple(x.detach().requires_grad_(True) for x in (q, k, v))
        graphs = {"plain": F.flash_attention_ref(*leaves),
                  "sdpa": torch.nn.functional.scaled_dot_product_attention(*leaves)}

        def backward(name, wrt):
            return lambda: torch.autograd.grad(graphs[name], wrt, dout, retain_graph=True)

        def turns(new, old):
            """new, old, old, new on one card: the best of each."""
            a, b = MB.time_ms(new), MB.time_ms(old)
            b = min(b, MB.time_ms(old))
            return min(a, MB.time_ms(new)), b

        t = {
            "delta": MB.time_ms(lambda: F.flash_bwd_delta(out, dout)),
            "delta_plain": MB.time_ms(lambda: F.flash_bwd_delta_ref(out, dout)),
            "dkdv": MB.time_ms(lambda: F.flash_bwd_dkdv(q, k, v, dout, lse, delta)),
            "dkdv_first": MB.time_ms(
                lambda: F.flash_bwd_dkdv(q, k, v, dout, lse, delta, FIRST_DESIGN_TILE)),
            "dkdv_plain": MB.time_ms(lambda: F.flash_bwd_dkdv_ref(q, k, v, dout, lse, delta)),
            "dkdv_sdpa": MB.time_ms(backward("sdpa", leaves[1:])),
            "dq_plain": MB.time_ms(lambda: F.flash_bwd_dq_delta_ref(q, k, v, out, dout, lse)),
            "dq_sdpa": MB.time_ms(backward("sdpa", leaves[:1])),
            "bwd_plain": MB.time_ms(backward("plain", leaves)),
            "bwd_sdpa": MB.time_ms(backward("sdpa", leaves)),
        }
        # dQ with delta against the first design's dQ (which reads the
        # standalone kernel's delta); the backward's two launches against
        # the first design's three
        t["dq"], t["dq_first"] = turns(
            lambda: F.flash_bwd_dq_delta(q, k, v, out, dout, lse),
            lambda: F.flash_bwd_dq(q, k, v, dout, lse, delta, FIRST_DESIGN_TILE))
        t["bwd"], t["bwd_first"] = turns(
            lambda: F.flash_attention_bwd(q, k, v, out, lse, dout),
            lambda: F.flash_attention_bwd(q, k, v, out, lse, dout, first))
        bounds = {"delta": MB.delta_bound_ms(shape), "dkdv": MB.bound_ms(shape, *MB.DKDV_WORK),
                  "dq": MB.bound_ms(shape, *MB.DQ_DELTA_WORK),
                  "bwd": MB.bound_ms(shape, *MB.BWD_WORK)}
        for name, lib in (("delta", None), ("dkdv", "dkdv_sdpa"), ("dq", "dq_sdpa"),
                          ("bwd", "bwd_sdpa")):
            ms, (bound_ms, bound_by) = t[name], bounds[name]
            lib_text = ("no single PyTorch call" if lib is None else
                        f"scaled_dot_product_attention's backward {t[lib]:.4f} ms")
            label = {"delta": "delta (standalone)", "dq": "dq+delta"}.get(name, name)
            if name == "dkdv":
                lib_text = f"first design {t['dkdv_first']:.4f} ms, " + lib_text
            if name == "dq":
                lib_text = (f"first design {t['dq_first']:.4f} ms + standalone delta "
                            f"{t['delta']:.4f} ms = {t['dq_first'] + t['delta']:.4f} ms, "
                            f"{lib_text}; delta's own bound {bounds['delta'][0]:.4f} ms")
            if name == "bwd":
                lib_text = (f"first design (delta, dK/dV, dQ: three launches) "
                            f"{t['bwd_first']:.4f} ms, " + lib_text)
            print(f"kernel flash_attn_bwd {label} {shape} bf16: {ms:.4f} ms, plain PyTorch "
                  f"{t[name + '_plain']:.4f} ms, {lib_text}; bound {bound_ms:.4f} ms "
                  f"({bound_by}), the kernel at {100 * bound_ms / ms:.1f}% of it [{card}]")
        # the bound is the work's, not the design's: S and dP are needed once
        # (five products, 10·B·H·T²·Dh), and this two-kernel design computes
        # them in both kernels (seven products, 14·B·H·T²·Dh issued)
        issued = 14 * shape[0] * shape[1] * shape[2] ** 2 * shape[3]
        print(f"kernel flash_attn_bwd {shape}: the two launches issue {issued / 1e9:.1f} GFLOP "
              f"for {issued / 1.4e9:.1f} GFLOP of work (S and dP computed in both dQ and dK/dV): "
              f"{issued / t['bwd'] / 1e9:.1f} TFLOP/s issued [{card}]")
        by_shape["x".join(map(str, shape))] = {"ms": t, "bounds": bounds}
        del graphs, leaves
    head = by_shape["8x20x1500x64"]
    records = {}
    # on the main path delta is computed by the dQ launch: its record times
    # that launch (the same time as dQ's) against the same bound, and keeps
    # the standalone kernel's time, which only the first design pays, apart
    for name, key, lib in (("flash_attn_bwd_delta", "dq", None),
                           ("flash_attn_bwd_dkdv", "dkdv", "dkdv_sdpa"),
                           ("flash_attn_bwd_dq", "dq", "dq_sdpa")):
        records[name] = {"max_abs_err": worst[name], "ms": head["ms"][key],
                         "plain_ms": head["ms"][key + "_plain"],
                         "library_ms": None if lib is None else head["ms"][lib]}
    records["flash_attn_bwd_dq"]["first_design_ms"] = head["ms"]["dq_first"]
    records["flash_attn_bwd_delta"]["first_design_ms"] = head["ms"]["delta"]
    records["flash_attn_bwd_delta"]["own_bound_ms"] = head["bounds"]["delta"][0]
    print("kernel: the tile sweep (speaksense_tpu_torch.tools.microbench_encattn):")
    assert MB.main(["8"]) == 0
    return records


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
    from speaksense_tpu_torch.tools import microbench_encattn as MB

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
    f32_ms = MB.time_ms(lambda: W.encode(model, mel8), iters=5, warmup=2)
    bf16_ms = MB.time_ms(lambda: _encode_bf16_activations(model, mel8), iters=5, warmup=2)
    f32_ms_2 = MB.time_ms(lambda: W.encode(model, mel8), iters=5, warmup=1)
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


def _counter(name: str) -> float:
    from speaksense_tpu_torch.utils.metrics import REGISTRY as METRICS

    return METRICS.snapshot()["counters"].get(name, 0.0)


# the fallback ladder neutralized: every chunk is one pool job
NEUTRAL = dict(logprob_thold=-1e9, entropy_thold=-1.0, compression_ratio_thold=1e9)


def _session_run(engine, base_cfg, step_times: list, n_sessions: int, seconds: float = 10.0,
                 **thresholds) -> dict:
    """n_sessions StreamSession threads of `seconds` each (`_run_sessions`) over
    the engine's slot pool, with `thresholds` replacing base_cfg's. Checks
    that the server lives, that every session ended with one end event and
    that the flash forward launched n_audio_layer times per encode and the
    encodes are the admissions (plus any window-path encodes when the ladder
    is armed: `window_encodes`). Returns the run's figures."""
    import numpy as np
    import torch

    from speaksense_tpu_torch.models import whisper as W
    from speaksense_tpu_torch.ops import flash as F

    inner = engine.engine
    server = inner._slot_server
    pool = server.pool
    inner.config = dataclasses.replace(base_cfg, **thresholds)
    before = (pool.admit_calls, pool.admit_rows, pool.step_calls, pool.occupancy_sum,
              _counter("asr_pool_fallback_retries_total"))
    step_times.clear()
    torch.cuda.reset_peak_memory_stats()
    n_encode, restore = _count_encodes(W)
    F.flash_attention_full.launches = 0
    try:
        wall, lat, events = _run_sessions(engine, n_sessions, seconds)
        torch.cuda.synchronize()
    finally:
        launches = F.flash_attention_full.launches
        restore()
    after = (pool.admit_calls, pool.admit_rows, pool.step_calls, pool.occupancy_sum,
             _counter("asr_pool_fallback_retries_total"))
    d = [a - b for a, b in zip(after, before)]
    assert server._dead is None and server._thread.is_alive(), server._dead
    for i, evs in enumerate(events):
        assert evs and evs[-1].end == 1 and sum(e.end for e in evs) == 1, (i, evs)
    assert n_encode[0] >= d[0] and launches == inner.dims.n_audio_layer * n_encode[0], (
        launches, n_encode[0], d[0])
    return dict(wall=wall, lat=lat, events=events, admit_calls=d[0], admit_rows=d[1],
                steps=d[2], occupancy=d[3], retries=d[4], launches=launches,
                encodes=n_encode[0], window_encodes=n_encode[0] - d[0],
                peak=torch.cuda.max_memory_allocated(), step_ms=1e3 * float(np.mean(step_times)))


def _report_sessions(what: str, pool, r: dict, card: str) -> None:
    import numpy as np

    p50, p95 = np.percentile(r["lat"], [50, 95])
    print(f"{what}: wall {r['wall']:.2f} s; chunk latency p50 {p50:.3f} s, "
          f"p95 {p95:.3f} s ({len(r['lat'])} chunks); {r['admit_rows']} rows in "
          f"{r['admit_calls']} admissions; {r['steps']} pool steps at "
          f"{r['step_ms']:.2f} ms per step (host clock, with the retirement copy), "
          f"mean occupancy {r['occupancy'] / max(r['steps'], 1):.2f} of {pool.S}; "
          f"{r['retries']:.0f} pool retries; {r['encodes']} encodes ({r['window_encodes']} "
          f"on the window path), {r['launches']} flash kernel launches; peak memory "
          f"{r['peak'] / 2**30:.2f} GiB [{card}]")


def _timed(pool, step_times: list):
    """Wrap pool.step to append its host time to step_times (the step ends
    in the retirement copy, which waits for the device); undo with
    `del pool.step`."""
    real_step = pool.step

    def timed_step():
        t = time.perf_counter()
        out = real_step()
        step_times.append(time.perf_counter() - t)
        return out

    pool.step = timed_step


def phase_stream(card: str, engine) -> int:
    """Drive the port's streaming path: the port's StreamSession over the
    pooled BatchedEngine, a load run with the ladder neutralized and a run
    with every fallback gate armed."""
    import numpy as np
    import torch

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
    _timed(pool, step_times)

    def run(n_sessions, seconds=10.0, **thresholds):
        return _session_run(engine, base_cfg, step_times, n_sessions, seconds, **thresholds)

    try:
        # load: 64 sessions x 10 s = 2 chunks of 5 s and a 1 s tail each,
        # every chunk one greedy pool job
        load = run(64, **NEUTRAL)
        _report_sessions("stream load", pool, load, card)
        assert load["admit_rows"] == 64 * 3, load["admit_rows"]
        assert load["retries"] == 0 and load["window_encodes"] == 0, load["retries"]

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
        _report_sessions("stream ladder", pool, ladder, card)
        assert ladder["retries"] == 24 * 5 and ladder["window_encodes"] == 0, ladder["retries"]
        assert ladder["admit_rows"] == 24 * (1 + 5 * 5), ladder["admit_rows"]
        assert final_temps == [1.0] * 24, final_temps
    finally:
        inner.config = base_cfg
        del pool.step
        for lg in loggers:
            lg.removeHandler(errors)
    assert not errors.records, [r.getMessage() for r in errors.records]

    server.stop()
    m = _pool_alone(pool, inner.tokenizer)
    print(f"stream pool: admission of 8 windows {np.mean(m['admit_ms']):.2f} ms "
          f"(median {np.median(m['admit_ms']):.2f}); step at a mean {m['occupancy']:.1f} of "
          f"{pool.S} slots {np.mean(m['step_ms']):.2f} ms (median {np.median(m['step_ms']):.2f}); "
          f"{m['busy_text']} [{card}]")
    print(f"stream pool: largest kernels per step: {m['top_text']} [{card}]")
    return load["launches"] + ladder["launches"]


def _pool_alone(pool, tok, n_steps: int = 20) -> dict:
    """The pool alone, its server stopped: from a reset, admissions of 8
    windows of 5.12 s (device denoise, mel, encode, cross-KV, prefill) until
    every slot is full, each timed to a synchronize; then n_steps steps,
    each timed on the host (its retirement copy waits for the device); then
    the device busy time per step over 10 more (`_device_busy_ms`). Resets
    the pool after. Returns the figures."""
    import numpy as np
    import torch

    from speaksense_tpu_torch.runtime.slots import _StreamJob

    pool.reset()
    pcm = [(np.clip(_speech(5.12, seed=i), -1, 1) * 32767).astype(np.int16)
           for i in range(8)]
    prompt = list(tok.sot_sequence("en"))
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
    for _ in range(n_steps):
        t = time.perf_counter()
        pool.step()
        step_ms.append(1e3 * (time.perf_counter() - t))
    occupancy = (pool.occupancy_sum - occ0) / len(step_ms)
    top: list = []
    busy = _device_busy_ms(pool, 10, top)
    busy_text = ("device busy not measured (the profiler saw no device time)" if busy is None
                 else f"device busy {busy:.2f} ms per step, idle "
                      f"{100 * (1 - busy / np.median(step_ms)):.0f}% of the median step")
    pool.reset()
    top_text = "; ".join(f"{name[:60]} {ms:.2f} ms ({n} launches)" for name, ms, n in top)
    return dict(admit_ms=admit_ms, step_ms=step_ms, occupancy=occupancy, busy=busy,
                busy_text=busy_text, top_text=top_text)


def _device_busy_ms(pool, n_steps: int, top: list | None = None) -> float | None:
    """Device time per full pool step: the kernels' own time (the
    profiler's "Self CUDA time total") over n_steps steps, traced with
    device activity only. None when the profiler saw no device time. A
    `top` list receives the largest kernels as (name, ms per step, launches
    per step)."""
    def steps():
        for _ in range(n_steps):
            pool.step()

    kernels: list = []
    busy = _profiled_device_ms(steps, kernels)
    if top is not None:
        top.extend((name, ms / n_steps, n // n_steps) for name, ms, n in kernels)
    return None if busy is None else busy / n_steps


BEAM_SIZE = 5


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _first_token_ok(r: dict, cfg) -> bool:
    """The rules' first token: a timestamp no later than max_initial_ts."""
    return r["n_sampled"] >= 1 and cfg.ts_begin <= int(r["tokens"][0]) <= cfg.max_initial_ts_tok


def phase_beam(card: str) -> int:
    """Drive beam search and the int8 paths at large-v3 width (BASELINE
    config 4: 64 streams, beam = 5): `_beam_serving`, then `_int8_window`.
    Returns the flash forward's launches of their drives."""
    launches = _beam_serving(card)
    _free_device()
    return launches + _int8_window(card)


def _beam_serving(card: str) -> int:
    """An engine from `build_engine` with config.beam_size = 5 and the beam
    pool's defaults (64 slots of K = 5, int8 self pages, cross-KV as
    config.cross_kv_int8): 2 concurrent 30 s transcribe calls through the
    window beam search; 64 StreamSession threads of 10 s through the beam
    pool with the ladder neutralized, then one of 5 s with every gate armed,
    whose retries take the window path; the pool alone (admission, steps, device
    busy); a window beam call at B = 8; int8 against bf16 pages on one
    window. Returns the flash forward's launches of the drives."""
    import numpy as np
    import torch

    from speaksense_tpu_torch.config import Config, EngineConfig
    from speaksense_tpu_torch.main import build_engine
    from speaksense_tpu_torch.models import whisper as W
    from speaksense_tpu_torch.ops import flash as F
    from speaksense_tpu_torch.runtime.beam_slots import BeamSlotPool
    from speaksense_tpu_torch.runtime.slots import _StreamJob

    config = Config()
    # 48 new tokens per window on the window path, 96 per pool chunk; every
    # other knob (bf16, bf16 cross-KV, 64 slots, best_of 5) is the default
    config.engine = EngineConfig(max_decode_len=96, beam_size=BEAM_SIZE)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = build_engine(config, model="large-v3", device="cuda", seed=0, max_wait_ms=50.0,
                          slot_serving=True)
    torch.cuda.synchronize()
    inner = engine.engine
    server = inner._slot_server
    pool = server.pool
    dims = inner.dims
    L = dims.n_audio_layer
    assert isinstance(pool, BeamSlotPool), type(pool)
    assert (pool.S, pool.K, pool.t_mel, pool.max_new, pool.t_text) == (64, BEAM_SIZE, 512, 96, 128)
    pages = pool.state.pages
    assert pool.self_int8 and pages.self_k.dtype == torch.int8
    assert pages.ring_k.dtype == torch.bfloat16
    assert pool.int8_kv == config.engine.cross_kv_int8 and pages.cross_k.dtype == torch.bfloat16
    # the decoder blocks' weights a step reads: all but the cross-KV
    # projections, which run at admission
    weights = _nbytes(*(p for n, p in inner.model.decoder.blocks.named_parameters()
                        if n.split(".")[1] not in ("ck", "cv")))
    vocab = _nbytes(inner.model.decoder.tok_emb)
    page_bytes = dict(self=_nbytes(pages.self_k, pages.self_v),
                      scales=_nbytes(pages.self_ks, pages.self_vs),
                      ring=_nbytes(pages.ring_k, pages.ring_v),
                      cross=_nbytes(pages.cross_k, pages.cross_v, pages.cross_ks, pages.cross_vs),
                      anc=_nbytes(pool.state.anc, pool.state.anc_ring))
    step_bytes = weights + vocab + sum(page_bytes.values())
    print(f"beam: engine with beam_size {BEAM_SIZE}, large-v3 random weights and a {pool.S}-slot "
          f"K = {pool.K} beam pool in {time.perf_counter() - t0:.1f} s; pool pages: self-KV "
          f"{page_bytes['self'] / 1e9:.3f} GB int8 ({pool.S * pool.K} rows x {pool.t_text} "
          f"columns x {dims.n_text_layer} layers, K and V), per-token scales "
          f"{page_bytes['scales'] / 1e9:.3f} GB f32, ring {page_bytes['ring'] / 1e9:.3f} GB bf16, cross-KV "
          f"{page_bytes['cross'] / 1e9:.3f} GB bf16 (once per slot, {pool.n_audio_ctx} frames), "
          f"ancestor tables {page_bytes['anc'] / 1e6:.1f} MB; a step reads at least "
          f"{step_bytes / 1e9:.2f} GB (decoder blocks without ck/cv {weights / 1e9:.2f}, "
          f"vocabulary "
          f"projection {vocab / 1e9:.2f}, pool pages {sum(page_bytes.values()) / 1e9:.2f}), "
          f"{1e3 * step_bytes / 3.35e12:.2f} ms at 3.35 TB/s; memory allocated "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")

    cfg = pool.cfg
    base_cfg = inner.config
    errors = _ErrorRecords()
    logger = logging.getLogger("speaksense_tpu_torch")
    logger.addHandler(errors)
    retired: list = []
    real_retire = pool._retire

    def recording_retire(finished):
        done = real_retire(finished)
        retired.extend(done)
        return done

    step_times: list[float] = []
    window_calls: list = []
    real_decode_windows = inner.decode_windows

    def recording_decode_windows(mels, *a, **kw):
        window_calls.append((int(mels.shape[0]), kw.get("beam_size"),
                             tuple(kw.get("temperatures") or ())))
        return real_decode_windows(mels, *a, **kw)

    launches = 0
    try:
        # 2 concurrent 30 s requests through the window batcher: beam search
        # (the ladder neutralized, so only the beam attempt runs)
        inner.config = dataclasses.replace(base_cfg, **NEUTRAL)
        inner.decode_windows = recording_decode_windows
        n_encode, restore = _count_encodes(W)
        F.flash_attention_full.launches = 0
        batches0, windows0 = engine.batches_run, engine.windows_run
        torch.cuda.reset_peak_memory_stats()
        try:
            results, wall = _transcribe_concurrently(
                engine, [_speech(30 + 2 * i, seed=500 + i) for i in range(2)])
        finally:
            n = F.flash_attention_full.launches
            restore()
            del inner.decode_windows
        batches, windows = engine.batches_run - batches0, engine.windows_run - windows0
        assert windows >= 2 and len(window_calls) == batches, (windows, window_calls)
        assert all(c[1] is None and not c[2] for c in window_calls), window_calls
        assert n_encode[0] == batches and n == L * n_encode[0], (n, n_encode[0], batches)
        launches += n
        print(f"beam: 2 concurrent 30 s transcribe calls through beam search (K = {BEAM_SIZE}, "
              f"the ladder neutralized) in {wall:.2f} s; {windows} windows in {batches} "
              f"decode_windows calls of sizes {[c[0] for c in window_calls]}; "
              f"{sum(r.n_tokens for r in results)} tokens; {n_encode[0]} encodes, {n} flash "
              f"kernel launches; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
              f"[{card}]")

        # 64 sessions through the 64-slot K = 5 beam pool, ladder neutralized
        pool._retire = recording_retire
        _timed(pool, step_times)
        load = _session_run(engine, base_cfg, step_times, 64, **NEUTRAL)
        _report_sessions("beam load", pool, load, card)
        assert load["admit_rows"] == 64 * 3 and load["retries"] == 0, load["admit_rows"]
        assert load["window_encodes"] == 0 and len(retired) == load["admit_rows"], len(retired)
        for job in retired:
            r = job.future.result()
            assert _first_token_ok(r, cfg), (r["n_sampled"], r["tokens"][:4])
            assert np.isfinite(r["sum_logprob"]) and r["sum_logprob"] <= 0, r["sum_logprob"]
            assert np.isfinite(r["avg_logprob"]) and 0 <= r["no_speech_prob"] <= 1
        n_tok = [job.future.result()["n_sampled"] for job in retired]
        print(f"beam load: {len(retired)} jobs retired, every first token a timestamp <= "
              f"max_initial_ts and every score finite; best hypotheses of {min(n_tok)}-"
              f"{max(n_tok)} tokens (mean {np.mean(n_tok):.1f}, "
              f"{sum(t < pool.max_new for t in n_tok)} ended before the budget) [{card}]")
        launches += load["launches"]

        # one 5 s session with every gate armed (a chunk and the 0.5 s tail):
        # a chunk's retries leave the beam pool (t = 0 only) for the window
        # path at t = 0.2 with beam_size 1, which climbs the rest of the
        # ladder with best_of rows, one rung after another
        retired.clear()
        window_calls.clear()
        finals: list = []
        real_gate = inner._pool_quality_gate

        def recording_gate(raw, retry):
            cand = real_gate(raw, retry)
            finals.append(cand["temperature"])
            return cand

        inner._pool_quality_gate = recording_gate
        inner.decode_windows = recording_decode_windows
        try:
            ladder = _session_run(engine, base_cfg, step_times, 1, seconds=5.0,
                                  logprob_thold=1e9, no_speech_thold=1.0, best_of=5)
        finally:
            del inner._pool_quality_gate, inner.decode_windows
        _report_sessions("beam ladder", pool, ladder, card)
        chunks = ladder["admit_rows"]
        assert chunks == 2 and ladder["retries"] == chunks, (chunks, ladder["retries"])
        assert finals == [1.0] * chunks, finals
        assert window_calls == [(1, 1, (0.2,))] * chunks, window_calls
        # each retry decodes at 0.2, then 0.4 .. 1.0 with best_of rows: 5 encodes
        assert ladder["window_encodes"] == 5 * chunks, ladder["window_encodes"]
        launches += ladder["launches"]
    finally:
        inner.config = base_cfg
        pool.__dict__.pop("step", None)
        pool.__dict__.pop("_retire", None)
        logger.removeHandler(errors)
    assert not errors.records, [r.getMessage() for r in errors.records]

    # the pool alone: admission of 8 windows, full-occupancy steps
    server.stop()
    torch.cuda.reset_peak_memory_stats()
    m = _pool_alone(pool, inner.tokenizer)
    busy = m["busy"]
    busy_text = m["busy_text"] + ("" if busy is None else
                                  f", {step_bytes / busy / 1e6:.0f} GB/s over the step's "
                                  f"{step_bytes / 1e9:.2f} GB floor, "
                                  f"{100 * 1e3 * step_bytes / 3.35e12 / busy:.1f}% of its "
                                  f"{1e3 * step_bytes / 3.35e12:.2f} ms bound")
    print(f"beam pool: admission of 8 windows {np.mean(m['admit_ms']):.2f} ms (median "
          f"{np.median(m['admit_ms']):.2f}); step at a mean {m['occupancy']:.1f} of {pool.S} "
          f"slots ({pool.K} hypotheses each) {np.mean(m['step_ms']):.2f} ms (median "
          f"{np.median(m['step_ms']):.2f}, host clock); {busy_text}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    print(f"beam pool: largest kernels per step: {m['top_text']} [{card}]")

    # the window beam search at B = 8 (30 s windows, 48 new tokens)
    mel8 = inner.compute_mel(np.stack([_speech(30, seed=600 + i) for i in range(8)]))
    inner.config = dataclasses.replace(base_cfg, **NEUTRAL)
    try:
        beam_ms = []
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = inner.decode_windows(mel8, "en", beam_size=BEAM_SIZE)
            beam_ms.append(1e3 * (time.perf_counter() - t))
        t = time.perf_counter()
        greedy = inner.decode_windows(mel8, "en", beam_size=1)
        greedy_ms = 1e3 * (time.perf_counter() - t)
    finally:
        inner.config = base_cfg
    assert all(_first_token_ok(r, cfg) and np.isfinite(r["avg_logprob"]) for r in out)
    print(f"beam window: decode_windows of 8 windows of 30 s at K = {BEAM_SIZE} "
          f"(encode, cross-KV, prefill, up to 48 steps of 40 hypotheses) "
          f"{beam_ms[0]:.1f} / {beam_ms[1]:.1f} ms, greedy {greedy_ms:.1f} ms; best "
          f"hypotheses of {[r['n_sampled'] for r in out]} tokens [{card}]")

    # int8 against bf16 self pages: one window through two one-slot beam
    # pools on the same engine (printed, not gated)
    pcm = (np.clip(_speech(5.12, seed=7), -1, 1) * 32767).astype(np.int16)
    prompt = list(inner.tokenizer.sot_sequence("en"))
    drift = []
    for self_int8 in (False, True):
        p = BeamSlotPool(inner, 1, pool.t_mel, pool.max_new, beam_size=BEAM_SIZE,
                         self_int8=self_int8)
        job = _StreamJob(pcm, prompt, is_audio=True)
        p.admit_many([job])
        while p.jobs:
            p.step()
        drift.append(job.future.result())
        del p
    a, b = drift
    same = 0
    while same < min(a["n_sampled"], b["n_sampled"]) and a["tokens"][same] == b["tokens"][same]:
        same += 1
    print(f"beam int8 pages: one 5 s window, best hypothesis with bf16 pages {a['n_sampled']} "
          f"tokens, sum_logprob {a['sum_logprob']:.4f}; with int8 pages {b['n_sampled']} tokens, "
          f"sum_logprob {b['sum_logprob']:.4f}; first {same} tokens equal; first 8: "
          f"{[int(t) for t in a['tokens'][:8]]} / {[int(t) for t in b['tokens'][:8]]} "
          f"[{card}]")
    _stop(engine)
    return launches


def _int8_window(card: str) -> int:
    """One 30 s window on an engine with int8 decoder weights, int8
    cross-KV and int8 self-KV (128 new tokens after a 3-token prompt: past
    one 128-column page, so self-KV is not skipped), checked to run those
    paths and to finish with finite results. Returns its flash launches."""
    import numpy as np
    import torch

    from speaksense_tpu_torch.asr.engine import WhisperEngine
    from speaksense_tpu_torch.config import EngineConfig
    from speaksense_tpu_torch.models import decode as D
    from speaksense_tpu_torch.models import whisper as W
    from speaksense_tpu_torch.ops import flash as F

    q8cfg = EngineConfig(weights_int8=True, cross_kv_int8=True, self_kv_int8=True, **NEUTRAL)
    t0 = time.perf_counter()
    q8 = WhisperEngine.from_random("large-v3", config=q8cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    assert W.weights_are_int8(q8.model)
    flags: list = []
    real_tw = D.transcribe_window

    def recording_transcribe_window(*a, **kw):
        flags.append((kw["cross_kv_int8"], kw["self_kv_int8"]))
        return real_tw(*a, **kw)

    D.transcribe_window = recording_transcribe_window
    n_encode, restore = _count_encodes(W)
    F.flash_attention_full.launches = 0
    try:
        mel = q8.compute_mel(_speech(30, seed=700))
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = q8.decode_windows(mel, "en", max_new_tokens=128)[0]
        q8_ms = 1e3 * (time.perf_counter() - t)
    finally:
        n = F.flash_attention_full.launches
        restore()
        D.transcribe_window = real_tw
    L = q8.dims.n_audio_layer
    assert flags == [(True, True)], flags
    assert n == L * n_encode[0] == L, (n, n_encode[0])
    assert _first_token_ok(r, q8._rule_config(True, 128)) and np.isfinite(r["avg_logprob"]), r
    print(f"beam int8 window: engine with int8 decoder weights, int8 cross-KV and int8 self-KV "
          f"built in {build_s:.1f} s ({torch.cuda.memory_allocated() / 2**30:.2f} GiB); one 30 s "
          f"window, {r['n_sampled']} tokens in {q8_ms:.1f} ms, avg_logprob "
          f"{r['avg_logprob']:.4f}, {n} flash kernel launches [{card}]")
    del q8
    _free_device()
    return n


# Gradients of the full-depth encoder, kernels against plain attention: the
# two forwards already differ by 2e-3 of the output's RMS (ENC_REL_BOUND's
# reasons), and each layer's backward adds the bf16 attention gradients'
# own difference (a few 1e-3 relative L2 per layer, GRAD_REL in the sweep
# tool), carried through 32 layers of f32 residuals; 10% of the gradient's
# norm leaves room for that and still catches a wrong kernel, which would
# decorrelate the two runs (relative error near 1.4).
ENC_GRAD_REL_BOUND = 1e-1


def _profiled_device_ms(fn, top: list | None = None) -> float | None:
    """Summed kernel time of fn() (the profiler's device activity). None
    when the profiler saw no device time. A `top` list receives the six
    largest kernels as (name, ms, launches)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy = sum(e.self_device_time_total for e in events)
    if top is not None:
        events.sort(key=lambda e: -e.self_device_time_total)
        top.extend((e.key, e.self_device_time_total / 1e3, e.count) for e in events[:6])
    return busy / 1e3 if busy > 0 else None


def phase_grad(card: str, engine) -> dict:
    """Drive the gradient path: `W.encode(..., grad=True)` at large-v3 width
    and full depth on 2 windows of 30 s, one backward from a seeded f32
    cotangent to the mel and to the first, a middle and the last encoder
    block's parameters; then one transcribe call on the same engine.
    Returns the kernels' launch counts of the drive."""
    import numpy as np
    import torch

    from speaksense_tpu_torch.models import whisper as W
    from speaksense_tpu_torch.ops import flash as F

    inner = engine.engine
    model, dims = inner.model, inner.dims
    L = dims.n_audio_layer
    names = ("mel",) + tuple(f"blocks.{i}.{n}" for i in (0, L // 2, L - 1)
                             for n, _ in model.encoder.blocks[i].named_parameters())
    params = [p for i in (0, L // 2, L - 1) for p in model.encoder.blocks[i].parameters()]
    mel2 = inner.compute_mel(np.stack([_speech(30, seed=300 + i) for i in range(2)]))
    assert mel2.shape == (2, 3000, dims.n_mels) and mel2.is_cuda, mel2.shape
    gen = torch.Generator(device=mel2.device).manual_seed(7)
    cot2 = torch.randn((2, dims.n_audio_ctx, dims.n_audio_state), generator=gen,
                       device=mel2.device, dtype=torch.float32)
    _free_device()
    base = torch.cuda.memory_allocated()

    def run(mel, cot, device_time: bool = False):
        """One forward with the graph recorded and one backward. Returns
        (gradients, forward ms, backward ms, peak bytes): host clock to a
        synchronize, or the profiler's summed kernel time."""
        for p in params:
            p.requires_grad_(True)
        try:
            m = mel.detach().clone().requires_grad_(True)
            torch.cuda.reset_peak_memory_stats()
            state = {}

            def forward():
                state["out"] = W.encode(model, m, grad=True)

            def backward():
                state["grads"] = torch.autograd.grad(state["out"], (m, *params), cot)

            times = []
            for step in (forward, backward):
                if device_time:
                    times.append(_profiled_device_ms(step))
                else:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    step()
                    torch.cuda.synchronize()
                    times.append(1e3 * (time.perf_counter() - t0))
            out = state["out"]
            assert out.shape == cot.shape and out.dtype == torch.float32 and out.requires_grad
            return state["grads"], times[0], times[1], torch.cuda.max_memory_allocated()
        finally:
            for p in params:
                p.requires_grad_(False)

    # the drive: B = 2, full depth, counts from zero
    F.reset_launch_counts()
    grads, fwd_ms, bwd_ms, peak = run(mel2, cot2)
    counts = F.launch_counts()
    assert counts == {"flash_attn_fwd": L, "flash_attn_bwd_delta": L,
                      "flash_attn_bwd_dkdv": L, "flash_attn_bwd_dq": L}, counts
    # delta and dQ came from one kernel: L launches of it, none standalone
    fused = (F.flash_bwd_dq_delta.launches, F.flash_bwd_delta.launches, F.flash_bwd_dq.launches)
    assert fused == (L, 0, 0), fused
    assert len(grads) == len(names) == 1 + 3 * 12, (len(grads), len(names))
    for name, g in zip(names, grads):
        assert torch.isfinite(g).all().item(), f"non-finite gradient of {name}"
        assert g.abs().max().item() > 0, f"zero gradient of {name}"
    assert grads[0].shape == mel2.shape and grads[0].dtype == torch.float32
    print(f"grad: encode with grad at large-v3 width, {L} layers, 2 windows of 30 s: forward "
          f"{fwd_ms:.2f} ms, backward {bwd_ms:.2f} ms (host clock to a synchronize, first call); "
          f"{counts['flash_attn_fwd']} forward and {fused[0]} dQ-with-delta + "
          f"{counts['flash_attn_bwd_dkdv']} dK/dV backward kernel launches (no standalone "
          f"delta); {len(grads)} gradients (mel and 3 blocks' parameters) finite and "
          f"non-zero; peak memory {peak / 2**30:.2f} GiB, {(peak - base) / 2**30:.2f} GiB "
          f"above the engine's {base / 2**30:.2f} GiB [{card}]")
    del grads
    _, fwd_ms, bwd_ms, _ = run(mel2, cot2)
    _, fwd_dev, bwd_dev, _ = run(mel2, cot2, device_time=True)
    dev_text = ("device time not measured (the profiler saw no device time)"
                if fwd_dev is None or bwd_dev is None else
                f"device busy forward {fwd_dev:.2f} ms, backward {bwd_dev:.2f} ms")
    print(f"grad: second call: forward {fwd_ms:.2f} ms, backward {bwd_ms:.2f} ms (host clock); "
          f"{dev_text} [{card}]")

    # the same encoder with the plain attention: one window, then two if
    # the plain version's saved (B, 20, 1500, 1500) tensors fit
    def plain(mel, cot):
        W.flash_attention_full = F.flash_attention_ref
        try:
            return run(mel, cot)
        finally:
            W.flash_attention_full = F.flash_attention_full

    got, _, _, peak1 = run(mel2[:1], cot2[:1])
    want, pf_ms, pb_ms, plain_peak1 = plain(mel2[:1], cot2[:1])
    worst = 0.0
    for name, g, w in zip(names, got, want):
        rel = ((g.float() - w.float()).norm() / w.float().norm()).item()
        assert rel <= ENC_GRAD_REL_BOUND, (name, rel)
        worst = max(worst, rel)
    rel_mel = ((got[0] - want[0]).norm() / want[0].norm()).item()
    print(f"grad: full depth at B = 1, kernels vs plain attention: relative L2 of the mel "
          f"gradient {rel_mel:.3e}, worst of {len(names)} gradients {worst:.3e} "
          f"(bound {ENC_GRAD_REL_BOUND}); plain forward {pf_ms:.2f} ms, backward {pb_ms:.2f} ms; "
          f"peak memory {peak1 / 2**30:.2f} GiB with the kernels, {plain_peak1 / 2**30:.2f} GiB "
          f"with plain attention [{card}]")
    del got, want
    _free_device()
    need = base + 2 * (plain_peak1 - base)
    total = torch.cuda.get_device_properties(0).total_memory
    if need <= 0.85 * total:
        _, pf_ms, pb_ms, plain_peak2 = plain(mel2, cot2)
        print(f"grad: full depth at B = 2 with plain attention: forward {pf_ms:.2f} ms, backward "
              f"{pb_ms:.2f} ms, peak memory {plain_peak2 / 2**30:.2f} GiB against "
              f"{peak / 2**30:.2f} GiB with the kernels [{card}]")
    else:
        print(f"grad: plain attention at B = 2 would need about {need / 2**30:.1f} GiB of "
              f"{total / 2**30:.1f}: not run")
    _free_device()

    # serving on the same engine afterwards: nothing left requiring grad, no
    # graph kept alive, and the forward's launch arithmetic as before
    assert not any(p.requires_grad for p in model.parameters())
    assert all(p.grad is None for p in model.parameters())
    held = torch.cuda.memory_allocated() - base
    assert held <= 256 * 2**20, f"{held / 2**20:.0f} MiB still held after the gradient runs"
    base_cfg = inner.config
    inner.config = dataclasses.replace(base_cfg, logprob_thold=-1e9, entropy_thold=-1.0,
                                       compression_ratio_thold=1e9)
    n_encode, restore = _count_encodes(W)
    F.reset_launch_counts()
    try:
        results, wall = _transcribe_concurrently(engine, [_speech(30, seed=400)])
    finally:
        served = F.launch_counts()
        restore()
        inner.config = base_cfg
    assert n_encode[0] >= 1 and served["flash_attn_fwd"] == L * n_encode[0], (served, n_encode[0])
    assert served["flash_attn_bwd_delta"] == served["flash_attn_bwd_dkdv"] == \
        served["flash_attn_bwd_dq"] == 0, served
    print(f"grad: one transcribe call on the same engine afterwards: {wall:.2f} s, "
          f"{results[0].n_tokens} tokens, {n_encode[0]} encodes, {served['flash_attn_fwd']} "
          f"forward launches, no backward launch [{card}]")
    counts["flash_attn_fwd"] += served["flash_attn_fwd"]
    return counts


# the device alignment matrix against numpy's float64 evaluation of the same
# f32 weights; numpy's f32 evaluation, printed beside it, carries its own
# rounding, up to about 1e-5 where a frame's weights barely vary
WORDS_MATRIX_ATOL = 1e-5
# heads per upper-half layer given to the numpy reference (16 layers x 2 = 32
# of the 320 heads), so its host median filter stays a few seconds
HOST_CHECK_HEADS = 2


def _gapped_speech(seed: int):
    """67.5 s at 16 kHz: 34 s of pseudo-speech, 4 s of silence, 14 s, 3.5 s of
    silence, 12 s: three VAD spans, the first of two windows."""
    import numpy as np

    def silence(seconds):
        return np.zeros(int(16000 * seconds), np.float32)

    return np.concatenate([_speech(34, seed), silence(4), _speech(14, seed + 1), silence(3.5),
                           _speech(12, seed + 2)])


def _staged(fn, times: list, peaks: list, high: list, events: bool = True):
    """fn wrapped to append its time in ms to times (CUDA events, or the host
    clock when events is False) and to peaks the device memory it allocated
    at its peak beyond what was allocated when it started. Each call resets
    the device's peak counter, so high[0] keeps the highest peak seen."""
    import torch

    def staged(*args, **kwargs):
        high[0] = max(high[0], torch.cuda.max_memory_allocated())
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) if events else 1e3 * (time.perf_counter() - t0))
        peak = torch.cuda.max_memory_allocated()
        peaks.append(peak - base)
        high[0] = max(high[0], peak)
        return out

    return staged


def phase_words(card: str, engine) -> int:
    """Drive VAD segmentation and word timestamps through the window
    batcher: `BatchedEngine.transcribe_audio_vad` with word timestamps on
    67.5 s of gapped pseudo-speech (three spans, four windows or more), the
    ladder neutralized, and a vocab whose pieces start with a space in
    place of the synthetic one (the same special tokens; its pieces have no
    spaces, which makes a window one word). Checks the spans, every
    segment's words and the forward
    kernel's launches (32 per decode encode, 32 more per aligned window),
    prints each window's stage times, holds the device alignment matrix of
    one window against the numpy one, then runs the host DSP. Returns the
    forward kernel's launches."""
    import numpy as np
    import torch

    from speaksense_tpu_torch.asr import AsrParams
    from speaksense_tpu_torch.audio.vad import speech_segments
    from speaksense_tpu_torch.models import align as A
    from speaksense_tpu_torch.models import whisper as W
    from speaksense_tpu_torch.models.tokenizer import Tokenizer
    from speaksense_tpu_torch.ops import flash as F

    inner = engine.engine
    dims = inner.dims
    synthetic = inner.tokenizer
    spaced = Tokenizer.from_vocab([b" w%d" % i for i in range(50257)]
                                  + [b""] * (dims.n_vocab - 50257))
    assert (spaced.sot_sequence("en"), spaced.eot, spaced.ts_begin) == (
        synthetic.sot_sequence("en"), synthetic.eot, synthetic.ts_begin)
    audio = _gapped_speech(seed=500)
    spans = speech_segments(audio)
    assert len(spans) == 3, spans
    t = {k: [] for k in ("decode", "encode", "cross", "matrix", "dtw", "bytes")}
    mem = {k: [] for k in ("decode", "encode", "cross", "matrix")}
    high = [0]
    span_sizes, aligned, n_encode = [], [], {"decode": 0, "align": 0}
    aligning = [False]
    real = {"encode": W.encode, "word_timestamps": A.word_timestamps,
            "cross": A.cross_attention_weights, "matrix": A._alignment_matrix_torch,
            "dtw": A.dtw_path, "decode": inner.decode_windows,
            "transcribe": inner.transcribe_audio, "attach": inner._attach_words}
    # the stages' wrappers below call these
    timed_encode = _staged(real["encode"], t["encode"], mem["encode"], high)
    timed_matrix = _staged(real["matrix"], t["matrix"], mem["matrix"], high)

    def encode(*args, **kwargs):
        if aligning[0]:
            n_encode["align"] += 1
            return timed_encode(*args, **kwargs)
        n_encode["decode"] += 1
        return real["encode"](*args, **kwargs)

    decode_windows = _staged(real["decode"], t["decode"], mem["decode"], high, events=False)

    def transcribe_audio(audio, params, decode_window=None):
        span_sizes.append(audio.size)
        return real["transcribe"](audio, params, decode_window)

    def attach_words(*args, **kwargs):
        aligning[0] = True
        try:
            return real["attach"](*args, **kwargs)
        finally:
            aligning[0] = False

    def word_timestamps(model, tok, tokens, enc, **kwargs):
        words = real["word_timestamps"](model, tok, tokens, enc, **kwargs)
        aligned.append(dict(tokens=tokens, enc=enc, kw=kwargs, words=words))
        return words

    def alignment_matrix(*args):
        out = timed_matrix(*args)
        t["bytes"].append(out.numel() * out.element_size())
        return out

    def dtw(cost):
        t0 = time.perf_counter()
        out = real["dtw"](cost)
        t["dtw"].append(1e3 * (time.perf_counter() - t0))
        return out

    base_cfg = inner.config
    modules = [(W, "encode", encode), (A, "word_timestamps", word_timestamps),
               (A, "dtw_path", dtw), (A, "_alignment_matrix_torch", alignment_matrix),
               (A, "cross_attention_weights",
                _staged(real["cross"], t["cross"], mem["cross"], high))]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in modules]
    for mod, name, fn in modules:
        setattr(mod, name, fn)
    inner.decode_windows, inner.transcribe_audio = decode_windows, transcribe_audio
    inner._attach_words = attach_words
    inner.config = dataclasses.replace(base_cfg, **NEUTRAL)
    inner.tokenizer = spaced
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    F.flash_attention_full.launches = 0
    try:
        t0 = time.perf_counter()
        result = engine.transcribe_audio_vad(audio, AsrParams(language="en",
                                                              word_timestamps=True))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        launches = F.flash_attention_full.launches
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        del inner.decode_windows, inner.transcribe_audio, inner._attach_words
        inner.config, inner.tokenizer = base_cfg, synthetic
    peak = max(high[0], torch.cuda.max_memory_allocated())

    # the spans are the VAD's, and each segment's words lie in its span
    assert span_sizes == [e - s for s, e in spans], (span_sizes, spans)
    windows = len(t["decode"])
    assert windows >= 4 and len(aligned) == n_encode["align"] >= 3, (windows, len(aligned))
    assert launches == dims.n_audio_layer * (n_encode["decode"] + n_encode["align"]), (
        launches, n_encode)
    assert n_encode["decode"] == windows, (n_encode, windows)
    secs = [(s / 16000, e / 16000) for s, e in spans]
    n_words = 0
    for seg in result.segments:
        assert seg.words is not None, seg
        lo, hi = next(span for span in secs if span[0] - 1e-6 <= seg.start <= span[1] + 1e-6)
        for w in seg.words:
            assert lo - 1e-3 <= w["start"] <= w["end"] <= hi + 1e-3, (w, lo, hi)
        n_words += len(seg.words)
    assert result.language == "en" and n_words > 0, (result.language, n_words)
    for a in aligned:
        starts = [w["start"] for w in a["words"]]
        assert starts == sorted(starts) and all(w["start"] <= w["end"] for w in a["words"])
    n_text = [sum(tok < inner.tokenizer.eot for tok in a["tokens"]) for a in aligned]
    print(f"words: transcribe_audio_vad of {audio.size / 16000:.1f} s (3 spans of "
          f"{', '.join(f'{b - a:.2f}' for a, b in secs)} s) with word timestamps in "
          f"{wall:.2f} s: {windows} windows decoded, {len(aligned)} aligned "
          f"({n_text} text tokens), {len(result.segments)} segments, {n_words} words; "
          f"{n_encode['decode']} decode + {n_encode['align']} align encodes, {launches} flash "
          f"kernel launches; peak memory {peak / 2**30:.2f} GiB, "
          f"{(peak - resident) / 2**30:.2f} GiB above the engine's resident "
          f"{resident / 2**30:.2f} GiB [{card}]")

    def gib(x):
        return f"+{x / 2**30:.3f} GiB"

    print(f"words: per window, decode (host clock, B = 1, 48 new tokens at most) ms "
          f"{[round(x, 2) for x in t['decode']]}, its peak memory "
          f"{[gib(x) for x in mem['decode']]} [{card}]")
    for i in range(len(aligned)):
        print(f"words: aligned window {i}: align encode {t['encode'][i]:.2f} ms "
              f"({gib(mem['encode'][i])}), cross_attention_weights {t['cross'][i]:.2f} ms "
              f"({gib(mem['cross'][i])}), device alignment matrix {t['matrix'][i]:.2f} ms "
              f"({gib(mem['matrix'][i])}) (CUDA events; peak memory beyond the stage's "
              f"start), host DTW {t['dtw'][i]:.2f} ms, {t['bytes'][i]} bytes to the host "
              f"[{card}]")

    # the largest window's device alignment matrix against the numpy one on
    # the same weights, copied to the host, over HOST_CHECK_HEADS heads of
    # each layer; and the device matrix's own memory at every head
    a = max(aligned, key=lambda a: t["bytes"][aligned.index(a)])
    prefix = inner.tokenizer.sot_sequence("en", timestamps=False)
    text = [tok for tok in a["tokens"] if tok < inner.tokenizer.eot]
    forced = torch.as_tensor([prefix + text + [inner.tokenizer.eot]], device=a["enc"].device)
    all_heads = A.cross_attention_weights(inner.model, forced, a["enc"])[
        :, 0, :, len(prefix):len(prefix) + len(text)]
    n_frames = min(dims.n_audio_ctx, int(a["kw"]["audio_seconds"] * A.FRAMES_PER_SECOND))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    A._alignment_matrix_torch(all_heads, n_frames)
    matrix_peak = torch.cuda.max_memory_allocated() - before
    weights = all_heads[:, :HOST_CHECK_HEADS]
    dev = A._alignment_matrix_torch(weights, n_frames).cpu().numpy()
    host_w = weights.cpu().numpy()
    t0 = time.perf_counter()
    ref32 = A._alignment_matrix(host_w, n_frames)
    host_s = time.perf_counter() - t0
    ref = A._alignment_matrix(host_w.astype(np.float64), n_frames)
    err = float(np.abs(dev - ref).max())
    assert dev.shape == ref.shape == (len(text), n_frames) and np.isfinite(dev).all()
    print(f"words: alignment matrix ({len(text)}, {n_frames}) over "
          f"{HOST_CHECK_HEADS * (dims.n_text_layer - dims.n_text_layer // 2)} upper-half heads, "
          f"device against numpy on the host (float64 evaluation of the same f32 weights): "
          f"max_abs_err {err:.3e} (bound {WORDS_MATRIX_ATOL}); against numpy in f32 "
          f"{float(np.abs(dev - ref32).max()):.3e}; numpy f32 host time at those heads "
          f"{1e3 * host_s:.1f} ms; "
          f"the device matrix at all {all_heads.shape[0] // 2 * all_heads.shape[1]} heads "
          f"allocates {matrix_peak / 2**30:.2f} GiB at its peak beyond its "
          f"{all_heads.numel() * 4 / 2**30:.2f} GiB of weights [{card}]")
    assert err <= WORDS_MATRIX_ATOL, err
    _host_dsp(card)
    return launches


def _host_dsp(card: str) -> None:
    """The host-DSP modules on one 44.1 kHz stereo WAV: the streaming file
    parser in process, and the port's CLI `quality`, `voiceprint
    --compare-with`, `emotion` and `denoise` in subprocesses (started
    together), each checked against the same call in process."""
    import numpy as np

    from speaksense_tpu_torch.audio.dsp import DenoiseConfig
    from speaksense_tpu_torch.audio.emotion import LABELS, classify_emotion
    from speaksense_tpu_torch.audio.io import load_audio, parse_audio_file_stream, write_wav
    from speaksense_tpu_torch.audio.quality import evaluate_audio_quality
    from speaksense_tpu_torch.audio.resample import resample
    from speaksense_tpu_torch.audio.voiceprint import cosine_similarity, voiceprint_embedding

    with tempfile.TemporaryDirectory() as tmp:
        left = resample(_speech(10, seed=600), 16000, 44100)
        right = 0.6 * left + 0.01 * np.random.default_rng(601).standard_normal(left.size)
        stereo = Path(tmp) / "stereo.wav"
        write_wav(stereo, np.stack([left, right], 1).reshape(-1), rate=44100, channels=2)
        other = Path(tmp) / "other.wav"
        write_wav(other, _speech(6, seed=602))
        clean = Path(tmp) / "clean.wav"
        t0 = time.perf_counter()
        frames: list = []
        parse_audio_file_stream(stereo, DenoiseConfig(), frames.append)
        parse_s = time.perf_counter() - t0
        mono = load_audio(stereo)
        assert len(frames) == -(-mono.size // 2048), (len(frames), mono.size)
        assert all(f.shape == (2048,) and np.isfinite(f).all() for f in frames)
        commands = {"quality": [str(stereo)], "voiceprint": [str(stereo), "--compare-with",
                                                              str(other)],
                    "emotion": [str(stereo)], "denoise": [str(stereo), "--output", str(clean)]}
        t0 = time.perf_counter()
        procs = {name: subprocess.Popen(
            [sys.executable, "-m", "speaksense_tpu_torch.cli", name, *args], cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for name, args in commands.items()}
        out = {}
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=300)
            assert proc.returncode == 0, (name, stderr[-2000:])
            out[name] = stdout
        cli_s = time.perf_counter() - t0
        assert json.loads(out["quality"]) == evaluate_audio_quality(mono).to_dict()
        vp = json.loads(out["voiceprint"])
        sim = cosine_similarity(voiceprint_embedding(mono), voiceprint_embedding(load_audio(other)))
        assert vp["similarity"] == round(sim, 6) and vp["match"] is (sim >= vp["threshold"]), vp
        emo = json.loads(out["emotion"])
        label, feats = classify_emotion(mono)
        assert emo == {"emotion": label, "features": feats.to_dict()} and label in LABELS, emo
        assert out["denoise"].strip() == str(clean) and load_audio(clean).size == mono.size
    print(f"words: host DSP: parse_audio_file_stream of 10 s of 44.1 kHz stereo, "
          f"{len(frames)} frames, in {1e3 * parse_s:.1f} ms; CLI quality, voiceprint "
          f"--compare-with (similarity {vp['similarity']}), emotion ({label}) and denoise in "
          f"four processes together, {cli_s:.1f} s [{card}]")


SERVE_DEADLINE_S = 50.0
# modules of the front doors: the GPU image has none of them, and the task
# path must not need them
SERVER_PACKAGES = ("aiohttp", "grpc", "google.protobuf", "requests")


def _loaded(roots) -> list:
    """The loaded modules under any of `roots`, sorted."""
    return sorted(m for m in sys.modules
                  if any(m == r or m.startswith(r + ".") for r in roots))


class _Loopback:
    """A loopback HTTP server over a directory: GET serves its files (404
    for any other path), POST records the JSON body by path (the HTTP
    callbacks of the tasks)."""

    def __init__(self, root: Path):
        import http.server

        self.posts: dict[str, list] = {}
        posts = self.posts

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                path = root / self.path.lstrip("/")
                body = path.read_bytes() if path.is_file() else None
                self.send_response(200 if body is not None else 404)
                self.end_headers()
                self.wfile.write(body or b"not found")

            def do_POST(self):
                body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
                posts.setdefault(self.path, []).append(body)
                self.send_response(200)
                self.end_headers()

            def log_message(self, *args):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(5)


def phase_serve(card: str, engine) -> int:
    """Drive the REST task path on the shared engine as a server built by
    `main.build_context` serves it: the SQLite stores, auth, the task
    manager and 2 Transcribe workers (with the noise-reduction and voiceprint
    workers) over the window batcher, inputs downloaded and callbacks posted
    over a loopback HTTP server. Four tasks, made as the REST routes make
    them: (a) 30 s by URL with a callback, (b) the same audio by local path
    with emotion labels and the dirty-word filter, (c) a URL that answers
    404 (retried, then failed, its callback carrying the error), (d) noise
    reduction of a 10 s WAV (`/schedule/tasks` JSON). The ladder is
    neutralized (random weights would climb all of it). Checks the terminal
    states, results, callbacks, the key's usage, the stats and the forward
    kernel's launches (32 per encode). Returns those launches."""
    import numpy as np

    from speaksense_tpu_torch.audio.dsp import DenoiseConfig, denoise_audio
    from speaksense_tpu_torch.audio.emotion import LABELS
    from speaksense_tpu_torch.audio.io import load_audio, write_wav
    from speaksense_tpu_torch.auth import Permission, RateLimit
    from speaksense_tpu_torch.config import Config
    from speaksense_tpu_torch.main import build_context
    from speaksense_tpu_torch.models import whisper as W
    from speaksense_tpu_torch.ops import flash as F
    from speaksense_tpu_torch.schedule.types import (
        CallbackType, PathType, TaskConfig, TaskParams, TaskPriority, TaskType,
        TranscribeParams,
    )

    t_phase = time.perf_counter()
    inner = engine.engine
    tmp = Path(tempfile.mkdtemp(prefix="serve-"))
    speech = _speech(30.0, seed=900)
    write_wav(tmp / "speech.wav", speech)
    write_wav(tmp / "noisy.wav", speech[:16000 * 10]
              + 0.05 * np.random.default_rng(901).standard_normal(16000 * 10).astype(np.float32))
    files = tmp / "files"
    files.mkdir()
    shutil.copy(tmp / "speech.wav", files / "speech.wav")
    web = _Loopback(files)
    config = Config(sqlite_path=f"sqlite://{tmp}/storage.db", audio_path=str(tmp / "audio"))
    config.task_workers = 2
    base_cfg = inner.config
    inner.config = dataclasses.replace(base_cfg, **NEUTRAL)
    windows0 = engine.windows_run
    n_encode, restore = _count_encodes(W)
    F.flash_attention_full.launches = 0
    ctx = scheduler = None
    try:
        ctx, scheduler = build_context(config, engine)
        manager, auth = ctx.task_manager, ctx.auth
        # a key as POST /auth/api-keys makes it
        key = auth.create_api_key("smoke", [Permission(p) for p in ["Transcribe"]],
                                  RateLimit.from_json({"requests_per_minute": 60}),
                                  None).key

        def rest_transcribe(req: dict):
            """POST /asr/transcribe's verify and TaskConfig (rest.py)."""
            auth.verify_api_key(f"Bearer {key}", Permission.TRANSCRIBE)
            return manager.create_task(TaskConfig(
                task_type=TaskType.TRANSCRIBE, input_path=req["path"],
                path_type=PathType(req.get("path_type", "Url")),
                callback_type=CallbackType.http(req["callback_url"]),
                params=TaskParams.transcribe(TranscribeParams(
                    language=req.get("language"),
                    emotion_recognition=bool(req.get("emotion_recognition", False)),
                    filter_dirty_words=bool(req.get("filter_dirty_words", False)))),
                priority=TaskPriority.NORMAL, retry_count=0, max_retries=3, timeout=None,
                api_key=key)).id

        ids = {
            "a": rest_transcribe({"path": f"{web.url}/speech.wav", "language": "en",
                                  "callback_url": f"{web.url}/cb/a"}),
            "b": rest_transcribe({"path": str(tmp / "speech.wav"), "path_type": "Local",
                                  "language": "en", "emotion_recognition": True,
                                  "filter_dirty_words": True,
                                  "callback_url": f"{web.url}/cb/b"}),
            "c": rest_transcribe({"path": f"{web.url}/missing.wav", "language": "en",
                                  "callback_url": f"{web.url}/cb/c"}),
            # POST /schedule/tasks: the TaskConfig JSON, api_key dropped
            "d": manager.create_task(TaskConfig.from_json({
                "task_type": "NoiseReduction", "input_path": str(tmp / "noisy.wav"),
                "path_type": "Local", "params": {"type": "NoiseReduction", "params": {}},
                "callback_type": {"type": "Http", "config": {"url": f"{web.url}/cb/d"}}})).id,
        }
        want = {"a": "Completed", "b": "Completed", "c": "Failed", "d": "Completed"}
        deadline = t_phase + SERVE_DEADLINE_S
        while True:
            tasks = {k: manager.get_task(v) for k, v in ids.items()}
            terminal = {k: t.status.kind for k, t in tasks.items()
                        if t.status.kind in ("Completed", "Failed", "TimedOut")}
            if len(terminal) == len(ids) and all(web.posts.get(f"/cb/{k}") for k in ids):
                break
            if time.perf_counter() > deadline:
                raise RuntimeError(f"serve: tasks not terminal or callbacks missing after "
                                   f"{SERVE_DEADLINE_S} s: {terminal}, callbacks "
                                   f"{sorted(web.posts)}")
            time.sleep(0.05)
        stats = dict(manager.get_task_stats())
        usage = auth.get_key_stats(key)
    finally:
        launches = F.flash_attention_full.launches
        restore()
        inner.config = base_cfg
        if scheduler is not None:
            scheduler.stop()
        if ctx is not None:
            ctx.task_manager.storage.close()
            ctx.auth.key_storage.close()
        web.close()
    windows = engine.windows_run - windows0

    assert terminal == want, terminal
    for k in ("a", "b"):
        r = tasks[k].result.result
        assert r.segments and r.n_tokens > 0 and r.audio_seconds == 30.0, (k, r)
        assert all(0.0 <= s.start_time <= s.end_time <= 30.0 + 1e-6 for s in r.segments), k
    # a segment gets its label where it spans audio (its samples lo < hi)
    voiced = [s for s in tasks["b"].result.result.segments
              if int(s.end_time * 16000) > int(s.start_time * 16000)]
    assert voiced and all(s.emotion in LABELS for s in voiced), tasks["b"].result.result
    assert tasks["a"].result.result.segments[0].emotion is None
    assert "404" in tasks["c"].error and tasks["c"].config.retry_count == 4, tasks["c"].error
    out = load_audio(Path(tasks["d"].result.result["output_path"]))
    # the processor's output against the same DSP called directly, through
    # the same 16-bit WAV round trip
    write_wav(tmp / "ref.wav", denoise_audio(load_audio(tmp / "noisy.wav"),
                                             DenoiseConfig(post_gain=1.0)))
    ref = load_audio(tmp / "ref.wav")
    assert out.shape == ref.shape == (16000 * 10,) and np.isfinite(out).all()
    assert np.array_equal(out, ref), float(np.abs(out - ref).max())
    for k in ids:
        posted = web.posts[f"/cb/{k}"]
        assert len(posted) == 1 and posted[0]["task_id"] == ids[k], (k, posted)
        assert posted[0]["status"] == tasks[k].status.to_json(), (k, posted)
    assert web.posts["/cb/c"][0]["data"] == tasks["c"].error
    assert web.posts["/cb/a"][0]["data"] == tasks["a"].result.to_json()
    assert usage.total_audio_seconds == 60.0 and usage.total_requests == 3, usage
    assert usage.total_tokens == sum(tasks[k].result.result.n_tokens for k in ("a", "b"))
    assert stats == {"Completed": 3, "Failed": 1}, stats
    assert n_encode[0] >= 1 and launches == inner.dims.n_audio_layer * n_encode[0], (
        launches, n_encode[0])
    assert windows >= 2, windows
    shutil.rmtree(tmp, ignore_errors=True)
    for k, t in tasks.items():
        end = t.completed_at or t.updated_at
        print(f"serve: task {k} ({t.config.task_type}, {t.config.path_type.value}) "
              f"{t.status.kind} {(end - t.created_at).total_seconds():.3f} s from queued to "
              f"terminal (host clock) [{card}]")
    print(f"serve: {windows} windows, {n_encode[0]} encoder calls, {launches} flash kernel "
          f"launches; the key's usage {usage.total_audio_seconds} s of audio, "
          f"{usage.total_tokens} tokens, {usage.total_requests} requests; stats {stats}; "
          f"phase wall {time.perf_counter() - t_phase:.2f} s [{card}]")
    assert not _loaded(SERVER_PACKAGES), _loaded(SERVER_PACKAGES)
    return launches


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


_BWD_SOURCE = "speaksense_tpu_torch/ops/csrc/flash_attn_bwd.cu"
_PALLAS_LIB = "jax/experimental/pallas/ops/tpu/flash_attention.py"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    all_phases = ("kernel", "main", "stream", "grad", "words", "serve", "beam", "ckpt")
    ap.add_argument("--phase", choices=all_phases + ("all",), default="all")
    args = ap.parse_args()
    phases = all_phases if args.phase == "all" else (args.phase,)

    import torch

    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the chip smoke test runs only on a GPU")

    from speaksense_tpu_torch.config import Config, EngineConfig
    from speaksense_tpu_torch.main import build_engine
    from speaksense_tpu_torch.ops import flash as F
    from speaksense_tpu_torch.tools import microbench_encattn as MB

    card = MB.card_name()
    print(card)
    start = [time.perf_counter()]

    def lap(what: str) -> None:
        """Print the wall time since the last lap (the script's limit is
        1200 s, build and every phase included)."""
        now = time.perf_counter()
        print(f"wall: {what} {now - start[0]:.1f} s [{card}]")
        start[0] = now

    t0 = time.perf_counter()
    so = F.build()
    print(f"build: {so.name} in {time.perf_counter() - t0:.1f} s")
    log = so.with_suffix(".log")
    if log.is_file():
        print(log.read_text().strip())
    # the record's shape is the 30 s window batch (8, 20, 1500, 64); the
    # backward kernels replace the Pallas library's kernels behind the
    # custom_vjp of speaksense_tpu/ops/flash.py:32 (delta is the `di` that
    # the library computes beside them). On the main path dQ's kernel
    # computes delta in its prologue: delta's launches, time and bound are
    # that launch's; `first_design_ms` and `own_bound_ms` are the standalone
    # kernel's, which only the first design runs
    shape = (8, 20, 1500, 64)
    blank = {"launches": None, "max_abs_err": None, "ms": None, "plain_ms": None,
             "bound_ms": None, "bound_by": None, "library_ms": None}
    records = {
        "flash_attn_fwd": {"name": "flash_attn_fwd", "route": "cuda",
                           "source": "speaksense_tpu_torch/ops/csrc/flash_attn_fwd.cu",
                           "replaces": "speaksense_tpu/ops/flash.py:32", **blank},
        "flash_attn_bwd_delta": {"name": "flash_attn_bwd_delta", "route": "cuda",
                                 "source": _BWD_SOURCE, "replaces": f"{_PALLAS_LIB}:273",
                                 "launched_by": "flash_attn_bwd_dq_delta_bf16 (its prologue), "
                                                "the launch of flash_attn_bwd_dq's record",
                                 **blank},
        "flash_attn_bwd_dkdv": {"name": "flash_attn_bwd_dkdv", "route": "cuda",
                                "source": _BWD_SOURCE, "replaces": f"{_PALLAS_LIB}:1121",
                                **blank},
        "flash_attn_bwd_dq": {"name": "flash_attn_bwd_dq", "route": "cuda",
                              "source": _BWD_SOURCE, "replaces": f"{_PALLAS_LIB}:1456",
                              **blank},
    }
    for name, bound in (("flash_attn_fwd", MB.bound_ms(shape, *MB.FWD_WORK)),
                        ("flash_attn_bwd_delta", MB.bound_ms(shape, *MB.DQ_DELTA_WORK)),
                        ("flash_attn_bwd_dkdv", MB.bound_ms(shape, *MB.DKDV_WORK)),
                        ("flash_attn_bwd_dq", MB.bound_ms(shape, *MB.DQ_DELTA_WORK))):
        records[name]["bound_ms"], records[name]["bound_by"] = bound
    if "kernel" in phases:
        records["flash_attn_fwd"].update(phase_kernel(card))
        for name, fields in phase_kernel_bwd(card).items():
            records[name].update(fields)
    lap("build and kernel phase")
    if set(phases) - {"kernel"}:
        for r in records.values():
            r["launches"] = 0

    def count(launches) -> None:
        """Add a phase's launches: a dict by kernel, or the forward's number."""
        if isinstance(launches, int):
            launches = {"flash_attn_fwd": launches}
        for name, n in launches.items():
            records[name]["launches"] += n

    if set(phases) & {"main", "stream", "grad", "words", "serve"}:
        config = Config()
        # max_new = max_decode_len // 2 = 48 tokens per window on the window
        # path, where random weights climb the whole ladder; every other
        # knob (bf16, max_batch_size 8, best_of 5, thresholds, 64 stream
        # slots of 96 tokens) is the default
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
                count(phase_main(card, engine, n_requests=2))
                lap("main phase")
            if "stream" in phases:
                count(phase_stream(card, engine))
                lap("stream phase")
            if "grad" in phases:
                count(phase_grad(card, engine))
                lap("grad phase")
            if "words" in phases:
                count(phase_words(card, engine))
                lap("words phase")
            if "serve" in phases:
                count(phase_serve(card, engine))
                lap("serve phase")
        finally:
            _stop(engine)
        del engine
        _free_device()
    if "beam" in phases:
        count(phase_beam(card))
        lap("beam phase")
    if "ckpt" in phases:
        count(phase_ckpt(card))
        lap("ckpt phase")
    leaked = _loaded(("jax", "jaxlib", "speaksense_tpu") + SERVER_PACKAGES)
    assert not leaked, leaked
    if args.phase == "all":
        never = [name for name, r in records.items() if not r["launches"]]
        assert not never, f"kernels never launched on the main paths: {never}"
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
