"""Slot-pool serving profile on the card: how much of a pool's work goes to
admissions, to pool decode steps and to the retirement fetch. The
counterpart of the repository's `tools/microbench_slots.py`.

Each program is timed apart at S slots, t_mel mel frames and max_new
tokens (default 64, 512, 96: the streaming bucket of BASELINE config 4):
  admit   one window's admission (encode t_mel with the flash kernel,
          cross-KV, prefill, the slot's rows written), averaged over the
          slots; and one admission of 8 windows;
  step    one pool-wide decode step with no retirement fetch (the device
          half, `SlotPool._device_step`), averaged over 32 steps to a
          synchronize;
  retire  the fetch of the packed per-slot results to the host after a
          step (`SlotPool._meta`, one copy), and the whole `SlotPool.step`
          (step, fetch, retirement) beside it.
For each: host ms, and from torch.profiler over one call the device busy
ms and the kernel launches. This is the tool a CUDA graph of the pool step
is measured with.

    python -m speaksense_tpu_torch.tools.microbench_slots [S] [t_mel] [max_new]
    python -m speaksense_tpu_torch.tools.microbench_slots 4 512 8 --device cpu

Flags: the positional S, t_mel and max_new as in the reference;
--model BENCH_MODEL (large-v3); --int8/--no-int8 SLOTS_INT8 (on: int8
cross-KV); --self-int8 (off: int8 self-KV pages and their ring, the beam
pools' default). No counterpart: the reference's k-steps-per-dispatch rows
(`step k=4/8/16`), an XLA workaround the port's pool does not copy. The
port's own: --seed, --device (cuda; no card raises), --out (the sidecar).
Random bf16 weights; device figures on the CPU are "not measured".
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from speaksense_tpu_torch.models import whisper as W
from speaksense_tpu_torch.tools import measure as M


def _timed(fn, device, n: int) -> float:
    """Host ms per call of n calls of fn, to a synchronize."""
    M.sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    M.sync(device)
    return 1e3 * (time.perf_counter() - t0) / n


def _window(pool) -> tuple:
    """One seeded window of the pool's t_mel frames, and the prompt."""
    mel = np.random.default_rng(0).standard_normal(
        (pool.t_mel, pool.dims.n_mels)).astype(np.float32)
    return mel, list(pool.engine.tokenizer.sot_sequence("en"))


def fill(pool) -> None:
    """Reset the pool and admit a window to every slot, 8 an admission."""
    from speaksense_tpu_torch.runtime.slots import _StreamJob

    mel, prompt = _window(pool)
    pool.reset()
    while pool.free:
        n = min(8, len(pool.free))
        assert pool.admit_many([_StreamJob(mel, prompt) for _ in range(n)]) == n


def _row(fn, device, host_ms: float) -> dict:
    prof = M.profile(fn, device)
    return {"host_ms": host_ms, **{k: prof[k] for k in
                                   ("device_busy_ms", "launches", "top_kernels")}}


def step_row(pool, device, n_steps: int = 32) -> dict:
    """Every slot busy, then pool steps with no retirement fetch (the device
    half, `SlotPool._device_step`): host ms per step over n_steps to a
    synchronize, and one step's device busy ms, launches and top kernels
    from torch.profiler. The slots stay admitted."""
    fill(pool)

    def device_step():
        pool._device_step(False, pool.ring_n)
        pool.total_steps += 1

    for _ in range(pool.RING_WIDTH + 1):            # every ring row, a flush included
        device_step()
    return _row(device_step, device, _timed(device_step, device, n_steps))


def measure(pool, device, n_steps: int = 32) -> dict:
    """The four measurements on a built pool (reset between them). Returns
    {name: {"host_ms", "device_busy_ms", "launches", "top_kernels"}}."""
    from speaksense_tpu_torch.runtime.slots import _StreamJob

    mel, prompt = _window(pool)

    def admit_one():
        assert pool.admit_many([_StreamJob(mel, prompt)]) == 1

    def admit_eight():
        assert pool.admit_many([_StreamJob(mel, prompt) for _ in range(8)]) == 8

    out = {}
    pool.reset()
    admit_one()                                     # warm-up
    n_adm = max(1, min(pool.S - 2, 16))
    out["admit"] = _row(admit_one, device, _timed(admit_one, device, n_adm))
    if pool.S >= 8 * 3:
        pool.reset()
        admit_eight()
        out["admit8"] = _row(admit_eight, device, _timed(admit_eight, device, 1))
    out["step"] = step_row(pool, device, n_steps)

    finished = pool._device_step(False, pool.ring_n)
    pool.total_steps += 1

    def fetch():
        torch.cat(pool._meta(finished), dim=1).cpu()

    out["retire"] = _row(fetch, device, _timed(fetch, device, 5))
    fill(pool)
    out["full_step"] = _row(pool.step, device, _timed(pool.step, device, n_steps // 4))
    pool.reset()
    return out


def main(argv=None, dims: W.WhisperDims | None = None) -> dict:
    from speaksense_tpu_torch.runtime.slots import SlotPool
    from speaksense_tpu_torch.tools.bench import _engine

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("S", type=int, nargs="?", default=64)
    ap.add_argument("t_mel", type=int, nargs="?", default=512)
    ap.add_argument("max_new", type=int, nargs="?", default=96)
    ap.add_argument("--model", default="large-v3", choices=tuple(W.MODEL_DIMS))
    ap.add_argument("--int8", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--self-int8", action=argparse.BooleanOptionalAction, default=False)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    device = M.resolve_device(args.device)
    dims = dims or W.MODEL_DIMS[args.model]
    engine = _engine(dims, device, args.seed, cross_kv_int8=True)
    pool = SlotPool(engine, n_slots=args.S, t_mel=args.t_mel, max_new=args.max_new,
                    int8_kv=args.int8, self_int8=args.self_int8)
    card = M.card(device)
    rows = measure(pool, device)
    for name, r in rows.items():
        top = "; ".join(f"{k[:50]} {ms:.3f} ms x{n}" for k, ms, n in r["top_kernels"][:4])
        print(f"slots {name:9s} host {r['host_ms']:8.3f} ms, device busy "
              f"{M.fmt_ms(r['device_busy_ms'])}, launches {r['launches']} "
              f"(S={args.S}, t_mel={args.t_mel}, max_new={args.max_new}, int8 cross-KV "
              f"{args.int8}, int8 self-KV {args.self_int8}) [{card}]"
              + (f"; top: {top}" if top else ""), flush=True)
    step_ms = rows["full_step"]["host_ms"]
    per_chunk = args.max_new * step_ms / args.S + rows["admit"]["host_ms"]
    result = {
        "metric": f"slot pool programs timed apart (S={args.S}, t_mel={args.t_mel}, "
                  f"max_new={args.max_new}; port, {device.type})",
        "rows": rows,
        "implied_chunk_ms": per_chunk,
        "implied_rtf": (args.t_mel * 160 / 16000.0) / (per_chunk / 1e3),
        **M.stamp(device), "note": M.RANDOM_WEIGHTS_NOTE,
    }
    short = {"step_host_ms": rows["step"]["host_ms"],
             "step_device_busy_ms": rows["step"]["device_busy_ms"],
             "step_launches": rows["step"]["launches"],
             "full_step_host_ms": step_ms, "admit_host_ms": rows["admit"]["host_ms"],
             "retire_host_ms": rows["retire"]["host_ms"]}
    result.update(short)
    return M.emit(result, ("metric",) + tuple(short) + ("card",), args.out, "microbench_slots")


if __name__ == "__main__":
    main()
