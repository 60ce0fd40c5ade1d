"""What the port's measurement tools share: the device they run on, the
card's name and power limit, a profiled run (host time, device busy time,
kernel launches, the largest kernels), best and median of repeated runs,
and the output (one short JSON line, the detail in a sidecar file).

No JAX counterpart: the JAX tools time with a device-to-host fetch and ask
XLA for costs. Here a CUDA device is asked for by name and a run that finds
none raises; on the CPU (`--device cpu`, the tests) the device figures are
None ("not measured"), never a CPU time under a device name.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
# where a tool's sidecar goes by default (listed in .gitignore)
OUT_DIR = REPO / "chiprun_out" / "bench"
PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
RANDOM_WEIGHTS_NOTE = "random weights: regression figures, not the north star's 30x"


def resolve_device(name: str) -> torch.device:
    """The device a tool runs on; "cuda" without a card raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device (pass --device cpu to run on the CPU)")
    return device


def card(device: torch.device) -> str:
    """`nvidia-smi`'s name and power limit of the card, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[device.index or 0]


def stamp(device: torch.device) -> dict:
    """What every result carries: the host's CPU count and the card."""
    return {"nproc": os.cpu_count(), "card": card(device), "device": str(device)}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def spread(times: list[float]) -> dict:
    """Best and median of repeated runs (seconds), and every run."""
    return {"best_s": min(times), "median_s": statistics.median(times), "runs_s": list(times)}


def profile(fn, device: torch.device, top: int = 8) -> dict:
    """Run fn once, to a synchronize, under torch.profiler with device
    activity only. Returns its host wall time (ms, profiler on), the
    device busy time (the kernels' and copies' own time summed, ms), the
    busy share of the wall, the kernel launches and the `top` largest
    kernels by device time as (name, ms, launches). The profiler's raw
    events are summed here: building its per-event tree (`key_averages`)
    takes minutes for the half a million launches of a window run. On the
    CPU fn just runs and the device figures are None."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    out = {"host_ms": None, "device_busy_ms": None, "busy_share": None, "launches": None,
           "top_kernels": []}
    sync(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        out["host_ms"] = 1e3 * (time.perf_counter() - t0)
        return out
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync(device)
        out["host_ms"] = 1e3 * (time.perf_counter() - t0)
    by_name: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            ms_n = by_name.setdefault(e.name(), [0.0, 0])
            ms_n[0] += e.duration_ns() / 1e6
            ms_n[1] += 1
    busy = sum(ms for ms, _ in by_name.values())
    if busy > 0:
        out.update(device_busy_ms=busy, busy_share=busy / out["host_ms"],
                   launches=sum(n for name, (_, n) in by_name.items()
                                if not name.startswith(("Memcpy", "Memset"))))
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
        out["top_kernels"] = [(name[:100], ms, n) for name, (ms, n) in ranked]
    return out


def fmt_ms(x: float | None) -> str:
    return "not measured" if x is None else f"{x:.3f} ms"


def emit(result: dict, short_keys: tuple, out: str | None, name: str) -> dict:
    """Write the whole result to its sidecar JSON (`out`, or OUT_DIR/<name>.json)
    and print one short JSON line: `short_keys` of the result and the
    sidecar's path. Returns the short line's object."""
    path = Path(out) if out else OUT_DIR / f"{name}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(result, indent=1, default=str))
    line = {k: result[k] for k in short_keys if k in result}
    line["sidecar"] = str(path)
    print(json.dumps(line, default=str), flush=True)
    return line
