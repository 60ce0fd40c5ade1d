"""One run of one cell of the benchmark of `speaksense_tpu_torch`.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

(`python3 -m benchmark.run ...` from the checkout's root is the same.) It
draws the weights and the traffic from the seed, serves the traffic
through the program on one card, measures for `--seconds` after set-up,
checks a sample of what was served against the plain reference, and prints
one JSON object as the last line of its standard output: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer ones), `device`, with `--trace 1` `breakdown`,
and last `checks`, each compared number with its limit (also the last
lines of standard error).

Without a CUDA card, or with fewer cards than the cell asks for, it exits
with code 2 and prints no result. Build and kernel caches live in
`.bench_cache/` and `speaksense_tpu_torch/ops/_build/` inside the checkout.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__" and sys.path and Path(sys.path[0]).resolve() == ROOT / "benchmark":
    sys.path[0] = str(ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "speaksense_tpu")
CACHE = ROOT / ".bench_cache"
CACHE_ENV = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
             "CUDA_CACHE_PATH": "cuda", "TORCHINDUCTOR_CACHE_DIR": "inductor",
             "PYTORCH_KERNEL_CACHE_PATH": "kernels"}


def set_environment() -> None:
    """Every build and kernel cache at a fixed path inside the checkout;
    no library loads JAX on its own; the profiler keeps CUPTI attached
    between its sessions (`TEARDOWN_CUPTI=0`): attaching it again while
    the batcher's thread launches lost that thread's kernels from some
    traces on the H100."""
    for var, sub in CACHE_ENV.items():
        (CACHE / sub).mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["TEARDOWN_CUPTI"] = "0"


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _finite(x: float) -> float:
    return x if math.isfinite(x) else 1e30


def judge(readings: dict, limits: dict, failed: int) -> tuple[bool, dict]:
    """`correct` and the checks: every comparison of the cell's limits file
    (`limits/<cell>.json`, {name: {"reading": key of the generator's
    readings, "limit": ...}}), its reading beside its limit, and `failed`
    beside 0. A reading the run does not give is null and fails; a limits
    file that compares nothing fails too."""
    checks = {}
    for name, entry in limits.items():
        value = readings.get(entry["reading"])
        checks[name] = {"value": None if value is None else _finite(value),
                        "limit": entry["limit"]}
    compared = bool(checks)
    checks["failed"] = {"value": failed, "limit": 0}
    correct = (compared and readings.get("windows", 0) > 0
               and all(c["value"] is not None and c["value"] <= c["limit"]
                       for c in checks.values()))
    return bool(correct), checks


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t0: float | None = None, overrides: dict | None = None,
             controls: tuple = (), judged: str = "program") -> dict:
    """Set up, serve, measure and check one run. Returns the result line's
    keys (without the device stamp) and the check's readings: the
    program's, and those of each control named in `controls` (the
    generator's `CONTROLS`). `judged` names the readings that decide
    `correct`: "control" puts the control in the program's place, so the
    control comes out as the harness judges a run."""
    import torch

    from benchmark import devtrace, flops, program, spec
    from benchmark.reference.whisper import Shape
    from benchmark.weights import draw

    t0 = time.perf_counter() if t0 is None else t0
    dev = torch.device(device)
    s = Shape.from_config(cell.config)
    gen = spec.generator(cell.traffic["generator"])
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    weights = draw(s, seed, dev)
    engine = program.build_engine(cell.config, s, weights, dev, seed, **(overrides or {}))
    del weights
    tracer = devtrace.DeviceTrace() if trace else None
    if tracer is not None and dev.type == "cuda":
        tracer.prepare(dev)
    served = gen.serve(engine, cell.traffic, seed, seconds, tracer)
    setup_s = served.t_open - t0
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del engine
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    summary = tracer.summary() if served.trace_batches is not None else None
    if tracer is not None:
        print(f"trace: {served.trace_tries}, kept {served.trace_batches}, {tracer.info}",
              file=sys.stderr)
    print(f"window: {served.timeline()}", file=sys.stderr)

    # the check, on weights drawn again from the seed, after the program is gone
    t_check = time.perf_counter()
    prev_tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        controls = tuple(dict.fromkeys(controls + (() if judged == "program" else (judged,))))
        readings = gen.check(served, cell.config, cell.traffic, seed, dev, draw(s, seed, dev),
                             controls=controls)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev_tf32
    gc.collect()
    print(f"setup {setup_s:.3f} s, window {served.seconds:.3f} s, "
          f"check {readings['program']['windows']} "
          f"windows in {time.perf_counter() - t_check:.3f} s", file=sys.stderr)

    ctx = SimpleNamespace(cell=cell.name, config=cell.config, shape=s, traffic=cell.traffic,
                          generator=cell.traffic["generator"], served=served, setup_s=setup_s,
                          trace=summary, flops=flops,
                          peaks=flops.peaks(torch.cuda.get_device_name(dev))
                          if dev.type == "cuda" else None)
    metrics = spec.read_all(cell.per_layer if trace else cell.end_to_end, ctx)
    correct, checks = judge(readings[judged], cell.limits, served.failed)
    out = {"correct": correct, "attempted": served.attempted, "failed": served.failed,
           "metrics": metrics, "memory_peak_bytes": memory_peak, "readings": readings,
           "checks": checks, "trace": summary}
    return out


def result_line(out: dict, chips: int, device_name: str) -> dict:
    line = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
            "metrics": out["metrics"],
            "device": {"platform": "gpu", "kind": device_name, "count": chips,
                       "memory_peak_bytes": out["memory_peak_bytes"]}}
    summary = out["trace"]
    if summary is not None:
        line["device"].update(busy_s=summary.busy_s, window_s=summary.window_s)
        line["breakdown"] = {"device_ops": summary.device_ops(10),
                             "idle_gaps": summary.idle_gaps[:10]}
    line["checks"] = out["checks"]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    set_environment()
    from benchmark import spec

    bench = spec.load_json(ROOT / "BENCHMARK.json")
    cell = spec.cell(bench, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this machine has {have}",
              file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    bad = forbidden_modules()
    if bad:
        print(f"loaded modules that must not be: {', '.join(bad)}", file=sys.stderr)
        return 4
    line = result_line(out, cell.chips, torch.cuda.get_device_name(0))
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
