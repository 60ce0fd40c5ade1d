"""The readings that a cell's limits on its check are set from, on the card.

    python3 benchmark/control.py --workload <name> --seconds <s> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--int8-weights-seeds 1,2,3] [--fault-seeds 1,2,3]

For every seed in --seeds it makes one run of the cell in this process, as
`run.py` does (set-up, the served window, the check), and reads the check's
numbers (`window_backlog.summarize`): the program's sound runs, the lower
reading. Two controls give the upper reading:

- the program's own lower precision, its int8 decoder weights switched on
  (`weights_int8`), on every seed in --int8-weights-seeds;
- the plain reference one precision step down put in the program's place
  (float8 operands in every product, keys and values at 4 bits), read at
  the same prompts and tokens in the runs of --control-seeds, and beside it
  the reference with its encoder alone lowered.

--fault-seeds runs each fault of `faults.py` planted in the program. Every
run is judged by the harness's own comparison with the cell's limits. One
JSON line per run and path, then the largest and smallest of each reading
by path. --seconds must let one batch complete after the warm-up.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__" and Path(sys.path[0]).resolve() == ROOT / "benchmark":
    sys.path[0] = str(ROOT)


def _seeds(text: str) -> list[int]:
    return [int(x) for x in text.split(",") if x.strip()]


READINGS = ("gap", "mean_gap", "no_speech_diff")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--int8-weights-seeds", default="")
    ap.add_argument("--fault-seeds", default="",
                    help="each planted fault of faults.py on each of these seeds")
    args = ap.parse_args(argv)

    from benchmark.run import forbidden_modules, judge, run_cell, set_environment

    set_environment()
    from benchmark import faults, spec
    from benchmark.generators.window_backlog import CONTROLS

    cell = spec.cell(spec.load_json(ROOT / "BENCHMARK.json"), args.workload)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    control = set(_seeds(args.control_seeds))
    plain = _seeds(args.seeds)
    runs = [(seed, "program", None) for seed in plain + sorted(control - set(plain))]
    runs += [(seed, "program int8 weights", {"weights_int8": True})
             for seed in _seeds(args.int8_weights_seeds)]
    runs += [(seed, f"fault: {f}", None) for f in faults.FAULTS
             for seed in _seeds(args.fault_seeds)]
    table: dict = {}
    for seed, path, overrides in runs:
        t0 = time.perf_counter()
        fault = path[len("fault: "):] if path.startswith("fault: ") else None
        controls = CONTROLS if path == "program" and seed in control else ()
        with faults.planted(fault) if fault else contextlib.nullcontext():
            out = run_cell(cell, seed, args.seconds, False, "cuda", overrides=overrides,
                           controls=controls)
        seconds = time.perf_counter() - t0
        for name, r in out["readings"].items():
            label = path if name == "program" else name
            correct, _ = judge(r, cell.limits, out["failed"])
            row = {"workload": args.workload, "seed": seed, "path": label, "correct": correct,
                   "failed": out["failed"], "seconds": seconds, **r}
            print(json.dumps(row), flush=True)
            for key in READINGS:
                table.setdefault(label, {}).setdefault(key, []).append(r[key])
    summary = {path: {k: {"n": len(v), "max": max(v), "min": min(v)} for k, v in by.items()}
               for path, by in table.items()}
    print(json.dumps({"workload": args.workload, "summary": summary,
                      "forbidden_modules": forbidden_modules()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
