"""The readings that a cell's limits on its check are set from, on the card.

    python3 benchmark/control.py --workload <name> --seconds <s> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--int8-weights-seeds 1,2,3] [--fault-seeds 1,2,3]
    python3 benchmark/control.py --config benchmark/configs/<file>.json \
        --traffic <mix> --seconds <s> --seeds 1,2,3 [...]

The first form runs a cell of `BENCHMARK.json`; the second a configuration
file under a traffic mix that no cell names yet (`spec.pairing`), so that a
new configuration's readings are known before the PR that adds its cell.
For every seed in --seeds it makes one run in this process, as `run.py`
does (set-up, the served window, the check), and reads the check's numbers
(the traffic's generator's `READINGS`): the program's sound runs, the
lower reading. Two controls give the upper reading:

- the program's own lower precision, its int8 decoder weights switched on
  (`weights_int8`), on every seed in --int8-weights-seeds;
- the generator's `CONTROLS`, read in the runs of --control-seeds: for the
  window backlog the plain reference one precision step down put in the
  program's place (float8 operands in every product, keys and values at 4
  bits), read at the same prompts and tokens, and beside it the reference
  with its encoder alone lowered.

--fault-seeds runs each of the generator's `FAULTS` planted in the
program (its `planted`). Every run is judged by the harness's own
comparison with the limits, where there are limits (`correct` is null
where there are none). One JSON line per run and path, then the largest
and smallest of each reading by path. --seconds must let one batch
complete after the warm-up.
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


def parse(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    which = ap.add_mutually_exclusive_group(required=True)
    which.add_argument("--workload", help="a cell of BENCHMARK.json")
    which.add_argument("--config", help="a configuration file, with --traffic")
    ap.add_argument("--traffic", help="a traffic mix under benchmark/traffic/")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--int8-weights-seeds", default="")
    ap.add_argument("--fault-seeds", default="",
                    help="each of the generator's planted faults on each of these seeds")
    args = ap.parse_args(argv)
    if (args.config is None) != (args.traffic is None):
        ap.error("--config and --traffic go together")
    return args


def cell_of(args):
    """The cell that `args` names, or the pairing of its configuration file
    and mix."""
    from benchmark import spec

    if args.workload is not None:
        return spec.cell(spec.load_json(ROOT / "BENCHMARK.json"), args.workload)
    return spec.pairing(args.config, args.traffic)


def main(argv=None) -> int:
    args = parse(argv)

    from benchmark.run import forbidden_modules, judge, run_cell, set_environment

    set_environment()
    from benchmark import spec

    cell = cell_of(args)
    gen = spec.generator(cell.traffic["generator"])
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    control = set(_seeds(args.control_seeds))
    plain = _seeds(args.seeds)
    runs = [(seed, "program", None) for seed in plain + sorted(control - set(plain))]
    runs += [(seed, "program int8 weights", {"weights_int8": True})
             for seed in _seeds(args.int8_weights_seeds)]
    runs += [(seed, f"fault: {f}", None) for f in gen.FAULTS
             for seed in _seeds(args.fault_seeds)]
    table: dict = {}
    for seed, path, overrides in runs:
        t0 = time.perf_counter()
        fault = path[len("fault: "):] if path.startswith("fault: ") else None
        controls = tuple(gen.CONTROLS) if path == "program" and seed in control else ()
        with gen.planted(fault) if fault else contextlib.nullcontext():
            out = run_cell(cell, seed, args.seconds, False, "cuda", overrides=overrides,
                           controls=controls)
        seconds = time.perf_counter() - t0
        for name, r in out["readings"].items():
            label = path if name == "program" else name
            correct = judge(r, cell.limits, out["failed"])[0] if cell.limits else None
            row = {"workload": cell.name, "seed": seed, "path": label, "correct": correct,
                   "failed": out["failed"], "seconds": seconds, **r}
            print(json.dumps(row), flush=True)
            for key in gen.READINGS:
                if key in r:
                    table.setdefault(label, {}).setdefault(key, []).append(r[key])
    summary = {path: {k: {"n": len(v), "max": max(v), "min": min(v)} for k, v in by.items()}
               for path, by in table.items()}
    print(json.dumps({"workload": cell.name, "summary": summary,
                      "forbidden_modules": forbidden_modules()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
