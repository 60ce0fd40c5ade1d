"""What `BENCHMARK.json` names, found by name under `benchmark/`.

- a configuration: `configs[].file` (its sizes, the engine's settings and
  the decoding rules) and its plain reference, `reference/<reference>.py`;
- a traffic mix: `traffic/<traffic>.json`, whose `generator` names the
  general generator in `generators/<generator>.py` that reads it;
- a cell's limits on what its check compares: `limits/<workload>.json`,
  each entry naming the reading of the generator's check it holds;
- a metric, end-to-end or per-layer: its reader `metrics/<name>.py`, a
  function `read(ctx)` that returns a number, or None where the run gives
  it nothing to read.

Adding a cell, a mix, a generator or a metric is adding files and
entries; no file here changes. `pairing` builds a configuration file and
a mix that no cell names yet, so that their limits can be read on the
card before the cell exists.

A generator, `generators/<name>.py`, provides (`generator` refuses one
that lacks a name of `GENERATOR`):

- `serve(engine, traffic, seed, seconds, tracer)`: drives the program
  and returns its record, with `t_open` (the host time the measured
  window opened; set-up ends there), `seconds` (the window's length),
  `attempted` and `failed` (requests in the window), `audio_s` (audio
  seconds answered in the window, which `batch_rtf` reads; None where it
  serves no audio), `trace_batches` (None where it kept no trace),
  `trace_tries` and `timeline()` (for the log);
- `check(served, cfg, traffic, seed, device, weights, controls)`: the
  plain reference over a sample of what was served, {"program":
  readings, <control>: readings}, each readings a dict holding every
  name of `READINGS`;
- `READINGS`: the names its check reads, among them `windows`, the number
  of answers checked (a run that checked none is not correct); a cell's
  limits name these;
- `CONTROLS`: the controls its check can read beside the program, each
  the plain reference one precision step down in the program's place;
- `FAULTS` and `planted(name)`: the faults of the path it drives, each
  planted in the program under a whole run; each must turn `correct`
  false (`control.py --fault-seeds`, the tests).
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
GENERATOR = ("serve", "check", "READINGS", "CONTROLS", "FAULTS", "planted")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list       # the BENCHMARK.json entries this cell reports
    per_layer: list


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str, e2e_names: set | None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def cell(bench: dict, workload: str, root: Path = ROOT, here: Path = HERE) -> Cell:
    """The cell named `workload`, with everything it reads: configuration
    files relative to `root`, the rest under `here`. Its limits file must
    exist."""
    by_name = {w["name"]: w for w in bench["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(known: {', '.join(sorted(by_name))})")
    w = by_name[workload]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    c = pairing(conf["file"], w["traffic"], root, here, name=workload)
    if not (here / "limits" / f"{workload}.json").exists():
        raise FileNotFoundError(here / "limits" / f"{workload}.json")
    c.config.setdefault("name", conf["name"])
    c.chips = w["chips"]
    c.end_to_end = [m for m in bench["end_to_end"] if _applies(m, workload, None)]
    names = {m["name"] for m in c.end_to_end}
    c.per_layer = [m for m in bench["per_layer"] if _applies(m, workload, names)]
    return c


def pairing(config_file: str, traffic: str, root: Path = ROOT, here: Path = HERE,
            name: str | None = None) -> Cell:
    """A configuration file (relative to `root`) under the mix `traffic`,
    whether or not a cell names them: the cell `name` (by default `<config
    name>.<traffic>`) on one chip with no metrics, and the limits of
    `limits/<that name>.json` where the file exists, none (nothing to
    judge) where it does not."""
    config = load_json(root / config_file)
    name = name or f"{config['name']}.{traffic}"
    limits_file = here / "limits" / f"{name}.json"
    return Cell(name=name, chips=1, config=config,
                traffic=load_json(here / "traffic" / f"{traffic}.json"),
                limits=load_json(limits_file) if limits_file.exists() else {},
                end_to_end=[], per_layer=[])


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, here: Path = HERE):
    """The `read(ctx)` of metric `metric`."""
    return _module(here / "metrics" / f"{metric}.py", f"benchmark_metric_{metric}").read


def generator(name: str):
    """The generator `generators/<name>.py`, which provides every name of
    `GENERATOR`."""
    mod = importlib.import_module(f"benchmark.generators.{name}")
    missing = [a for a in GENERATOR if not hasattr(mod, a)]
    if missing:
        raise AttributeError(f"generator {name!r} lacks {', '.join(missing)}")
    return mod


def read_all(metrics: list, ctx, here: Path = HERE) -> dict:
    """{name: {"value", "unit"}} of every metric whose reader found
    something to read."""
    out = {}
    for m in metrics:
        value = reader(m["name"], here)(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
