"""What `BENCHMARK.json` names, found by name under `benchmark/`.

- a configuration: `configs[].file` (its sizes, the engine's settings and
  the decoding rules) and its plain reference, `reference/<reference>.py`;
- a traffic mix: `traffic/<traffic>.json`, whose `generator` names the
  general generator in `generators/<generator>.py` that reads it;
- a cell's limits on what its check compares: `limits/<workload>.json`;
- a metric, end-to-end or per-layer: its reader `metrics/<name>.py`, a
  function `read(ctx)` that returns a number, or None where the run gives
  it nothing to read.

Adding a cell, a mix or a metric is adding files and entries; no file here
changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


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
    files relative to `root`, the rest under `here`."""
    by_name = {w["name"]: w for w in bench["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(known: {', '.join(sorted(by_name))})")
    w = by_name[workload]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = load_json(root / conf["file"])
    config.setdefault("name", conf["name"])
    traffic = load_json(here / "traffic" / f"{w['traffic']}.json")
    limits = load_json(here / "limits" / f"{workload}.json")
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload, None)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, workload, names)]
    return Cell(name=workload, chips=w["chips"], config=config, traffic=traffic,
                limits=limits, end_to_end=e2e, per_layer=per_layer)


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
    return importlib.import_module(f"benchmark.generators.{name}")


def read_all(metrics: list, ctx, here: Path = HERE) -> dict:
    """{name: {"value", "unit"}} of every metric whose reader found
    something to read."""
    out = {}
    for m in metrics:
        value = reader(m["name"], here)(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
