"""On the card: one short run of the cheapest cell through `run.py`, as
the benchmark's runs make it. Skips without a CUDA card.

    python -m pytest --noconftest -p no:cacheprovider benchmark/tests/test_bench_card.py
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark import spec


@pytest.mark.cuda
def test_turbo_cell_runs_and_is_correct():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    got = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "large-v3-turbo.batch64", "--seed", "2400000001", "--seconds", "8",
                          "--trace", "0"], capture_output=True, text=True, cwd=spec.ROOT,
                         timeout=600)
    assert got.returncode == 0, got.stderr[-3000:]
    line = json.loads(got.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["metrics"]["batch_rtf"]["value"] > 0
    assert list(line)[-1] == "checks"
