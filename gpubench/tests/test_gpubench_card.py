"""On the card only: one short run of each cell, correct, with every
metric its manifest entry names."""

import subprocess
import sys

import gpubench_small  # noqa: F401
import pytest
import torch

from gpubench import manifest

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  manifest.load()["workloads"]])
def test_a_short_run_on_the_card(card, cell):
    import json
    proc = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", cell, "--seed",
         "2147483999", "--seconds", "2", "--trace", "0"],
        cwd=manifest.ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {
        m["name"] for m in manifest.metrics_of(manifest.load(), cell, False)}
