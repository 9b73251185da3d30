"""On the card: each cell of BENCHMARK.json runs a short window, untraced and
traced, and is correct.  Skips where there is no CUDA device.

    python -m pytest -m cuda portbench/tests/test_portbench_card.py
"""

import json
import subprocess
import sys

import pytest

from portbench_tiny import REPO

CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_card(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run the port's CUDA kernels")
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed", "2147483659",
                           "--seconds", "3", "--trace", str(trace)], cwd=REPO, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    if trace:
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
        assert r["breakdown"]["device_ops"]
        for m in r["metrics"].values():
            if m["unit"] == "%":
                assert 0 <= m["value"] <= 100
