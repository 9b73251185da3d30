"""A copy of the benchmark with tiny cells, run on the CPU.

``make_tree(dest)`` copies ``BENCHMARK.json`` and ``portbench/`` to
``dest`` and adds two configurations at tiny sizes (``tiny``: the bench
recipe at n=256, d=8, q=2; ``tinybreath``: the breathing recipe at n=300),
their cells and their limits, files beside the others as a later change
would add them.  ``run_cell`` runs one cell of such a tree in a fresh
process on the CPU (the harness's look for a card skipped), optionally
with a fault planted in the program or with the reference put in its
place, and returns the result line.

The faults are portbench/faults.py's, planted before the run.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY = {"name": "tiny", "source": "test", "kernel": {"form": "gaussian", "class": "Gaussian",
        "params": [3.0, 1.0]}, "sigma": 0.1, "n": 256, "d": 8, "q": 2, "dtype": "float32",
        "data": {"recipe": "gaussian_iid"}, "reference": "exact_gp", "reduced": [], "assumed": []}
TINYBREATH = {"name": "tinybreath", "source": "test", "kernel": {"form": "gaussian", "class": "Gaussian",
              "params": [2.0, 1.0]}, "sigma": 0.1, "n": 300, "d": 5, "q": 3, "dtype": "float32",
              "data": {"recipe": "breathing_trace", "period": 60, "period_jitter": 0.2,
                       "amplitude_jitter": 0.15, "shape": 2, "drift": 0.2, "noise": 0.02},
              "reference": "exact_gp", "reduced": [], "assumed": []}
# limits of the tiny cells, between the CPU readings of the sound program
# (largest over seeds 7, 8, 2**33 + 5: alpha 1.76e-4, logdet 2.2e-7; loss
# 1.5e-5, param 2.3e-6, grad 2.8e-5; breathing loss 1.7e-4, param 1.9e-5,
# grad 4.7e-4) and of the control (alpha 1.4e-2, logdet 8.8e-4; loss
# 4.0e-3, param 3.8e-4, grad 3.5e-3; breathing loss 5.7e-2, param 7.2e-3,
# grad 5.0e-2)
TINY_LIMITS = {
    "tiny.fit": {"alpha_gap": {"limit": 1.5e-3}, "logdet_gap": {"limit": 2e-5}},
    "tiny.train": {"loss_gap": {"limit": 3e-4}, "param_gap": {"limit": 3e-5}, "grad_gap": {"limit": 5e-4}},
    "tinybreath.train": {"loss_gap": {"limit": 5e-3}, "param_gap": {"limit": 2e-3}, "grad_gap": {"limit": 5e-3}},
}
CELLS = {"tiny.fit": ("tiny", "fit"), "tiny.train": ("tiny", "train"),
         "tinybreath.train": ("tinybreath", "train")}
# the cell of BENCHMARK.json whose metrics each tiny cell reports
LIKE = {"tiny.fit": "bench16k.fit", "tiny.train": "bench16k.train",
        "tinybreath.train": "breathing3773.train"}


def make_tree(dest: Path) -> Path:
    dest = Path(dest)
    shutil.copytree(REPO / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    man = json.loads((REPO / "BENCHMARK.json").read_text())
    for cfg in (TINY, TINYBREATH):
        (dest / "portbench" / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
        man["configs"].append({"name": cfg["name"], "source": "test",
                               "file": f"portbench/configs/{cfg['name']}.json", "reduced": [],
                               "why": "a tiny size for the CPU"})
    for cell, (config, traffic) in CELLS.items():
        man["workloads"].append({"name": cell, "config": config, "traffic": traffic, "chips": 1,
                                 "why": "a tiny size for the CPU"})
        (dest / "portbench" / "limits" / f"{cell}.json").write_text(json.dumps(TINY_LIMITS[cell]))
        for m in man["end_to_end"] + man["per_layer"]:
            if LIKE[cell] in m.get("workloads", []):
                m["workloads"].append(cell)
    (dest / "BENCHMARK.json").write_text(json.dumps(man, indent=1))
    return dest


_DRIVER = r"""
import sys, time
t0 = time.perf_counter()
tree, repo, fault, argv = sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4:]
sys.path[:0] = [tree, repo]
import torch
torch.set_num_threads(1)
from portbench import faults
from portbench.core import harness, manifest
if fault == "control":
    faults.control(harness.Cell(manifest.manifest(), argv[argv.index("--workload") + 1]))
elif fault != "none":
    faults.plant(fault)
sys.exit(harness.run(argv, t0, device_name="cpu", check_device=False))
"""


def run_cell(tree: Path, cell: str, seed: int, seconds: float = 0.3, trace: int = 0,
             fault: str = "none", timeout: float = 300) -> dict:
    argv = ["--workload", cell, "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)]
    proc = subprocess.run([sys.executable, "-c", _DRIVER, str(tree), str(REPO), fault, *argv],
                          capture_output=True, text=True, timeout=timeout, cwd=tree)
    if proc.returncode != 0:
        raise RuntimeError(f"run failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])
