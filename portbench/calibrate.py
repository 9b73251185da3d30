"""The readings that a cell's limits are set from, at the cell's own size.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--faults half_batch,altered] [--out file.jsonl]

For each seed of ``--seeds`` the cell's data are made and the program runs
one request on each dataset through the timed path (the cell's own
``Requests``), and the answers are judged as a run judges them: the lower
reading of each number is the largest over these seeds.  For each seed of
``--control-seeds`` the plain reference in TF32 answers in the program's
place (faults.control): the upper reading is the smallest over these.  Each
fault of ``--faults`` is planted in the program (faults.plant) and read on
the control seeds, each in a process of its own.  One JSON line per
reading goes to standard output and to ``--out``.  Runs on the card only.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.core import harness, manifest  # noqa: E402


def _emit(out, record: dict) -> None:
    line = json.dumps(record)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def readings(cell: harness.Cell, seeds, kind: str, out) -> None:
    import torch

    from portbench.core import port as portmod

    device = torch.device("cuda")
    port = portmod.load(device)
    for seed in seeds:
        t = time.perf_counter()
        datasets = cell.datasets(seed, device)
        requests = cell.entry.Requests(port, cell.cfg, cell.traffic, datasets)
        requests.warmup(cell.traffic)
        answers = [requests(i) for i in range(len(datasets))]
        torch.cuda.synchronize()
        del requests
        values, bad = cell.entry.judge(answers, cell.reference, cell.cfg, cell.traffic, datasets)
        record = {"workload": cell.name, "kind": kind, "seed": seed, "failed": bad,
                  "seconds": time.perf_counter() - t, **values}
        if hasattr(answers[0], "trace"):
            record["trace"] = answers[0].trace + [answers[0].final]
            record["params"] = answers[0].params.tolist()
            record["grad"] = answers[0].grad.tolist()
        _emit(out, record)
        del answers, datasets
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--fault", default="")  # this process plants one fault
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    harness.cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    from portbench import faults

    cell = harness.Cell(manifest.manifest(), args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control_seeds = [int(s) for s in args.control_seeds.split(",") if s]
    if args.fault:
        faults.plant(args.fault)
        readings(cell, control_seeds, f"fault:{args.fault}", args.out)
        return 0
    readings(cell, seeds, "program", args.out)
    for fault in [f for f in args.faults.split(",") if f]:
        # a fault patches the port for good: each runs in a process of its own
        rc = subprocess.run([sys.executable, __file__, "--workload", args.workload,
                             "--control-seeds", args.control_seeds, "--fault", fault,
                             "--out", args.out]).returncode
        if rc:
            return rc
    faults.control(cell)
    readings(cell, control_seeds, "control", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
