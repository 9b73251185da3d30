"""Run one cell several times, one process after another, and report each
metric's median and spread: the distance between the first and third
quartiles (``statistics.quantiles(values, n=4)``) as a share of the median.
Used to set a bound (about five times the wider spread of two sets of runs
on the same seeds) and to check that every run is correct.

    python3 portbench/series.py --workload <cell> --seeds 1,2,3 --seconds 20 \
        [--trace 0] [--label set1] [--out results.jsonl]

Each run's result line, its wall time and the numbers it compared go to
``--out`` as one JSON line; the summary goes to standard output.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

RUN = Path(__file__).resolve().parent / "run.py"


def spread(values) -> float:
    if len(values) < 2:
        return 0.0
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", default="20")
    p.add_argument("--trace", default="0")
    p.add_argument("--label", default="")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    rows = []
    for seed in args.seeds.split(","):
        t = time.perf_counter()
        proc = subprocess.run([sys.executable, str(RUN), "--workload", args.workload, "--seed", seed,
                               "--seconds", args.seconds, "--trace", args.trace],
                              capture_output=True, text=True, timeout=900)
        wall = time.perf_counter() - t
        lines = proc.stdout.strip().splitlines()
        result = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
        row = {"workload": args.workload, "label": args.label, "seed": int(seed), "trace": int(args.trace),
               "rc": proc.returncode, "wall_s": wall, "result": result,
               "stderr_tail": proc.stderr[-1500:] if result is None or not result["correct"] else
               "\n".join(line for line in proc.stderr.splitlines() if line.startswith("portbench: set-up"))}
        rows.append(row)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
        status = "no result" if result is None else f"correct={result['correct']}"
        print(f"{args.workload} seed {seed}: rc {proc.returncode}, {status}, wall {wall:.1f} s", flush=True)
    good = [r["result"] for r in rows if r["result"] is not None]
    for name in (good[0]["metrics"] if good else {}):
        values = [g["metrics"][name]["value"] for g in good if name in g["metrics"]]
        print(f"  {name}: median {statistics.median(values)!r} spread {spread(values)!r} "
              f"values {values}", flush=True)
    return 0 if len(good) == len(rows) and all(g["correct"] for g in good) else 1


if __name__ == "__main__":
    sys.exit(main())
