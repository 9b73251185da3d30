"""One run of one cell: set-up, the measured window, the judgement, one line.

  python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up builds or loads the port's kernels, makes the cell's data on the
device from the seed and warms up the cell's own shapes.  ``setup_s`` runs
from the start of the process to the first timed request.  With
``--trace 0`` the window gives the cell's end-to-end metrics.  With
``--trace 1`` the same window runs, untraced, and then the same loop again
under ``torch.profiler`` for at most the traffic's ``trace_seconds``; the
per-layer metrics read either (a metric on the host clock reads the
untraced window, which the profiler's cost does not stretch; one from the
device trace reads the traced one).  Once the windows have closed and the
device's peak memory has been read, every answer of the windows is judged against the plain reference (``entries/<entry>.py``
``judge``, ``reference/<reference>.py``), each number beside its limit
(``limits/<cell>.json``).  The last line of standard output is the result.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

from . import manifest


def _args(argv):
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _err(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def cache_dirs() -> None:
    """Keep every compiler cache a library might use inside the checkout, at
    fixed paths (the port's own kernels build into gpr_tpu_torch/_build/).
    Python's bytecode goes there too, written even where the environment
    says not to write it (PYTHONDONTWRITEBYTECODE, as on the card's
    machine, whose installed packages carry none): else every process
    compiles the sources of torch and of what the first training step
    imports (torch._dynamo, sympy) again, 5-10 s of each run's set-up."""
    base = manifest.ROOT / ".portbench_cache"
    sys.pycache_prefix = str(base / "pycache")
    sys.dont_write_bytecode = False
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(base / "nv_compute")
    os.environ.setdefault("USE_FLAX", "0")


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi not read: {exc}"


class Cell:
    """A cell's pieces, found by name, and its run on ``device``."""

    def __init__(self, man: dict, name: str):
        self.cell = manifest.cell(man, name)
        self.name = name
        self.cfg = manifest.config(self.cell["config"])
        self.traffic = manifest.traffic(self.cell["traffic"])
        self.entry = manifest.load_module("entries", self.traffic["entry"])
        self.reference = manifest.load_module("reference", self.cfg["reference"])
        self.recipe = manifest.load_module("data", self.cfg["data"]["recipe"])
        self.loop = manifest.load_module("loops", self.traffic["loop"])
        self.e2e, self.layer = manifest.cell_metrics(man, name)

    def datasets(self, seed: int, device):
        return self.recipe.make(self.cfg, seed, int(self.traffic.get("datasets", 1)), device)

    def window(self, requests, sync, seconds: float, first: int, span=None):
        return self.loop.run(requests, sync, seconds, self.entry.steps(self.traffic), first=first, span=span)


def traced_window(cell: Cell, requests, sync, seconds: float, first: int):
    """The window under ``torch.profiler``, one request before it so that the
    profiler's own start-up lies outside; returns (window, summary)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from .trace import KernelMap, summarize

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        requests(first)
        sync()
        with record_function("portbench.window"):
            win = cell.window(requests, sync, seconds, first + 1, span=record_function)
        sync()
    return win, summarize(prof.profiler.kineto_results.events(), KernelMap(manifest.kernel_maps()))


def run(argv, t_start: float, device_name: str = "cuda", check_device: bool = True) -> int:
    args = _args(argv)
    cache_dirs()
    stages = [("start", time.perf_counter())]
    import torch

    stages.append(("torch", time.perf_counter()))
    torch.set_num_threads(1)  # one process with few threads: steadier host times
    man = manifest.manifest()
    cell = Cell(man, args.workload)

    chips = int(cell.cell["chips"])
    if check_device and (not torch.cuda.is_available() or torch.cuda.device_count() < chips):
        _err(f"portbench: the cell needs {chips} CUDA device(s); this machine has "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}. No result.")
        return 3
    device = torch.device(device_name)
    on_card = device.type == "cuda"
    from . import port as portmod

    sync = torch.cuda.synchronize if on_card else (lambda: None)
    if on_card:
        torch.cuda.init()
    stages.append(("cuda", time.perf_counter()))
    port = portmod.load(device)
    stages.append(("kernels", time.perf_counter()))
    datasets = cell.datasets(args.seed, device)
    sync()
    stages.append(("data", time.perf_counter()))
    requests = cell.entry.Requests(port, cell.cfg, cell.traffic, datasets)
    requests.warmup(cell.traffic)
    sync()
    stages.append(("warm-up", time.perf_counter()))
    setup_s = stages[-1][1] - t_start
    _err("portbench: set-up " + ", ".join(
        f"{name} {t - (stages[i - 1][1] if i else t_start):.3f} s" for i, (name, t) in enumerate(stages))
        + f"; process CPU {time.process_time():.3f} s")
    first = int(cell.traffic.get("warmup_requests", 1))

    metrics, device_info = {}, {}
    win = cell.window(requests, sync, args.seconds, first)
    answers = list(win.answers)
    if args.trace:
        seconds = min(args.seconds, float(cell.traffic.get("trace_seconds", args.seconds)))
        traced, summary = traced_window(cell, requests, sync, seconds, first + win.requests)
        answers += traced.answers
        ctx = {"cfg": cell.cfg, "traffic": cell.traffic, "window": win, "traced": traced,
               "trace": summary}
        for m in cell.layer:
            if not on_card and m["source"] == "device_trace":
                continue  # a CPU run gives no device number
            value = manifest.load_module("metrics", m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info = {"busy_s": summary.busy_ns * 1e-9, "window_s": summary.window_ns * 1e-9}
    else:
        for m in cell.e2e:
            value = setup_s if m["name"] == "setup_s" else \
                manifest.load_module("e2e", m["name"]).read(win, cell.traffic)
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    # the window has closed: free the program's state, then judge its answers
    del requests, port
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    # failed: requests that raised, and answers that are not finite
    readings, failed = cell.entry.judge(answers, cell.reference, cell.cfg, cell.traffic, datasets)
    limits = manifest.limits(cell.name)
    checks = {k: {"value": v, "limit": limits[k]["limit"]} for k, v in readings.items()}
    correct = failed == 0 and all(c["value"] is not None and c["value"] <= c["limit"]
                                  for c in checks.values())

    if on_card:  # read after the window, so that set-up does not wait for it
        _err(f"portbench: card {card_line()}")
    routes = sorted({a.route for a in answers if hasattr(a, "route")})
    _err(f"portbench: route {', '.join(routes)}; the configuration names "
         f"{cell.cfg.get('routes', {}).get(cell.traffic['entry'])}")
    found = portmod.forbidden_modules()
    if found:
        _err(f"portbench: forbidden modules loaded in this process: {', '.join(found)}. No result.")
        return 4

    if on_card:
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
               "memory_peak_bytes": int(peak)}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    dev.update(device_info)
    result = {"correct": bool(correct), "attempted": len(answers), "failed": int(failed),
              "metrics": metrics, "device": dev}
    if args.trace:
        result["breakdown"] = summary.breakdown()
    result["checks"] = checks
    _err(f"portbench: {args.workload} seed {args.seed}: {win.requests} requests, {win.steps} steps "
         f"in {win.seconds:.6f} s, setup {setup_s:.6f} s")
    for k, c in checks.items():
        _err(f"check {k} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0

