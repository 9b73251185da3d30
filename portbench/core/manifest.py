"""Find a cell's pieces by name.

``BENCHMARK.json`` at the root of the checkout names every configuration,
cell and metric.  Each piece lives in a file of its own under
``portbench/``, found by that name, so that a new configuration, traffic
mix, request kind or metric is a new file and no existing file changes:

  configs/<config>.json        sizes, data recipe, reference, kernel
  traffic/<traffic>.json       the loop, the entry it drives, its request
  loops/<loop>.py              how the requests are sent in the window
  entries/<entry>.py           how one request of that kind runs and is judged
  data/<recipe>.py             how a configuration's inputs are made
  reference/<reference>.py     the plain float64 reference
  e2e/<metric>.py              an end-to-end metric, from the host clock
  metrics/<metric>.py          a per-layer metric, from the traced run
  kernels/<module>.json        kernel names of one module of the port
  limits/<cell>.json           the limit of each number compared
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def load_module(kind: str, name: str):
    """The Python file ``portbench/<kind>/<name>.py`` as a module; a name
    may hold dots, so the file is loaded by its path."""
    key = f"portbench.{kind}.{name.replace('.', '_')}"
    if key in sys.modules:
        return sys.modules[key]
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    spec.loader.exec_module(module)
    return module


def config(name: str) -> dict:
    return load_json(BENCH / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return load_json(BENCH / "traffic" / f"{name}.json")


def limits(cell: str) -> dict:
    return load_json(BENCH / "limits" / f"{cell}.json")


def kernel_maps() -> dict:
    """{kernel name: port module} from every ``kernels/<module>.json``."""
    out = {}
    for path in sorted((BENCH / "kernels").glob("*.json")):
        for kernel in load_json(path)["kernels"]:
            out[kernel] = path.stem
    return out


def cell(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _reports(metric: dict, cell_name: str, e2e_names: set) -> bool:
    """A metric that lists its cells is reported in those; a per-layer one
    that lists none, in every cell that reports the metric it moves; an
    end-to-end one that lists none, in every cell."""
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    return metric.get("moves") in e2e_names if "moves" in metric else True


def cell_metrics(man: dict, cell_name: str):
    """(end-to-end metrics, per-layer metrics) that the cell reports."""
    e2e = [m for m in man["end_to_end"] if _reports(m, cell_name, set())]
    names = {m["name"] for m in e2e}
    layer = [m for m in man["per_layer"] if _reports(m, cell_name, names)]
    return e2e, layer
