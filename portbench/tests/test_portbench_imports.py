"""Nothing the benchmark runs imports JAX or the JAX package, and a run
without a card, or without the program beside the benchmark, prints no
result and fails.  Module names are compared by their top-level name, whole:
``gpr_tpu_torch`` is the program, ``gpr_tpu`` is not."""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench_tiny import REPO, make_tree

BENCH = REPO / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "gpr_tpu", "bench", "benchmarks"}


def _top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(REPO)))
def test_no_module_imports_jax(path):
    assert not _top_level_imports(path) & FORBIDDEN


def test_top_level_names_compared_whole():
    from portbench.core import port

    assert "gpr_tpu_torch".split(".")[0] not in port.FORBIDDEN
    assert "gpr_tpu" in port.FORBIDDEN


def test_run_loads_no_jax(tmp_path):
    """A whole run (tiny cell, CPU) ends with no forbidden module loaded: the
    harness checks sys.modules before it prints and would exit 4."""
    tree = make_tree(tmp_path)
    probe = ("import sys, time; t0 = time.perf_counter(); sys.path[:0] = [sys.argv[1], sys.argv[2]];"
             "from portbench.core import harness, port;"
             "rc = harness.run(['--workload', 'tiny.fit', '--seed', '3', '--seconds', '0.2', '--trace', '0'],"
             " t0, device_name='cpu', check_device=False);"
             "print(json.dumps(port.forbidden_modules())) if rc == 0 else sys.exit(rc)")
    proc = subprocess.run([sys.executable, "-c", "import json;" + probe, str(tree), str(REPO)],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def _run(cwd: Path):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", "bench16k.fit", "--seed",
                           "1", "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True,
                          text=True, timeout=300)


def test_no_card_no_result():
    proc = _run(REPO)
    if proc.returncode == 0:
        pytest.skip("a CUDA device is present")
    assert proc.stdout.strip() == ""


def test_benchmark_alone_no_result(tmp_path):
    """Only BENCHMARK.json and portbench/: no program, so no result."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
