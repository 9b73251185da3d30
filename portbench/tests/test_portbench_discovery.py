"""A configuration, a traffic mix, the loop it drives and a per-layer metric
are each added as new files beside the others, with an entry in
BENCHMARK.json, and the harness finds them by name: no file that was there
changes.  A per-layer metric that names no cells is reported in every cell
that reports the end-to-end metric it moves."""

import hashlib
import json

from portbench_tiny import make_tree, run_cell


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "portbench").rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_found_by_name(tmp_path):
    tree = make_tree(tmp_path)
    before = _digests(tree)
    b = tree / "portbench"
    (b / "configs" / "newcfg.json").write_text(json.dumps({
        "name": "newcfg", "source": "test", "kernel": {"form": "gaussian", "class": "Gaussian",
        "params": [2.5, 1.0]}, "sigma": 0.2, "n": 200, "d": 4, "q": 1, "dtype": "float32",
        "data": {"recipe": "gaussian_iid"}, "reference": "exact_gp", "reduced": [], "assumed": []}))
    (b / "traffic" / "newmix.json").write_text(json.dumps({
        "entry": "fit", "loop": "counted", "datasets": 3, "warmup_requests": 1,
        "trace_seconds": 1, "why": "test"}))
    (b / "loops" / "counted.py").write_text(
        '"""The closed loop, counting the windows it ran."""\n\n'
        'from portbench.core import manifest\n\nRUNS = []\n\n\n'
        'def run(*args, **kwargs):\n    RUNS.append(1)\n'
        '    return manifest.load_module("loops", "closed").run(*args, **kwargs)\n')
    (b / "metrics" / "answers_per_request.newmix.py").write_text(
        '"""Answers a request returned: always 1 for a fit."""\n\n\n'
        'def read(ctx):\n    return len(ctx["window"].answers) / ctx["window"].requests\n')
    (b / "metrics" / "windows_run.py").write_text(
        '"""Windows that the loop ``counted`` ran in this process; None where it ran none."""\n\n'
        'from portbench.core import manifest\n\n\n'
        'def read(ctx):\n    return float(len(manifest.load_module("loops", "counted").RUNS)) or None\n')
    (b / "limits" / "newcfg.newmix.json").write_text(json.dumps(
        {"alpha_gap": {"limit": 1e-3}, "logdet_gap": {"limit": 1e-5}}))
    man = json.loads((tree / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "newcfg", "source": "test", "file": "portbench/configs/newcfg.json",
                           "reduced": [], "why": "test"})
    man["workloads"].append({"name": "newcfg.newmix", "config": "newcfg", "traffic": "newmix",
                             "chips": 1, "why": "test"})
    for m in man["end_to_end"]:
        if m["name"] in ("fit_ms", "fit_p95_ms"):
            m["workloads"].append("newcfg.newmix")
    man["per_layer"].append({"name": "answers_per_request.newmix", "unit": "1", "better": "higher",
                             "source": "program_counter", "layer": "gp.exact", "moves": "fit_ms",
                             "workloads": ["newcfg.newmix"]})
    man["per_layer"].append({"name": "windows_run", "unit": "1", "better": "higher",
                             "source": "program_counter", "layer": "gp.exact", "moves": "fit_ms"})
    (tree / "BENCHMARK.json").write_text(json.dumps(man))
    after = _digests(tree)
    assert all(after[p] == d for p, d in before.items())  # nothing that was there changed

    r = run_cell(tree, "newcfg.newmix", 11)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"fit_ms", "fit_p95_ms", "setup_s"}
    r = run_cell(tree, "newcfg.newmix", 12, trace=1)
    assert r["metrics"]["answers_per_request.newmix"]["value"] == 1.0
    assert r["metrics"]["windows_run"]["value"] == 2.0  # the untraced window and the traced one
    assert r["correct"]
    r = run_cell(tree, "tiny.fit", 13, trace=1)  # reports fit_ms, so windows_run too
    assert "windows_run" not in r["metrics"]  # the loop is ``closed``: nothing to read, left out
    assert "answers_per_request.newmix" not in r["metrics"]
