"""BENCHMARK.json keeps to the benchmark's contract, and every piece it names
has its file under portbench/."""

import json
import re

from portbench_tiny import REPO

MAN = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
B = REPO / "portbench"


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert MAN["paths"] == ["portbench"] and len(MAN["command"]) <= 32
    assert all(_line(w) for w in MAN["command"])
    rs = MAN["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    assert 1 <= len(MAN["configs"]) <= 24
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert (B / "data" / f"{cfg['data']['recipe']}.py").is_file()
        assert (B / "reference" / f"{cfg['reference']}.py").is_file()
        assert any(w["config"] == c["name"] for w in MAN["workloads"])


def _reports(metric, cell):
    return cell in metric["workloads"] if "workloads" in metric else True


def test_workloads():
    cells = MAN["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    configs = {c["name"] for c in MAN["configs"]}
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert NAME.match(w["traffic"]) and w["config"] in configs and w["chips"] in (1, 4)
        assert _line(w["why"])
        traffic = json.loads((B / "traffic" / f"{w['traffic']}.json").read_text())
        assert (B / "entries" / f"{traffic['entry']}.py").is_file()
        limits = json.loads((B / "limits" / f"{w['name']}.json").read_text())
        for number in limits.values():
            assert number["lower"] < number["limit"] < number["upper"]
            assert number["upper"] >= 3 * number["lower"]
        e2e = [m["name"] for m in MAN["end_to_end"] if _reports(m, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(_reports(m, w["name"]) for m in MAN["per_layer"])


def test_metrics():
    names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in names
    cells = {w["name"] for w in MAN["workloads"]}
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"]) and NAME.match(m["name"])
        assert set(m.get("workloads", [])) <= cells
        if m["name"] != "setup_s":
            assert (B / "e2e" / f"{m['name']}.py").is_file()
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    layers = {}
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert UNIT.match(m["unit"]) and NAME.match(m["name"]) and _line(m["layer"])
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert _reports(e2e[m["moves"]], cell)
        assert (B / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], set()).add(m["name"])
    perf = (REPO / "PERF.md").read_text()
    for layer in layers:
        assert f"**{layer}**" in perf, layer  # PERF.md's list of layers names it letter for letter
