"""The per-layer metrics that read the port's own spans and counters
(``gpr_tpu_torch.utils.profiling``): made-up records give the numbers
worked out by hand, and a port without the registry, or one that recorded
nothing, gives None without raising."""

import types

import pytest

from portbench.core import manifest

SPAN_METRICS = ("factor_ms.fit", "solve_ms.fit", "forward_ms.train", "backward_ms.train",
                "forward_ms.short_step", "backward_ms.short_step", "update_ms.short_step")
COUNTER_METRICS = ("host_waits_per_step.short_step", "retries_per_factor.short_step")


def _read(name, requests=2):
    return manifest.load_module("metrics", name).read({"traced": types.SimpleNamespace(requests=requests)})


class _Spans:
    """Records as ``spans()`` gives them: ``add(name, device_ms, parent)``."""

    def __init__(self):
        self.recs, self.call = [], 0

    def add(self, name, device_ms, parent=None):
        if parent is None:
            self.call += 1
        rec = {"name": name, "id": len(self.recs) + 1, "parent": parent["id"] if parent else None,
               "call": self.call, "start_ns": 0, "end_ns": 0, "ms": 0.0, "self_ms": 0.0,
               "device_ms": device_ms}
        self.recs.append(rec)
        return rec


def _fits():
    s = _Spans()
    # the request run under the profiler before the window, then the window's two
    for factor, solve in ((100.0, 100.0), (24.0, 40.0), (26.0, 44.0)):
        top = s.add("gpr.fit", factor + solve + 1.0)
        s.add("gpr.fit.factor", factor, top)
        s.add("gpr.fit.solve", solve, top)
    return s.recs


def _training():
    s = _Spans()
    for scale in (100.0, 1.0, 2.0):  # the pre-window request, then the window's two
        top = s.add("gpr.fit_mle", 0.0)
        for _ in range(2):  # two steps
            s.add("gpr.mll.forward", 5.0 * scale, top)
            s.add("gpr.mll.backward", 7.0 * scale, top)
            s.add("gpr.adam.update", 0.5 * scale, top)
        s.add("gpr.mll.forward", 4.0 * scale, top)  # the final value
    return s.recs


@pytest.fixture
def profiling(monkeypatch):
    from gpr_tpu_torch.utils import profiling as prof

    return prof


def test_span_metrics_from_made_up_records(profiling, monkeypatch):
    monkeypatch.setattr(profiling, "spans", _fits)
    assert _read("factor_ms.fit") == pytest.approx(25.0)
    assert _read("solve_ms.fit") == pytest.approx(42.0)
    assert _read("factor_ms.fit", requests=3) == pytest.approx(150.0 / 3)
    monkeypatch.setattr(profiling, "spans", _training)
    # per step: the steps' forwards and the final value, over the two requests' four steps
    assert _read("forward_ms.train") == pytest.approx((14.0 + 28.0) / 4)
    assert _read("forward_ms.short_step") == _read("forward_ms.train")
    assert _read("backward_ms.train") == pytest.approx((14.0 + 28.0) / 4)
    assert _read("backward_ms.short_step") == _read("backward_ms.train")
    assert _read("update_ms.short_step") == pytest.approx((1.0 + 2.0) / 4)
    assert _read("factor_ms.fit") is None  # no fit among the records


def test_counter_metrics_from_made_up_counters(profiling, monkeypatch):
    monkeypatch.setattr(profiling, "counters", lambda: {
        "host_wait.linalg.ok": 9, "host_wait.adam.grad": 16, "host_wait.adam.trace": 8,
        "host_wait.adam.final": 1, "host_wait.linalg.add_diagonal": 9, "adam.steps": 8,
        "launch.syrk_update": 40, "factor.linalg": 10, "retry.linalg": 1, "factor.fleet": 6,
        "retry.fleet": 3})
    assert _read("host_waits_per_step.short_step") == pytest.approx(43 / 8)
    assert _read("retries_per_factor.short_step") == pytest.approx(4 / 16)


@pytest.mark.parametrize("name", SPAN_METRICS + COUNTER_METRICS)
def test_a_port_without_the_registry_or_records_gives_none(profiling, monkeypatch, name):
    monkeypatch.setattr(profiling, "spans", lambda: [])
    monkeypatch.setattr(profiling, "counters", lambda: {})
    assert _read(name) is None  # recorded nothing
    cpu = [dict(r, device_ms=None) for r in _fits() + _training()]
    monkeypatch.setattr(profiling, "spans", lambda: cpu)
    monkeypatch.setattr(profiling, "counters", lambda: {"factor.linalg": 0, "adam.steps": 0})
    assert _read(name) is None  # no card: no device time; no step, no factorization
    monkeypatch.delattr(profiling, "spans")
    monkeypatch.delattr(profiling, "counters")
    assert _read(name) is None  # the parent's port
