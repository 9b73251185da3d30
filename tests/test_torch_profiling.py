"""utils/profiling.py on the CPU: the port's spans and counters.

* Off (no ``torch.profiler`` recording) a span keeps nothing and opens no
  profiler event.
* On, each span is a host ``cpu_op`` event of its name, never a
  ``user_annotation`` (which the profiler would mirror onto the device
  timeline), and a record with its parent, the id of its top-level call and
  its self time (its time less its children's); the stack is per thread,
  and the records are a bounded ring.
* ``fit`` and ``fit_mle`` open the spans that the benchmark's per-layer
  metrics read (``gpr.fit.factor``, ``gpr.mll.backward``, ...), and count
  ``adam.steps``; a CPU run waits for no card.
* ``factor.<site>`` and ``retry.<site>`` count the factorizations tried and
  the jitter retries, by the tries made.
* ``ops._cuda.launch_counts()`` keeps its shape over the counters.
* ``StageTimer``'s stages are spans ``gpr.stage.<name>``; ``trace`` writes
  the scope's spans and counters beside its Chrome trace.
* ``device_crossings`` counts the edges of an autograd graph where a
  gradient changes device (on the ``meta`` device, where nothing runs).

Spans on the card (device time, no device events, the host waits against
``torch.cuda.set_sync_debug_mode``) are tests/test_torch_cuda.py's.
"""

import collections
import json
import math
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import gpr_tpu_torch as tg
from gpr_tpu_torch.ops import _cuda, linalg
from gpr_tpu_torch.ops import batched as fleet_ops
from gpr_tpu_torch.utils import profiling as prof


@pytest.fixture(autouse=True)
def _no_records():
    prof.reset()
    yield
    prof.reset()


def _profiled(fn):
    """The ``gpr.*`` events of a CPU profile of ``fn()``."""
    with profile(activities=[ProfilerActivity.CPU]) as p:
        fn()
    return [e for e in p.profiler.kineto_results.events() if e.name().startswith("gpr.")]


def _data(n=48, d=3, q=2):
    g = torch.Generator().manual_seed(5)
    return (torch.randn(n, d, generator=g, dtype=torch.float64),
            torch.randn(n, q, generator=g, dtype=torch.float64))


def _gained(before):
    return {k: v - before.get(k, 0) for k, v in prof.counters().items() if v != before.get(k, 0)}


def test_off_a_span_keeps_nothing_and_opens_no_event(monkeypatch):
    opened = []
    monkeypatch.setattr(prof, "_host_event", opened.append)
    with prof.span("gpr.a"):
        with prof.span("gpr.b"):
            pass
    X, Y = _data()
    tg.fit(tg.Gaussian(1.0, 1.0), X, Y, sigma=0.1, device="cpu")
    assert prof.spans() == [] and opened == []
    assert prof.span("gpr.a") is prof.span("gpr.b")  # one object that does nothing


def test_spans_are_host_ops_with_parents_calls_and_self_time():
    def work():
        with prof.span("gpr.a"):
            with prof.span("gpr.b"):
                time.sleep(0.003)
            with prof.span("gpr.c"):
                with prof.span("gpr.d"):
                    pass
        with prof.span("gpr.e"):
            pass

    events = _profiled(work)
    assert sorted(e.name() for e in events) == ["gpr.a", "gpr.b", "gpr.c", "gpr.d", "gpr.e"]
    assert all(e.activity_type() == "cpu_op" and not e.is_user_annotation()
               and str(e.device_type()).endswith("CPU") for e in events)
    recs = {r["name"]: r for r in prof.spans()}
    a, b, c, d, e = (recs[f"gpr.{k}"] for k in "abcde")
    assert (a["parent"], b["parent"], c["parent"], d["parent"], e["parent"]) == (None, a["id"], a["id"],
                                                                                c["id"], None)
    assert a["call"] == b["call"] == c["call"] == d["call"] != e["call"]
    assert b["ms"] >= 3 and a["ms"] >= b["ms"] + c["ms"]
    assert a["self_ms"] == pytest.approx(a["ms"] - b["ms"] - c["ms"], abs=1e-9)
    assert c["self_ms"] == pytest.approx(c["ms"] - d["ms"], abs=1e-9) and d["self_ms"] == d["ms"]
    assert all(r["device_ms"] is None for r in recs.values())  # no card
    # the records' clock is the profiler's: each starts within a millisecond of its event
    starts = {ev.name(): ev.start_ns() for ev in events}
    assert all(abs(starts[r["name"]] - r["start_ns"]) < 1_000_000 for r in recs.values())
    assert [r["name"] for r in prof.spans(since=c["id"])] == ["gpr.d", "gpr.e"]


def test_the_span_stack_is_per_thread_and_the_ring_is_bounded(monkeypatch):
    # the profiler's switch is per thread (autograd hands it to its own
    # threads); here it reads on for every thread
    monkeypatch.setattr(prof, "_profiling", lambda: True)

    def other():
        with prof.span("gpr.thread"):
            pass

    def work():
        with prof.span("gpr.main"):
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()

    work()
    recs = {r["name"]: r for r in prof.spans()}
    assert recs["gpr.thread"]["parent"] is None and recs["gpr.thread"]["call"] != recs["gpr.main"]["call"]

    monkeypatch.setattr(prof, "_records", collections.deque(maxlen=3))

    def five():
        for i in range(5):
            with prof.span(f"gpr.s{i}"):
                pass

    five()
    assert [r["name"] for r in prof.spans()] == ["gpr.s2", "gpr.s3", "gpr.s4"]


def test_fit_and_fit_mle_open_their_stage_spans():
    X, Y = _data()
    k = tg.Gaussian(1.0, 1.0)
    before = prof.counters()

    def work():
        tg.fit(k, X, Y, sigma=0.1, device="cpu")
        tg.fit_mle(k, X, Y, 0.1, iterations=2, device="cpu")

    _profiled(work)
    recs = prof.spans()
    byname = collections.Counter(r["name"] for r in recs)
    assert byname == {"gpr.fit": 1, "gpr.fit.factor": 1, "gpr.fit.solve": 1, "gpr.fit_mle": 1,
                      "gpr.mll.forward": 3, "gpr.mll.backward": 2, "gpr.adam.update": 2}
    ids = {r["id"]: r for r in recs}
    for r in recs:
        parent = ids[r["parent"]]["name"] if r["parent"] is not None else None
        want = {"gpr.fit": None, "gpr.fit_mle": None, "gpr.fit.factor": "gpr.fit",
                "gpr.fit.solve": "gpr.fit"}.get(r["name"], "gpr.fit_mle")
        assert parent == want, r
    gained = _gained(before)
    assert gained.get("adam.steps") == 2
    assert gained.get("factor.linalg") == 1 + 3  # the fit's and one a value
    assert not any(k.startswith(("host_wait.", "retry.")) and v for k, v in gained.items())


def test_a_matrix_that_needs_jitter_counts_its_tries():
    A = torch.ones(6, 6, dtype=torch.float64)  # rank one: the first attempt fails
    before = prof.counters()
    L, jitter = linalg.safe_cholesky(A)
    gained = _gained(before)
    retries = gained["retry.linalg"]
    assert retries >= 1 and gained["factor.linalg"] == 1 + retries
    assert torch.isfinite(L).all()
    eps = torch.finfo(torch.float64).eps
    assert math.isclose(float(jitter), eps * 10 ** (retries - 1), rel_tol=1e-9)
    before = prof.counters()
    linalg.safe_cholesky(A + 6 * torch.eye(6, dtype=torch.float64))
    assert _gained(before) == {"factor.linalg": 1}


def test_a_fleet_counts_members_factored_and_retried():
    g = torch.Generator().manual_seed(2)
    B = torch.randn(4, 8, 8, generator=g, dtype=torch.float64)
    K = B @ B.mT + 8 * torch.eye(8, dtype=torch.float64)
    K[2] = torch.ones(8, 8, dtype=torch.float64)  # one member fails its first attempt
    Y = torch.randn(4, 8, 1, generator=g, dtype=torch.float64)
    before = prof.counters()
    L, alpha, jitter = fleet_ops.factor_solve_safe(K, Y, route="torch-cholesky")
    gained = _gained(before)
    retries = gained["retry.fleet"]
    assert retries >= 1 and gained["factor.fleet"] == 4 + retries
    assert torch.isfinite(L).all() and bool((jitter[[0, 1, 3]] == 0).all()) and float(jitter[2]) > 0


def test_launch_counts_keep_their_shape():
    _cuda.reset_launch_counts()
    counts = _cuda.launch_counts()
    assert list(counts) == [k.name for k in _cuda.KERNELS] and len(counts) == 20
    assert set(counts.values()) == {0}
    prof.count("launch.syrk_update", 3)
    prof.count("factor.linalg")
    assert _cuda.launch_counts()["syrk_update"] == 3
    _cuda.reset_launch_counts()
    assert set(_cuda.launch_counts().values()) == {0} and prof.counters()["factor.linalg"] >= 1


def test_stage_timer_stages_are_spans_and_trace_writes_them(tmp_path):
    timer = prof.StageTimer()
    X, Y = _data()
    with prof.trace(str(tmp_path / "t")):
        with timer.stage("parse"):
            pass
        with timer.stage("fit"):
            tg.fit(tg.Gaussian(1.0, 1.0), X, Y, sigma=0.1, device="cpu")
    assert [n for n, _ in timer.stages] == ["parse", "fit"]
    spans = json.loads((tmp_path / "t" / "spans.json").read_text())
    names = [s["name"] for s in spans]
    assert names == ["gpr.stage.parse", "gpr.fit.factor", "gpr.fit.solve", "gpr.fit", "gpr.stage.fit"]
    ids = {s["id"]: s["name"] for s in spans}
    assert ids[spans[3]["parent"]] == "gpr.stage.fit"
    assert json.loads((tmp_path / "t" / "counters.json").read_text()) == {"factor.linalg": 1}
    assert (tmp_path / "t" / "trace.json").is_file()


def test_device_crossings_count_where_a_gradient_changes_device():
    p = torch.tensor(2.0, dtype=torch.float64, requires_grad=True)
    m = torch.ones(3, device="meta")
    # p ** 2 on the host, then two operators on the meta device that take a host value
    y = ((p ** 2) * m / p).sum()
    assert prof.device_crossings(y.grad_fn) == 2
    assert prof.device_crossings((p ** 2 * torch.ones(3, dtype=torch.float64)).sum().grad_fn) == 0
    assert prof.device_crossings(None) == 0
