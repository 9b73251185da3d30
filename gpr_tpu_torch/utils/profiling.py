"""Tracing, counters and per-stage timing.

Mirrors gpr_tpu/utils/profiling.py:1-80.  The reference times every
pipeline stage with std::chrono and writes per-frame latency text files
(reference apps/GaussianProcessLearn.cpp:104-162):

  * :class:`StageTimer`: named stages, CSV dump in the reference's
    trailing-comma single-line format (a copy of JAX's); on a card a stage
    closes after the device has finished its work;
  * :func:`trace`: a ``torch.profiler`` scope writing a Chrome trace
    (``trace.json``, host and CUDA activity) into ``log_dir``, where JAX
    writes a ``jax.profiler`` TensorBoard directory, with the spans and
    counters of the scope beside it (``spans.json``, ``counters.json``);
  * :func:`device_memory_stats`: live, peak and total bytes per CUDA device
    from ``torch.cuda.memory_stats`` under JAX's keys; ``{}`` where there is
    no CUDA device.

The port's own instrumentation, which the JAX package has not:

  * :func:`span`: a named interval at a stage boundary of the port
    (``gpr.fit.factor``, ``gpr.mll.backward``, ...), kept only while a
    ``torch.profiler`` records.  Off, a span costs one C call.  On, it opens
    a host-only profiler event (a ``cpu_op``, never a ``user_annotation``,
    which the profiler would mirror onto the device timeline), keeps a
    record in memory (:func:`spans`), and on a card records a CUDA event on
    the current stream at entry and at exit, whose interval is the span's
    time on the device timeline: its work, and any idle in which the device
    waited for the host inside it.
  * :func:`count`: integer counters, always on (:func:`counters`):
    ``launch.<kernel>`` (ops/_cuda.py), ``factor.<site>`` and
    ``retry.<site>`` (factorizations attempted and jitter retries),
    ``host_wait.<site>`` (each point where the host waits for the card:
    a read of a device value, a blocking copy between host and card) and
    ``adam.steps``.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional

import torch

# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------

_counters: Dict[str, int] = {}


def count(name: str, k: int = 1) -> None:
    """Add ``k`` to counter ``name``."""
    _counters[name] = _counters.get(name, 0) + k


def host_wait(site: str, t: torch.Tensor) -> None:
    """Count ``host_wait.<site>`` where ``t``, the tensor read or copied
    there, lives on a card: the host waits for the card at that point."""
    if t.is_cuda:
        count("host_wait." + site)


def counters() -> Dict[str, int]:
    """Every counter of the process, by name (a copy)."""
    return dict(_counters)


def reset_counters(prefix: str = "") -> None:
    """Set every counter whose name starts with ``prefix`` (all by default)
    back to 0."""
    for name in [n for n in _counters if n.startswith(prefix)]:
        del _counters[name]


def device_crossings(root) -> int:
    """Edges of the autograd graph under node ``root`` across which a
    gradient changes device.  Each is one copy in the backward, and the host
    waits for each: a copy from the card into pageable host memory, or from
    it to the card, blocks."""
    seen, todo, n = set(), [root], 0
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        meta = node._input_metadata
        here = meta[0].device.type if meta else None
        for nxt, i in node.next_functions:
            if nxt is None:
                continue
            if here is not None and nxt._input_metadata[i].device.type != here:
                n += 1
            todo.append(nxt)
    return n


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

RING = 65536  # span records kept; the oldest go first
_records: collections.deque = collections.deque(maxlen=RING)
_ids = itertools.count(1)
_calls = itertools.count(1)
_profiling = torch._C._autograd._profiler_enabled
_host_event = getattr(getattr(torch._C, "_profiler", None), "_RecordFunctionFast", None)


class _Stack(threading.local):
    def __init__(self) -> None:
        self.open: list = []


_stack = _Stack()  # per thread: autograd runs a backward on a thread of its own


class _Record:
    __slots__ = ("name", "id", "parent", "call", "start_ns", "end_ns", "child_ns", "events",
                 "device_ms")

    def __init__(self, name: str, parent: Optional["_Record"]):
        self.name = name
        self.id = next(_ids)
        self.parent = parent.id if parent is not None else None
        self.call = parent.call if parent is not None else next(_calls)
        self.child_ns = 0
        self.events = None
        self.device_ms = None


class _Span:
    __slots__ = ("rec", "host")

    def __init__(self, name: str):
        st = _stack.open
        self.rec = _Record(name, st[-1] if st else None)
        self.host = _host_event(name) if _host_event is not None else None

    def __enter__(self):
        rec = self.rec
        if self.host is not None:
            self.host.__enter__()
        if torch.cuda.is_initialized() and not torch.cuda.is_current_stream_capturing():
            rec.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            rec.events[0].record()
        _stack.open.append(rec)
        rec.start_ns = time.time_ns()
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        rec.end_ns = time.time_ns()
        if rec.events is not None:
            rec.events[1].record()
        st = _stack.open
        st.pop()
        if st:
            st[-1].child_ns += rec.end_ns - rec.start_ns
        _records.append(rec)
        if self.host is not None:
            self.host.__exit__(*exc)
        return False


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str):
    """A context manager that marks a stage of the port as ``name``; it
    records only while a ``torch.profiler`` records (see the module
    docstring).  The records' clock is ``time.time_ns()``, the profiler's."""
    if not _profiling():
        return _OFF
    return _Span(name)


def _device_ms(rec: _Record) -> Optional[float]:
    if rec.device_ms is None and rec.events is not None:
        start, end = rec.events
        end.synchronize()
        rec.device_ms = start.elapsed_time(end)
        rec.events = None
    return rec.device_ms


def spans(since: int = 0) -> List[dict]:
    """The kept span records with ``id`` > ``since``, oldest first: name, id,
    the parent's id (None at the top), ``call`` (the id of the top-level
    span it belongs to), start and end on the trace's clock (ns), ``ms``,
    ``self_ms`` (``ms`` less the children's) and ``device_ms`` (the
    interval between its CUDA events; None without a card)."""
    out = []
    for rec in list(_records):
        if rec.id <= since:
            continue
        out.append({"name": rec.name, "id": rec.id, "parent": rec.parent, "call": rec.call,
                    "start_ns": rec.start_ns, "end_ns": rec.end_ns,
                    "ms": (rec.end_ns - rec.start_ns) * 1e-6,
                    "self_ms": (rec.end_ns - rec.start_ns - rec.child_ns) * 1e-6,
                    "device_ms": _device_ms(rec)})
    return out


def reset() -> None:
    """Drop every kept span record."""
    _records.clear()


# ---------------------------------------------------------------------------
# per-stage timing and tracing
# ---------------------------------------------------------------------------

class StageTimer:
    """Wall-clock per named stage; ``csv()`` matches the reference's
    trailing-comma latency files (apps/GaussianProcessPredict.cpp:96-105).
    Where the process uses a card, a stage closes once the device has
    finished what the stage enqueued, so that it times the work and not its
    enqueue.  Each stage is the span ``gpr.stage.<name>``."""

    def __init__(self) -> None:
        self.stages: List[tuple] = []

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            with span(f"gpr.stage.{name}"):
                yield
                if torch.cuda.is_initialized():
                    count("host_wait.stage")
                    torch.cuda.synchronize()
        finally:
            self.stages.append((name, time.perf_counter() - t0))

    def totals(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, dt in self.stages:
            out[name] = out.get(name, 0.0) + dt
        return out

    def csv(self) -> str:
        return "".join(f"{dt}," for _, dt in self.stages)

    def write(self, path: str) -> None:
        with open(path, "a") as f:
            f.write(self.csv())


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` scope (host and, where there is a card, CUDA
    activity); on exit the Chrome trace ``log_dir/trace.json``, readable by
    chrome://tracing or Perfetto, the port's spans of the scope
    (``spans.json``, :func:`spans`' records) and what each counter gained
    in it (``counters.json``)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    since, before = next(_ids), counters()
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump(spans(since), f)
    gained = {k: v - before.get(k, 0) for k, v in counters().items() if v != before.get(k, 0)}
    with open(os.path.join(log_dir, "counters.json"), "w") as f:
        json.dump(gained, f, indent=1, sort_keys=True)


def device_memory_stats() -> Dict[str, Dict]:
    """Per-device live / peak / total bytes (profiling.py:64-80's keys)."""
    out: Dict[str, Dict] = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return out
