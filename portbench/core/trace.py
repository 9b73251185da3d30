"""From a ``torch.profiler`` trace to what the per-layer metrics read.

The traced window is the benchmark's own span ``portbench.window``.  Inside
it the device operations (kernels, copies, fills) give:

  busy_ns      the union of their intervals: time in which the device ran
               something
  module_ns    time in which a kernel of each port module ran (the union of
               its kernels' intervals: the factorization's lookahead runs
               two of them at once), by the maps in ``portbench/kernels/``;
               a kernel no map names is ``library`` (cuBLAS, cuSOLVER,
               PyTorch's own)
  device_ops   device time by operation, named ``<module>:<kernel>``, summed
  launches     how many device operations ran
  idle_gaps    the intervals in which the device ran nothing, each charged
               to what the host was doing then: the innermost host event
               (PyTorch operator, CUDA runtime call, the benchmark's span)
               that had begun last and not yet ended

The raw events are read from the profiler's Kineto results, without
building PyTorch's event tree, so a trace of a million events stays cheap.
"""

from __future__ import annotations

import collections
import dataclasses
import re
from typing import Dict, List, Tuple

WINDOW = "portbench.window"
REQUEST = "portbench.request"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
LIBRARY = "library"


@dataclasses.dataclass
class Summary:
    window_ns: int
    busy_ns: int
    launches: int
    module_ns: Dict[str, int]
    device_ops: List[Tuple[str, int]]   # (label, ns), longest first
    idle_gaps: List[Tuple[str, int]]    # (host activity, ns), longest first

    def breakdown(self, top: int = 10) -> dict:
        return {"device_ops": [[k, v * 1e-9] for k, v in self.device_ops[:top]],
                "idle_gaps": [[k, v * 1e-9] for k, v in self.idle_gaps[:top]]}


class KernelMap:
    """Kernel name (as the trace gives it, demangled) -> (module, short name)."""

    def __init__(self, maps: Dict[str, str]):
        self._patterns = [(re.compile(r"(?<![A-Za-z0-9_])" + re.escape(k) + r"(?![A-Za-z0-9_])"), k, m)
                          for k, m in maps.items()]
        self._cache = {}

    def __call__(self, name: str) -> Tuple[str, str]:
        hit = self._cache.get(name)
        if hit is None:
            hit = next(((m, k) for pat, k, m in self._patterns if pat.search(name)), None)
            if hit is None:
                short = name[5:] if name.startswith("void ") else name
                hit = (LIBRARY, short[:96])
            self._cache[name] = hit
        return hit


def _kind(event) -> str:
    """What an event is, told from the device it ran on and its name (the
    profiler's events carry no activity type that PyTorch exposes)."""
    if not str(event.device_type()).endswith("CUDA"):
        return "host"  # an operator, a CUDA runtime call or a span on the host
    name = event.name()
    if name in (WINDOW, REQUEST):
        return "gpu_user_annotation"
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def summarize(kineto_events, kernel_map: KernelMap, min_gap_ns: int = 1000) -> Summary:
    """Reduce the profiler's raw events (``prof.profiler.kineto_results
    .events()``) over the traced window."""
    dev, host, win = [], [], None
    for ev in kineto_events:
        kind = _kind(ev)
        if kind in DEVICE_KINDS:
            s = ev.start_ns()
            dev.append((s, s + ev.duration_ns(), kind, ev.name()))
        elif kind == "host":
            name, s = ev.name(), ev.start_ns()
            if name == WINDOW:
                win = (s, s + ev.duration_ns())
            else:
                host.append((s, s + ev.duration_ns(), name))
    if win is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span")
    w0, w1 = win
    by_module = collections.defaultdict(list)
    ops = collections.Counter()
    inside = []
    for s, e, kind, name in dev:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        inside.append((s, e))
        if kind == "kernel":
            module, short = kernel_map(name)
            by_module[module].append((s, e))
            ops[f"{module}:{short}"] += e - s
        else:
            ops[f"memory:{name}"] += e - s
    busy = _union(inside)
    gaps, t = [], w0
    for s, e in busy:
        if s - t >= min_gap_ns:
            gaps.append((t, s))
        t = e
    if w1 - t >= min_gap_ns:
        gaps.append((t, w1))
    module_ns = {m: sum(e - s for s, e in _union(iv)) for m, iv in by_module.items()}
    return Summary(w1 - w0, sum(e - s for s, e in busy), len(inside), module_ns,
                   ops.most_common(), _charge(gaps, host).most_common())


def _charge(gaps, host) -> collections.Counter:
    """Each gap's length, charged to the host event that covers its middle and
    began last; ``python`` where only the benchmark's request span covers it
    (the host between operators), ``none`` where nothing does."""
    host.sort()
    out = collections.Counter()
    open_, j = [], 0
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        while j < len(host) and host[j][0] <= mid:
            open_.append(host[j])
            j += 1
        open_ = [h for h in open_ if h[1] >= mid]
        if not open_:
            out["none"] += g1 - g0
            continue
        name = max(open_)[2]
        out["python" if name == REQUEST else name] += g1 - g0
    return out
