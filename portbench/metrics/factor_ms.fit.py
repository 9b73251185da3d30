"""``factor_ms.fit``: device time of the port's span ``gpr.fit.factor``
(gp/exact.py::fit: the Gram, the factor K2-K4, its jitter loop and its
check) per fit of the traced window.

The port keeps its spans in memory while a profiler records
(``gpr_tpu_torch.utils.profiling.spans``).  A span's device time is the
interval between the CUDA events it records on the current stream at entry
and at exit: its work, and any idle in which the device waited for the host
inside it.  The window's requests are the last ``traced.requests`` top-level
spans of the request's kind, so the request run under the profiler before
the window opens is left out.  None where the port keeps no spans, or kept
none of those asked for."""


def per_request(ctx, top: str, name: str, per: str):
    """Device ms of the spans ``name`` over the number of spans ``per``, both
    within the window's requests, each a top-level span ``top``."""
    try:
        from gpr_tpu_torch.utils.profiling import spans
    except ImportError:  # a port without span records
        return None
    recs = spans()
    calls = set([r["call"] for r in recs if r["parent"] is None and r["name"] == top]
                [-ctx["traced"].requests:])
    ms = [r["device_ms"] for r in recs if r["call"] in calls and r["name"] == name]
    count = sum(1 for r in recs if r["call"] in calls and r["name"] == per)
    if not ms or not count or any(v is None for v in ms):
        return None
    return sum(ms) / count


def read(ctx):
    return per_request(ctx, "gpr.fit", "gpr.fit.factor", "gpr.fit")
