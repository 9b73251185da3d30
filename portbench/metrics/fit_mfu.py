"""``fit_mfu``: the fits of the untraced window, counted by bench.py's FLOP
model (2 n^2 d + n^3 / 3 + 2 n^2 q), over the window's host-clock time, as
a share of the card's 3xTF32 peak.  The untraced window, the one that
``fit_ms`` reads, so that the profiler's cost on the host is not in it."""

from portbench.core import counts, peaks


def read(ctx):
    cfg, win = ctx["cfg"], ctx["window"]
    flop = counts.fit_flop(cfg["n"], cfg["d"], cfg["q"]) * win.requests
    return 100.0 * flop / win.seconds / peaks.FLOPS
