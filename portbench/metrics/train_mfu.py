"""``train_mfu``: the training requests of the untraced window, counted from
the shapes (core/counts.py: each step the fit's forward and Murray's
backward, 7 n^3 / 3; each request ``iterations`` steps and a final value),
over the window's host-clock time, as a share of the card's 3xTF32 peak.
The untraced window, the one that the step time reads, so that the
profiler's cost on the host is not in it."""

from portbench.core import counts, peaks


def read(ctx):
    cfg, win = ctx["cfg"], ctx["window"]
    flop = counts.train_request_flop(cfg["n"], cfg["d"], cfg["q"],
                                     int(ctx["traffic"]["iterations"])) * win.requests
    return 100.0 * flop / win.seconds / peaks.FLOPS
