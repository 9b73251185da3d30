"""``fullchol_roofline.fit``: the least time of the fused Gram + factor of
every fit in the traced window over the device time of the kernels that
``kernels/ops.fullchol.json`` names (K2-K4).

Per fit: n^2 d (the Gram's lower triangle) + n^3 / 3 FLOP; X read once, the
factor's lower triangle and the 128-wide diagonal blocks' inverses W written
once.  None where those kernels did not run."""

from portbench.core import peaks

PANEL = 128


def bound_s(n: int, d: int) -> float:
    flop = n * n * d + n ** 3 / 3.0
    nbytes = peaks.F32 * (n * d + n * (n + 1) // 2 + n * PANEL)
    return peaks.bound_s(flop, nbytes)


def read(ctx):
    cfg, win, s = ctx["cfg"], ctx["traced"], ctx["trace"]
    t = s.module_ns.get("ops.fullchol", 0) * 1e-9
    if t <= 0:
        return None
    return 100.0 * bound_s(cfg["n"], cfg["d"]) * win.requests / t
