"""``fullchol_roofline.train``: the least time of the factorizations of the
traced window's training requests (each ``iterations`` + 1: one a step and
the final value) over the device time of the kernels that
``kernels/ops.fullchol.json`` names (K2-K4 on a given K, ``fused-matrix``).

Per factorization: n^3 / 3 FLOP; K's lower triangle read once, L's lower
triangle and the 128-wide diagonal blocks' inverses W written once.  None
where those kernels did not run."""

from portbench.core import peaks

PANEL = 128


def bound_s(n: int) -> float:
    nbytes = peaks.F32 * (2 * (n * (n + 1) // 2) + n * PANEL)
    return peaks.bound_s(n ** 3 / 3.0, nbytes)


def read(ctx):
    cfg, win, s = ctx["cfg"], ctx["traced"], ctx["trace"]
    t = s.module_ns.get("ops.fullchol", 0) * 1e-9
    if t <= 0:
        return None
    factorizations = win.requests * (int(ctx["traffic"]["iterations"]) + 1)
    return 100.0 * bound_s(cfg["n"]) * factorizations / t
