"""``syrk_roofline.short_step``: the least time of the trailing updates (K5,
``kernels/ops.syrk.json``) of the traced window's factorizations (each
training request ``iterations`` + 1) over their device time.

The updates are those of ops/blocked.py's recursion, mirrored here: split
at half of n rounded up to a multiple of 128, leaves of at most 1024 rows,
one update S = A22 - L21 L21^T of A22 (m, m) by L21 (m, k) a split.  An
update computes the lower triangle with its diagonal, m (m + 1) k FLOP,
reads A22's lower triangle and L21 once and writes the lower triangle once;
each is its own launch, so each has its own bound.  None where K5 did not
run."""

from portbench.core import peaks

LEAF = 1024
ALIGN = 128


def split(n: int) -> int:
    half = (n + 1) // 2
    return min(((half + ALIGN - 1) // ALIGN) * ALIGN, n - 1) if n > ALIGN else n // 2


def updates(n: int, leaf: int = LEAF) -> list:
    """[(m, k)] of every trailing update of one factorization of size n."""
    if n <= leaf:
        return []
    m = split(n)
    return updates(m, leaf) + [(n - m, m)] + updates(n - m, leaf)


def bound_s(n: int) -> float:
    total = 0.0
    for m, k in updates(n):
        tri = m * (m + 1) // 2
        total += peaks.bound_s(float(m) * (m + 1) * k, peaks.F32 * (2 * tri + m * k))
    return total


def read(ctx):
    cfg, win, s = ctx["cfg"], ctx["traced"], ctx["trace"]
    t = s.module_ns.get("ops.syrk", 0) * 1e-9
    if t <= 0:
        return None
    factorizations = win.requests * (int(ctx["traffic"]["iterations"]) + 1)
    return 100.0 * bound_s(cfg["n"]) * factorizations / t
