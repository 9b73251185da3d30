"""``solve_ms.fit``: device time of the port's span ``gpr.fit.solve``
(gp/exact.py::fit: ``cho_solve_panels``' 2 x n / 128 panel steps, enqueued
from the host, and the idle between them) per fit of the traced window;
read as ``factor_ms.fit`` is."""

from portbench.core import manifest

_per_request = manifest.load_module("metrics", "factor_ms.fit").per_request


def read(ctx):
    return _per_request(ctx, "gpr.fit", "gpr.fit.solve", "gpr.fit")
