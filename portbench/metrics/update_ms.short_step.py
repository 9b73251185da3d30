"""``update_ms.short_step``: device time of the port's span
``gpr.adam.update`` (inference/optimize.py::_run_adam: the gradient's mask,
``torch.optim.Adam``'s step on the host and the trace's entry, a read of the
step's value) per Adam step of the traced window.  Adam steps a host tensor,
so the device runs nothing of it: this is the time the device waits for the
host between a step's backward and the next forward.  Read as
``factor_ms.fit`` is."""

from portbench.core import manifest

_per_request = manifest.load_module("metrics", "factor_ms.fit").per_request


def read(ctx):
    return _per_request(ctx, "gpr.fit_mle", "gpr.adam.update", "gpr.adam.update")
