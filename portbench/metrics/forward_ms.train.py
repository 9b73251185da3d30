"""``forward_ms.train``: device time of the port's span ``gpr.mll.forward``
(inference/optimize.py::_run_adam: the marginal likelihood's value, a Gram
and a factorization, on the autograd tape) per Adam step of the traced
window; each request's final value is charged to its steps, as in
``library_ms.train``.  Steps are the port's ``gpr.adam.update`` spans; read
as ``factor_ms.fit`` is."""

from portbench.core import manifest

_per_request = manifest.load_module("metrics", "factor_ms.fit").per_request


def read(ctx):
    return _per_request(ctx, "gpr.fit_mle", "gpr.mll.forward", "gpr.adam.update")
