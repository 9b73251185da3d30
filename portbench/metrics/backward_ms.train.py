"""``backward_ms.train``: device time of the port's span ``gpr.mll.backward``
(inference/optimize.py::_run_adam: ``torch.autograd.grad``, the Murray
pullback's products and solves and the Gram's backward, to the gradient's
copies back to the host) per Adam step of the traced window; read as
``forward_ms.train`` is."""

from portbench.core import manifest

_per_request = manifest.load_module("metrics", "factor_ms.fit").per_request


def read(ctx):
    return _per_request(ctx, "gpr.fit_mle", "gpr.mll.backward", "gpr.adam.update")
