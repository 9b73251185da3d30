"""What the benchmark takes from the program under test, the PyTorch and
CUDA package ``gpr_tpu_torch``: its entry points, its kernels' library, and
nothing else.  Also the guard that no JAX reached the process."""

from __future__ import annotations

import sys

# top-level module names that may not be loaded in a benchmark process:
# compared whole, so ``gpr_tpu_torch`` is not ``gpr_tpu``
FORBIDDEN = ("jax", "jaxlib", "flax", "gpr_tpu")


def load(device):
    """Import the port; on a CUDA device build (first run in a checkout) or
    load its kernels' library, which it keeps in ``gpr_tpu_torch/_build/``."""
    import gpr_tpu_torch
    from gpr_tpu_torch.ops import _cuda

    if device.type == "cuda":
        _cuda.library()
    return gpr_tpu_torch


def kernel_of(port, cfg: dict):
    """The configuration's covariance kernel as the port's kernel object."""
    k = cfg["kernel"]
    return getattr(port, k["class"])(*k["params"])


def forbidden_modules() -> list:
    """Forbidden top-level names among the loaded modules."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))
