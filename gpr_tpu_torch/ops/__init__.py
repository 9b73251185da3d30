"""Numerics of the port: the hand-written CUDA kernels and the linear algebra
around them (mirrors gpr_tpu/ops)."""

from . import blocked, gram, linalg  # noqa: F401
