"""Kernel algebra of the port (mirrors gpr_tpu/kernels)."""

from . import dsl, kernels, utils  # noqa: F401
