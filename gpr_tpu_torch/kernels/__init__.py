"""Kernel algebra of the port (mirrors gpr_tpu/kernels)."""
