"""Utilities of the port (mirrors gpr_tpu/utils)."""
