"""GP models of the port (mirrors gpr_tpu/gp)."""
