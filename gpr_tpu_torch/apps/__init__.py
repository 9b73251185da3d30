"""The command-line apps (mirrors gpr_tpu/apps): ``learn`` and ``predict``."""
