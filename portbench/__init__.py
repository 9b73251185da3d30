"""The port's benchmark: see run.py and core/harness.py."""
