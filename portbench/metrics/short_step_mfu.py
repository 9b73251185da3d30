"""``short_step_mfu``: ``train_mfu`` (metrics/train_mfu.py) of a cell whose
training step is short and paced by the host, reported apart because it
moves ``short_step_ms``."""

from portbench.core import manifest

read = manifest.load_module("metrics", "train_mfu").read
