"""``library_ms.short_step``: ``library_ms.train``'s reading
(metrics/library_ms.train.py) in a cell whose training step is short and
paced by the host, reported apart because it moves ``short_step_ms``."""

from portbench.core import manifest

read = manifest.load_module("metrics", "library_ms.train").read
