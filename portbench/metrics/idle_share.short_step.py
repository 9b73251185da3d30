"""``idle_share.short_step``: ``idle_share.train``'s reading
(metrics/idle_share.train.py) in a cell whose training step is short and
paced by the host, reported apart because it moves ``short_step_ms``."""

from portbench.core import manifest

read = manifest.load_module("metrics", "idle_share.train").read
