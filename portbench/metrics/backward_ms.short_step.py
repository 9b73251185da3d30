"""``backward_ms.short_step``: ``backward_ms.train``'s reading
(metrics/backward_ms.train.py) in a cell whose training step is short and
paced by the host, reported apart because it moves ``short_step_ms``."""

from portbench.core import manifest

read = manifest.load_module("metrics", "backward_ms.train").read
