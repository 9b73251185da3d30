"""``short_step_ms``: ``train_step_ms`` (e2e/train_step_ms.py) of a cell whose
training step is short and paced by the host, so that its runs spread as
the host's speed does; kept apart so that each has a bound of its own."""

from portbench.core import manifest

read = manifest.load_module("e2e", "train_step_ms").read
