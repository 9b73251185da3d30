"""``idle_share.fit``: ``idle_share.train``'s reading (metrics/idle_share.train.py)
over the traced window's fits."""

from portbench.core import manifest

read = manifest.load_module("metrics", "idle_share.train").read
