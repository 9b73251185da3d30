"""Dataset preparation utilities, the reference's scripts/data/ layer
(mirrors gpr_tpu/data/__init__.py:1-3)."""

from . import prep  # noqa: F401
