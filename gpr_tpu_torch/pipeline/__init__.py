"""The feature pipeline: PCA, AR(p), image I/O and the data parser
(mirrors gpr_tpu/pipeline/__init__.py:1-3)."""

from . import autoregression, dataparser, imageio, pca  # noqa: F401
