"""The feature pipeline: PCA, AR(p), image I/O and the data parser
(mirrors gpr_tpu/pipeline/__init__.py:1-3), and the image pipeline that JAX
keeps beside them in gpr_tpu/pipeline/: B-spline resampling, warping and
the itkUtils filters."""

from . import autoregression, bspline, dataparser, filters, imageio, pca, warp  # noqa: F401
