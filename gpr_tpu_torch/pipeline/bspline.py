"""Cubic B-spline image resampling, N-D.

Mirrors gpr_tpu/pipeline/bspline.py:1-152 (``spline_filter``,
``map_coordinates_cubic``, ``_mirror_index``, ``_cubic_weights``), the
reference's default warping interpolator (reference include/itkUtils.h:
1098-1158, ITK's BSplineInterpolateImageFunction; Unser, "Splines: a perfect
fit", 1999):

  1. ``spline_filter``: the coefficient prefilter.  Per axis one causal and
     one anticausal first-order recursion with pole z1 = sqrt(3) - 2 and the
     exact mirror-boundary initializations (bspline.py:37-76), the contract of
     ``scipy.ndimage.spline_filter(order=3, mode='mirror')``.  JAX runs the
     recursions as ``lax.scan``.  The filter is linear, so here the recursion
     runs once per axis length n on the n x n identity, in float64 on the
     host, and each axis of the image is then one product with that matrix
     F_n: one ``torch.matmul`` a axis on the card, where a scan would be n
     dependent steps of small launches.  F_n is dense (the anticausal pass
     reaches every sample) and costs n^2 per line where the scan costs n, a
     trade that pays for image axes of a few hundred samples.
  2. ``map_coordinates_cubic``: four taps an axis with the cubic B-spline
     weights, mirror index folding, and one weighted gather sum of 4^nd
     terms, unrolled as in JAX.

The functions take the dtype of their inputs and run on the card unless
given ``device="cpu"`` or CPU tensors (utils/config.py).
"""

from __future__ import annotations

import functools
import itertools
import math

import numpy as np
import torch

from ..utils import config

# cubic B-spline pole (Unser 1999, table 1)
_Z1 = math.sqrt(3.0) - 2.0


def _filter_matrix_np(n: int) -> np.ndarray:
    """F_n (n, n) with F_n @ s = the cubic-spline coefficients of the samples
    s along one axis: bspline.py:37-76's recursions run on the identity in
    float64 (the gain 6 folded into the input, the exact mirror-period
    initializations)."""
    if n == 1:
        return np.ones((1, 1))
    z = _Z1
    c = 6.0 * np.eye(n)
    k = np.arange(n, dtype=np.float64)
    w = z**k + z ** (2.0 * (n - 1.0) - k)
    w[0] = 1.0
    w[n - 1] = z ** (n - 1.0)
    denom = 1.0 - z ** (2.0 * (n - 1.0))
    cp = np.empty_like(c)
    cp[0] = (w / denom) @ c
    for i in range(1, n):
        cp[i] = c[i] + z * cp[i - 1]
    cm = np.empty_like(c)
    cm[n - 1] = (z / (z * z - 1.0)) * (cp[n - 1] + z * cp[n - 2])
    for i in range(n - 2, -1, -1):
        cm[i] = z * (cm[i + 1] - cp[i])
    return cm


@functools.lru_cache(maxsize=64)  # one small n x n matrix per axis length, dtype and device
def _filter_matrix(n: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_filter_matrix_np(n), dtype=dtype, device=device)


def spline_filter(data, device=None) -> torch.Tensor:
    """Cubic B-spline coefficient array of ``data`` (all axes filtered,
    mirror boundaries): ``scipy.ndimage.spline_filter(order=3,
    mode='mirror')`` (bspline.py:79-88)."""
    data = config.as_input(data, device)
    for ax in range(data.ndim):
        F = _filter_matrix(data.shape[ax], data.dtype, data.device)
        data = torch.movedim(torch.movedim(data, ax, -1) @ F.T, -1, ax)
    return data


def _mirror_index(i: torch.Tensor, n: int) -> torch.Tensor:
    """Fold integer indices into [0, n) by mirror reflection about the end
    samples (period 2n-2; no edge repeat): scipy/ITK 'mirror'."""
    if n == 1:
        return torch.zeros_like(i)
    p = 2 * n - 2
    i = torch.abs(i) % p
    return torch.where(i >= n, p - i, i)


def _cubic_weights(f: torch.Tensor):
    """B-spline kernel weights for the 4 taps at offsets (-1, 0, 1, 2)
    around the base sample, f = frac(t) in [0, 1)."""
    f2 = f * f
    f3 = f2 * f
    w0 = (1.0 - 3.0 * f + 3.0 * f2 - f3) * (1.0 / 6.0)
    w1 = (4.0 - 6.0 * f2 + 3.0 * f3) * (1.0 / 6.0)
    w2 = (1.0 + 3.0 * f + 3.0 * f2 - 3.0 * f3) * (1.0 / 6.0)
    w3 = f3 * (1.0 / 6.0)
    return (w0, w1, w2, w3)


def map_coordinates_cubic(image, coords, prefilter: bool = True, device=None) -> torch.Tensor:
    """Sample ``image`` at fractional index coordinates with cubic B-spline
    interpolation, mirror boundaries (bspline.py:113-152; ``scipy.ndimage.
    map_coordinates(order=3, mode='mirror')``).

    ``coords``: sequence of nd tensors (one per image axis, any common
    shape).  ``prefilter=False`` treats ``image`` as spline coefficients
    (the output of :func:`spline_filter`)."""
    image = config.as_input(image, device)
    nd = image.ndim
    if len(coords) != nd:
        raise ValueError(f"map_coordinates_cubic: {len(coords)} coords for {nd}-d image")
    coef = spline_filter(image) if prefilter else image
    coords = [torch.as_tensor(c, dtype=coef.dtype, device=coef.device) for c in coords]

    idx, wts = [], []
    for ax in range(nd):
        t = coords[ax]
        base = torch.floor(t)
        f = t - base
        b = base.to(torch.int64)
        idx.append([_mirror_index(b + k - 1, image.shape[ax]) for k in range(4)])
        wts.append(_cubic_weights(f))

    out = torch.zeros(coords[0].shape, dtype=coef.dtype, device=coef.device)
    for taps in itertools.product(range(4), repeat=nd):
        w = wts[0][taps[0]]
        for ax in range(1, nd):
            w = w * wts[ax][taps[ax]]
        gathered = coef[tuple(idx[ax][taps[ax]] for ax in range(nd))]
        out = out + w * gathered
    return out
