"""Image-filter helpers: the itkUtils filter families.

Mirrors gpr_tpu/pipeline/filters.py:1-371, all 22 public functions of its
table (filters.py:8-33; reference include/itkUtils.h):

==========================  ==================================================
This module                 Reference (include/itkUtils.h)
==========================  ==================================================
gaussian_smoothing          GaussianSmoothing (:918-931, DiscreteGaussian)
image_variance              ImageVariance (:933-973, G(I^2) - mean^2)
mean_filter                 itkMeanImageFilter include (:26; no wrapper fn)
image_pyramid               GetImagePyramideImage (:176-198)
image_pyramid_series        GetImagePyramideImageSeries (:285-383)
pyramid_schedule            RecursiveMultiResolutionPyramid default schedule
median_filter               MedianFilterImage (:1043-1055)
histogram_matching          HistogramMatching (:1057-1070)
threshold_below             ThresholdImage(image, threshold) (:81-91)
threshold_window            ThresholdImage(image, max, min) (:975-1041)
rescale_intensity           RescaleImage (:702-713)
shrink_image                ShrinkImage (:715-726)
invert_image                InvertImage (:728-744)
round_image                 RoundImage (:71-79)
normalize_image             itkNormalizeImageFilter include (:31)
multiply_images             MultiplyImages (:975 region)
subtract_images             SubtractImages
multiply_constant           MultiplyConstant
accumulate_image            AccumulateImage (:1072-1081)
abs_difference              itkAbsoluteValueDifferenceImageFilter include
get_target_image_from_series GetTargetImageFromImageSeries (:116-174)
shuffle_image_data          ShuffleImageData (:665-698)
==========================  ==================================================

As in JAX: images are tensors, 2-D spatial = (y, x), series = (t, y, x);
``factor_x`` refers to the first ITK dimension = the last axis; boundaries
replicate the edge (zero-flux Neumann); the Gaussian is the sampled,
truncated kernel of ``scipy.ndimage.gaussian_filter`` (its float32 taps, as
JAX takes them).  Each separable pass is one ``conv1d`` over the
edge-padded lines.  Where torch and JAX differ:

* ``normalize_image`` takes the population standard deviation
  (``correction=0``), as ``jnp.std`` does;
* ``histogram_matching`` bins with ``searchsorted`` on JAX's ``linspace``
  edges (numpy's rule: the last bin holds its right edge), since
  ``torch.histogram`` runs on the CPU only and ``torch.histc`` takes no
  edges; :func:`_interp` writes out ``jnp.interp`` (clamped outside
  [xp[0], xp[-1]], a flat step where xp repeats);
* ``median_filter`` stacks (2r+1)^d neighbours, an odd count, where
  ``torch.median`` and ``jnp.median`` agree.

The functions take the dtype of their inputs and run on the card unless
given ``device="cpu"`` or CPU tensors (utils/config.py).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import config


# ---------------------------------------------------------------------------
# separable Gaussian smoothing
# ---------------------------------------------------------------------------

def _gaussian_kernel1d(variance: float, spacing: float = 1.0,
                       max_kernel_width: int = 64) -> np.ndarray:
    """Sampled, normalized 1-D Gaussian with ITK's width cap (filters.py:
    65-75; variance in physical units, converted to pixels by ``spacing``)."""
    var_pix = float(variance) / float(spacing) ** 2
    sigma = math.sqrt(max(var_pix, 1e-12))
    radius = int(min(max(1, math.ceil(4.0 * sigma)), max_kernel_width // 2))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _convolve_along(img: torch.Tensor, kernel: np.ndarray, axis: int) -> torch.Tensor:
    """Edge-padded 'same' correlation along one axis (filters.py:78-90):
    out[n] = sum_i padded[n + i] k[i]."""
    k = torch.as_tensor(kernel, device=img.device).to(img.dtype)
    r = (k.shape[0] - 1) // 2
    moved = torch.movedim(img, axis, -1)
    lines = moved.reshape(-1, 1, moved.shape[-1])
    out = F.conv1d(F.pad(lines, (r, r), mode="replicate"), k.view(1, 1, -1))
    return torch.movedim(out.reshape(moved.shape), -1, axis)


def gaussian_smoothing(img, variance: float, spacing: Sequence[float] | None = None,
                       max_kernel_width: int = 64, axes: Sequence[int] | None = None,
                       device=None) -> torch.Tensor:
    """Separable Gaussian blur (filters.py:93-120; the reference passes its
    ``sigma`` argument as a variance, and so does this function).
    ``axes`` selects the smoothed axes (default: all); ``(1, 2)`` blurs a
    (t, y, x) series slice-wise."""
    img = config.as_input(img, device)
    if axes is None:
        axes = tuple(range(img.ndim))
    if spacing is None:
        spacing = [1.0] * len(axes)
    if len(spacing) != len(axes):
        raise ValueError(
            f"gaussian_smoothing: {len(spacing)} spacing values for "
            f"{len(axes)} axes (zip would silently skip trailing axes)"
        )
    out = img
    for ax, sp in zip(axes, spacing):
        out = _convolve_along(out, _gaussian_kernel1d(variance, sp, max_kernel_width), ax)
    return out


def mean_filter(img, radius: int, axes: Sequence[int] | None = None, device=None) -> torch.Tensor:
    """Box mean of half-width ``radius``, separable, edge-replicated
    (filters.py:123-136)."""
    img = config.as_input(img, device)
    if radius <= 0:
        return img
    k = np.full((2 * radius + 1,), 1.0 / (2 * radius + 1), np.float64)
    if axes is None:
        axes = tuple(range(img.ndim))
    out = img
    for ax in axes:
        out = _convolve_along(out, k, ax)
    return out


def image_variance(img, variance: float, mean, device=None, **smooth_kwargs) -> torch.Tensor:
    """Local variance estimate G(I^2) - mean^2 (filters.py:139-143)."""
    img = config.as_input(img, device)
    mean = config.as_input(mean, img.device)
    return gaussian_smoothing(img**2, variance, **smooth_kwargs) - mean**2


# ---------------------------------------------------------------------------
# multi-resolution pyramids
# ---------------------------------------------------------------------------

def pyramid_schedule(num_scales: int) -> List[int]:
    """Per-level shrink factors, coarsest first: [2^(s-1), ..., 2, 1]."""
    return [2 ** (num_scales - 1 - i) for i in range(num_scales)]


def _downsample2(img: torch.Tensor, axes: Tuple[int, ...]) -> torch.Tensor:
    """Smooth at variance 1, then every second sample along ``axes``."""
    out = gaussian_smoothing(img, 1.0, axes=axes)
    for ax in axes:
        idx = [slice(None)] * out.ndim
        idx[ax] = slice(0, None, 2)
        out = out[tuple(idx)]
    return out


def image_pyramid(img, num_scales: int, device=None) -> List[torch.Tensor]:
    """Recursive multi-resolution pyramid of one image, coarsest level first
    (filters.py:167-177)."""
    img = config.as_input(img, device)
    levels = [img]
    for _ in range(num_scales - 1):
        levels.append(_downsample2(levels[-1], tuple(range(img.ndim))))
    return levels[::-1]


def image_pyramid_series(series, num_scales: int, device=None) -> List[torch.Tensor]:
    """Slice-wise 2-D pyramid of a (t, y, x) series, coarsest first; the time
    extent is kept at every level (filters.py:180-189)."""
    series = config.as_input(series, device)
    levels = [series]
    for _ in range(num_scales - 1):
        levels.append(_downsample2(levels[-1], (1, 2)))
    return levels[::-1]


def get_target_image_from_series(series, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The slice whose mean is closest to the series' mean, tiled across time
    (filters.py:192-201).  Returns (tiled_series, index)."""
    series = config.as_input(series, device)
    t = series.shape[0]
    means = torch.mean(series.reshape(t, -1), dim=1)
    overall = torch.mean(means)
    idx = torch.argmin(torch.abs(means - overall))
    return series[idx][None].expand(series.shape), idx


def shuffle_image_data(series, index: Sequence[int], device=None) -> torch.Tensor:
    """Scatter time slices: out[index[z]] = series[z] (filters.py:204-209)."""
    series = config.as_input(series, device)
    out = torch.zeros_like(series)
    out[torch.as_tensor(list(index), device=series.device)] = series
    return out


# ---------------------------------------------------------------------------
# rank / histogram filters
# ---------------------------------------------------------------------------

def _pad_edge(img: torch.Tensor, r: int) -> torch.Tensor:
    """Replicate the edges by r samples on every axis."""
    for ax, n in enumerate(img.shape):
        idx = torch.clamp(torch.arange(-r, n + r, device=img.device), 0, n - 1)
        img = torch.index_select(img, ax, idx)
    return img


def median_filter(img, radius: int, device=None) -> torch.Tensor:
    """Box median of half-width ``radius`` over all axes, edge-replicated
    (filters.py:216-232; radius <= 0 returns the input)."""
    img = config.as_input(img, device)
    if radius <= 0:
        return img
    padded = _pad_edge(img, radius)
    shape = img.shape
    stack = []
    for offs in np.ndindex(*([2 * radius + 1] * img.ndim)):
        idx = tuple(slice(o, o + s) for o, s in zip(offs, shape))
        stack.append(padded[idx])
    return torch.median(torch.stack(stack, dim=0), dim=0).values


def _linspace(start: torch.Tensor, stop: torch.Tensor, num: int) -> torch.Tensor:
    """``jnp.linspace`` (endpoint included): start (1 - s) + stop s with
    s = i / (num - 1), then stop itself."""
    div = num - 1
    s = torch.arange(div, dtype=start.dtype, device=start.device) / div
    return torch.cat([start * (1 - s) + stop * s, stop.reshape(1)])


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)``: fp[0] left of xp[0], fp[-1] right of
    xp[-1], and fp[i-1] where an interval is shorter than the spacing of
    eps (repeated xp)."""
    dt = torch.promote_types(x.dtype, xp.dtype)
    x, xp = x.to(dt), xp.to(dt)
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = torch.abs(dx) <= float(np.spacing(torch.finfo(dt).eps))
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + (delta / torch.where(dx0, torch.ones_like(dx), dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def histogram_matching(img, reference, levels: int = 1024, match_points: int = 7,
                       device=None) -> torch.Tensor:
    """Map the intensity distribution of ``img`` onto ``reference``
    (filters.py:235-275, reference HistogramMatchingImageFilter with
    ThresholdAtMeanIntensityOff): quantiles at ``match_points + 2``
    equispaced fractions from ``levels``-bin histograms, then the
    piecewise-linear map source quantile -> reference quantile."""
    img = config.as_input(img, device)
    reference = config.as_input(reference, img.device)
    dt = img.dtype
    fracs = _linspace(torch.zeros((), dtype=dt, device=img.device),
                      torch.ones((), dtype=dt, device=img.device), match_points + 2)

    def _quantiles(x):
        lo, hi = torch.min(x), torch.max(x)
        edges = _linspace(lo, hi, levels + 1)
        flat = x.reshape(-1)
        bin_idx = torch.searchsorted(edges, flat, right=True)
        bin_idx = torch.where(flat == edges[-1], levels, bin_idx)  # the last bin holds its edge
        counts = torch.bincount(bin_idx, minlength=levels + 2)[1:levels + 1]
        cum = torch.cumsum(counts, 0)
        cdf = cum.to(x.dtype) / cum[-1].to(x.dtype)
        centers = 0.5 * (edges[:-1] + edges[1:])
        xp = torch.cat([torch.zeros(1, dtype=cdf.dtype, device=x.device), cdf])
        fp = torch.cat([lo[None], centers])
        return _interp(fracs, xp, fp)

    src_q = _quantiles(img)
    ref_q = _quantiles(reference)
    # monotone nodes (a flat histogram gives ties)
    src_q = torch.cummax(src_q, 0).values
    out = _interp(img.reshape(-1), src_q, ref_q)
    return out.reshape(img.shape).to(img.dtype)


# ---------------------------------------------------------------------------
# pointwise / intensity filters
# ---------------------------------------------------------------------------

def threshold_below(img, threshold, device=None) -> torch.Tensor:
    """Zero out values below ``threshold`` (filters.py:278-282)."""
    img = config.as_input(img, device)
    return torch.where(img < threshold, torch.zeros((), dtype=img.dtype, device=img.device), img)


def threshold_window(img, thresh_max, thresh_min, device=None) -> torch.Tensor:
    """Clamp to the data-derived window [min value above ``thresh_min``, max
    value below ``thresh_max``] (filters.py:285-302); an empty side falls back
    to the image's extremum."""
    img = config.as_input(img, device)
    inf = torch.full((), math.inf, dtype=img.dtype, device=img.device)
    max_below = torch.max(torch.where(img < thresh_max, img, -inf))
    min_above = torch.min(torch.where(img > thresh_min, img, inf))
    max_below = torch.where(torch.isfinite(max_below), max_below, torch.max(img))
    min_above = torch.where(torch.isfinite(min_above), min_above, torch.min(img))
    return torch.clamp(img, torch.minimum(min_above, max_below), max_below)


def rescale_intensity(img, out_min, out_max, device=None) -> torch.Tensor:
    """Affine map of [min, max] onto [out_min, out_max] (filters.py:305-311)."""
    img = config.as_input(img, device)
    lo, hi = torch.min(img), torch.max(img)
    scale = (out_max - out_min) / torch.clamp(hi - lo, min=torch.finfo(img.dtype).tiny)
    return (img - lo) * scale + out_min


def shrink_image(img, factor_x: int, factor_y: int, device=None) -> torch.Tensor:
    """Integer decimation without smoothing at ITK's offset (factor-1)//2
    (filters.py:314-321); ``factor_x`` is the last axis."""
    img = config.as_input(img, device)
    oy, ox = (factor_y - 1) // 2, (factor_x - 1) // 2
    return img[..., oy::factor_y, ox::factor_x]


def invert_image(img, device=None) -> torch.Tensor:
    """max(img) - img (filters.py:324-328)."""
    img = config.as_input(img, device)
    return torch.max(img) - img


def round_image(img, device=None) -> torch.Tensor:
    """Round to nearest, halfway cases to even as ``jnp.round`` (filters.py:
    331-335)."""
    return torch.round(config.as_input(img, device))


def normalize_image(img, device=None) -> torch.Tensor:
    """Zero mean, unit population standard deviation (filters.py:338-344)."""
    img = config.as_input(img, device)
    mu = torch.mean(img)
    sd = torch.std(img, correction=0)
    return (img - mu) / torch.clamp(sd, min=torch.finfo(img.dtype).tiny)


def multiply_images(a, b, device=None) -> torch.Tensor:
    """Reference ``MultiplyImages`` (filters.py:347-349)."""
    a = config.as_input(a, device)
    return a * config.as_input(b, a.device)


def subtract_images(a, b, device=None) -> torch.Tensor:
    """Reference ``SubtractImages`` (filters.py:352-354)."""
    a = config.as_input(a, device)
    return a - config.as_input(b, a.device)


def multiply_constant(img, constant, device=None) -> torch.Tensor:
    """Reference ``MultiplyConstant`` (filters.py:357-359)."""
    return config.as_input(img, device) * constant


def abs_difference(a, b, device=None) -> torch.Tensor:
    """|a - b| (filters.py:362-365)."""
    a = config.as_input(a, device)
    return torch.abs(a - config.as_input(b, a.device))


def accumulate_image(img, device=None) -> torch.Tensor:
    """Sum of all pixels (filters.py:368-371)."""
    return torch.sum(config.as_input(img, device))
