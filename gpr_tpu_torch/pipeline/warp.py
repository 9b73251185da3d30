"""Image warping by dense displacement fields.

Mirrors gpr_tpu/pipeline/warp.py:1-92 (``warp_array``, ``warp_image``,
``displacement_magnitude``, ``diff_image``), which replaces the reference's
ITK warping stack (reference include/itkUtils.h:1098-1158): the warped value
at voxel x is image(x + d(x) / spacing).  Order 3, the reference's default
interpolator, goes through :mod:`.bspline`.

Orders 0 and 1 go through :func:`map_coordinates`, this module's copy of
``jax.scipy.ndimage.map_coordinates`` (warp.py:58): the same five modes with
JAX's index fixers, JAX's rounding half away from zero at order 0 (not
``torch.round``'s half to even), and its sum order.  JAX's 'wrap' and
'constant' are scipy's 'grid-wrap' and 'grid-constant'.

One fault of the JAX module is not copied: its ``warp_array`` ignores
``mode`` at order 3 (warp.py:54-58).  Here ``mode=None`` means 'nearest' at
orders 0-1 and the spline's mirror at order 3, and any other mode at order 3
raises ``ValueError``.

The functions take the dtype of their inputs and run on the card unless
given ``device="cpu"`` or CPU tensors (utils/config.py).
"""

from __future__ import annotations

import functools
import itertools
import operator

import numpy as np
import torch

from ..utils import config
from . import imageio


def _mirror_fixer(index: torch.Tensor, size: int) -> torch.Tensor:
    if size == 1:
        return torch.zeros_like(index)  # JAX's gather clamps every index to 0
    s = size - 1  # half-wavelength of the triangular wave
    return torch.abs(torch.remainder(index + s, 2 * s) - s)


def _reflect_fixer(index: torch.Tensor, size: int) -> torch.Tensor:
    return torch.div(_mirror_fixer(2 * index + 1, 2 * size + 1) - 1, 2, rounding_mode="floor")


_INDEX_FIXERS = {
    "constant": lambda index, size: index,
    "nearest": lambda index, size: torch.clamp(index, 0, size - 1),
    "wrap": lambda index, size: torch.remainder(index, size),
    "mirror": _mirror_fixer,
    "reflect": _reflect_fixer,
}


def _round_half_away_from_zero(a: torch.Tensor) -> torch.Tensor:
    """``lax.round``: exact, since a - trunc(a) is exact in floating point."""
    t = torch.trunc(a)
    return t + torch.where(torch.abs(a - t) >= 0.5, torch.sign(a), torch.zeros_like(a))


def map_coordinates(image, coords, order: int, mode: str = "constant", device=None) -> torch.Tensor:
    """``jax.scipy.ndimage.map_coordinates`` at order 0 (nearest) or 1
    (linear) with its modes 'constant' (0 outside), 'nearest', 'wrap',
    'mirror' and 'reflect'."""
    image = config.as_input(image, device)
    coords = [torch.as_tensor(c, device=image.device) for c in coords]
    if len(coords) != image.ndim:
        raise ValueError("coordinates must be a sequence of length input.ndim, but "
                         f"{len(coords)} != {image.ndim}")
    fixer = _INDEX_FIXERS.get(mode)
    if fixer is None:
        raise NotImplementedError(f"map_coordinates does not support mode {mode}; the modes are "
                                  f"{set(_INDEX_FIXERS)}")
    if order not in (0, 1):
        raise NotImplementedError("map_coordinates requires order <= 1")

    nodes_1d = []
    for c, size in zip(coords, image.shape):
        if order == 0:
            nodes = [(_round_half_away_from_zero(c).to(torch.int64), 1.0)]
        else:
            lower = torch.floor(c)
            upper_weight = c - lower
            index = lower.to(torch.int64)
            nodes = [(index, 1 - upper_weight), (index + 1, upper_weight)]
        fixed = []
        for index, weight in nodes:
            valid = (index >= 0) & (index < size) if mode == "constant" else None
            fixed.append((torch.clamp(fixer(index, size), 0, size - 1), valid, weight))
        nodes_1d.append(fixed)

    zero = torch.zeros((), dtype=image.dtype, device=image.device)
    outputs = []
    for items in itertools.product(*nodes_1d):
        indices, validities, weights = zip(*items)
        contribution = image[indices]
        if mode == "constant":
            contribution = torch.where(functools.reduce(operator.and_, validities), contribution, zero)
        outputs.append(functools.reduce(operator.mul, weights) * contribution)
    result = sum(outputs[1:], outputs[0])
    if not image.dtype.is_floating_point:
        result = _round_half_away_from_zero(result)
    return result.to(image.dtype)


def warp_array(image, displacement, spacing=None, order: int = 1, mode=None,
               device=None) -> torch.Tensor:
    """Warp ``image`` [z, y, x] by ``displacement`` [z, y, x, 3]
    (warp.py:27-58).

    The displacement is in physical units with components ordered (dx, dy,
    dz), x fastest like the reference's DVFs, and is divided by the voxel
    spacing (sx, sy, sz) to get index offsets.  order=1 linear, order=0
    nearest, order=3 cubic B-spline with mirror boundaries.  ``mode=None``
    is 'nearest' at orders 0-1 and mirror at order 3; at order 3 any mode
    but 'mirror' raises ``ValueError``."""
    image = config.as_input(image, device)
    displacement = config.as_input(displacement, image.device)
    nd = image.ndim
    if order == 3 and mode not in (None, "mirror"):
        raise ValueError(f"warp_array: order 3 is the cubic B-spline with mirror boundaries; "
                         f"mode {mode!r} is not supported there")
    if spacing is None:
        spacing = (1.0,) * nd
    grid = torch.meshgrid(*[torch.arange(s, dtype=image.dtype, device=image.device)
                            for s in image.shape], indexing="ij")  # [z, y, x] index grids
    # displacement component c maps to axis (nd-1-c): dx -> x (last axis)
    coords = [grid[ax] + displacement[..., nd - 1 - ax] / spacing[nd - 1 - ax] for ax in range(nd)]
    if order == 3:
        from .bspline import map_coordinates_cubic

        return map_coordinates_cubic(image, coords)
    return map_coordinates(image, coords, order=order, mode="nearest" if mode is None else mode)


def warp_image(img: imageio.Image, df: imageio.Image, order: int = 3, device=None) -> imageio.Image:
    """Warp a scalar Image by a displacement-field Image (warp.py:61-78,
    reference WarpImage, itkUtils.h:1098-1114: the output geometry follows
    the field).  Computed in float64, as JAX does."""
    if df.ncomponents < 2:
        raise ValueError("warp_image: displacement field must be vector-valued")
    device = config.resolve_device(device)
    warped = warp_array(
        torch.as_tensor(np.asarray(img.data), dtype=torch.float64, device=device),
        torch.as_tensor(np.asarray(df.data), dtype=torch.float64, device=device),
        spacing=df.spacing,
        order=order,
    )
    return imageio.Image(warped.cpu().numpy(), df.spacing, df.origin, ncomponents=1)


def displacement_magnitude(df: imageio.Image) -> np.ndarray:
    """Per-voxel L2 magnitude (warp.py:81-83, reference itkUtils.h:1172-1180)."""
    return np.linalg.norm(np.asarray(df.data), axis=-1)


def diff_image(gt: imageio.Image, pred: imageio.Image) -> imageio.Image:
    """Per-voxel displacement difference field (warp.py:86-92, the
    reference's evaluation artifact, scripts/main.py:366-377)."""
    data = np.asarray(gt.data) - np.asarray(pred.data)
    return imageio.Image(data, gt.spacing, gt.origin, ncomponents=gt.ncomponents)
