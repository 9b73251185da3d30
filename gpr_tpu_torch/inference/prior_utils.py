"""Equidistant inverse-transform sampling of priors for brute-force MAP grids.

Mirrors gpr_tpu/inference/prior_utils.py (whole file), the reference's
GetSamples (include/PriorUtils.h:33-58).
"""

from __future__ import annotations

from typing import List

import numpy as np


def get_samples(density, num_points: int) -> List[float]:
    """The mode, then the icdf at u = k / num_points (k = 0..num_points) where
    it lies within mode +/- sqrt(variance): the list always starts with the
    mode and may hold more or fewer than num_points values."""
    mode = float(density.mode())
    std = float(np.sqrt(float(density.variance())))
    x_start = max(np.finfo(np.float64).eps, mode - std)
    x_end = mode + std

    out = [mode]
    if num_points == 0:
        return out
    for k in range(num_points + 1):
        d = float(density.icdf(k / num_points))
        if x_start <= d <= x_end:
            out.append(d)
    return out
