"""FFT-based period-length estimation for periodic-kernel initialization.

Mirrors gpr_tpu/inference/period.py:23-64, the reference's
``GetLocalPeriodLength`` (include/LikelihoodUtils.h:31-75): the periodic
kernel's likelihood is multimodal in the period, so the period is seeded
from the dominant frequency of the signal.

Single-sided amplitude spectrum 2 |F_k| / N with the first ``omit`` bins
ignored, period = N / argmax, and sinus-likeness = amp_integral /
(amp_integral - amp_max) - 1, the dtype's largest value where one bin holds
all the amplitude.  A tensor stays on its device; other input goes to
``device`` (utils/config.py).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..utils import config


def get_local_period_length(vec, omit: int = 1,
                            device=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(period_length, dominant_amplitude, sinus_likeness) of a 1-D signal
    (LikelihoodUtils.h:44-74)."""
    vec = torch.ravel(config.as_input(vec, device))
    if not vec.is_floating_point():
        vec = vec.to(torch.float64)
    n = vec.shape[0]
    if n < 4 + omit:
        raise ValueError(
            "GetLocalPeriodLength: longer signal required. "
            "Check if a column vector is provided!"
        )
    F = torch.fft.rfft(vec)
    half = n // 2
    amps = 2.0 * torch.abs(F[:half]) / n
    # the omitted leading bins (DC and slow drift) are masked out
    keep = torch.arange(half, device=vec.device) >= omit
    masked = torch.where(keep, amps, -torch.inf)
    max_index = torch.argmax(masked)
    amp_max = masked[max_index]
    amp_integral = torch.where(keep, amps, 0.0).sum()

    period_length = n / max_index.to(vec.dtype)
    denom = amp_integral - amp_max
    finfo = torch.finfo(vec.dtype)
    sinus_likeness = torch.where(
        denom < finfo.tiny,
        torch.tensor(finfo.max, dtype=vec.dtype, device=vec.device),
        amp_integral / torch.clamp(denom, min=finfo.tiny) - 1.0,
    )
    return period_length, amp_max, sinus_likeness


def periodic_b_from_period(period_length, dtype=None) -> torch.Tensor:
    """The Periodic kernel's ``b`` for a period in sample units: b = pi /
    period (the reference's PeriodicKernel uses sin(b * delta),
    Kernel.h:902-1036)."""
    if dtype is None and not isinstance(period_length, torch.Tensor):
        dtype = torch.float64  # a Python number, as JAX takes it under x64
    period = torch.as_tensor(period_length, dtype=dtype)
    return torch.as_tensor(math.pi, dtype=period.dtype, device=period.device) / period
