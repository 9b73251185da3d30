"""Kernel construction utilities.

Mirrors gpr_tpu/kernels/utils.py:10-29 (``get_general_kernel``), the
reference's include/KernelUtils.h:43-89.
"""

from __future__ import annotations

from typing import Sequence

from .kernels import Gaussian, Kernel, Periodic, Product, RationalQuadratic, Sum, White


def get_general_kernel(params: Sequence) -> Kernel:
    """The reference's 'highly general' composite kernel

        Gauss(p1, p0) + Gauss(p3, p2) * Periodic(p4, p5, p6) + RQ(p7, p8, p9)
        + (Gauss(p11, p10) + White(p12))

    with its parameter order (GaussianKernel takes (sigma, scale), so each
    pair is swapped in the constructor, KernelUtils.h:73-84)."""
    params = list(params)
    if len(params) != 13:
        raise ValueError("Wrong number of arguments.")
    k1 = Gaussian(params[1], params[0])
    k2 = Product(Gaussian(params[3], params[2]), Periodic(params[4], params[5], params[6]))
    k3 = RationalQuadratic(params[7], params[8], params[9])
    k4 = Sum(Gaussian(params[11], params[10]), White(params[12]))
    return Sum(Sum(Sum(k1, k2), k3), k4)
