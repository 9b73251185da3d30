"""Plain reference of exact GP regression: the fit and the MLE training.

Everything the benchmark compares is worked out again here from the seeded
inputs, with nothing of the measured package imported: the Gram matrix by
one product (|x|^2 + |y|^2 - 2 x.y), ``torch.linalg.cholesky``,
``torch.cholesky_solve``, the log marginal likelihood with its gradient by
autograd, and Adam written out.  It runs in float64 with TF32 off; the
control runs the same code in float32 with TF32 on (``precision="tf32"``),
the lower precision that a float32 program must not fall to.  Under
``"tf32"`` the Gram product's operands are also rounded to TF32 (10-bit
mantissa, to nearest even) by hand, which is what the tensor cores do to
them and which the CPU, where the TF32 switch does nothing, then does too.

Kernels, as the configuration names them (k(x, x) = scale^2):

  ``gaussian``  scale^2 exp(-0.5 |x - y|^2 / lengthscale^2)
"""

from __future__ import annotations

import contextlib
import math

import torch

PRECISIONS = {"float64": (torch.float64, False), "float32": (torch.float32, False),
              "tf32": (torch.float32, True)}

ROW_BLOCK = 4096  # rows of the Gram matrix made at once

# The objective is the reference library's: it takes the determinant in
# long double, which holds exp(+-11356.52) at most (include/Likelihood.h:
# 180-188), so log|K + sigma^2 I| is clamped to that range, and past it the
# complexity term is constant.  At n = 3773 with a smooth trace the
# log-determinant is below -11356.52, and the clamp is what is optimized.
LDBL_LOG_MAX = 11356.523406294143


@contextlib.contextmanager
def precision(name: str):
    """Yield the dtype of ``name`` with PyTorch's TF32 switches set for it,
    and restore the switches on exit."""
    dtype, tf32 = PRECISIONS[name]
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield dtype
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10-bit mantissa, to nearest even."""
    i = x.contiguous().view(torch.int32).to(torch.int64)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.to(torch.int32).view(torch.float32)


def gram(form: str, X: torch.Tensor, lengthscale, scale, precision: str = "float64") -> torch.Tensor:
    """K(X, X) for the kernel ``form``; ``lengthscale`` and ``scale`` are
    0-dim tensors (they may carry a graph) or numbers."""
    if form != "gaussian":
        raise ValueError(f"reference kernel {form!r} is not written")
    xx = (X * X).sum(1)
    Xp = round_tf32(X) if precision == "tf32" else X
    rows = []
    for i in range(0, X.shape[0], ROW_BLOCK):
        Xi = Xp[i:i + ROW_BLOCK]
        d2 = (xx[i:i + ROW_BLOCK, None] + xx[None, :] - 2.0 * (Xi @ Xp.T)).clamp_(min=0.0)
        rows.append(d2)
    d2 = torch.cat(rows)
    return scale ** 2 * torch.exp(-0.5 * d2 / lengthscale ** 2)


def factor(form: str, X, lengthscale, scale, sigma: float, precision: str = "float64") -> torch.Tensor:
    """The lower Cholesky factor of K(X, X) + sigma^2 I."""
    K = gram(form, X, lengthscale, scale, precision)
    K.diagonal().add_(sigma ** 2)
    return torch.linalg.cholesky(K)


def fit(form: str, X, Y, lengthscale, scale, sigma: float, precision: str = "float64"):
    """(alpha, diag): (K + sigma^2 I)^-1 Y and the diagonal of the factor of
    K + sigma^2 I, whose logs summed twice are log|K + sigma^2 I|."""
    L = factor(form, X, lengthscale, scale, sigma, precision)
    return torch.cholesky_solve(Y, L), L.diagonal().clone()


def mll(form: str, X, Y, lengthscale, scale, sigma: float, precision: str = "float64") -> torch.Tensor:
    """Log marginal likelihood summed over the outputs:
    -0.5 sum(Y * alpha) - 0.5 log|K + sigma^2 I| - n/2 log(2 pi), the
    log-determinant clamped to +-``LDBL_LOG_MAX``."""
    L = factor(form, X, lengthscale, scale, sigma, precision)
    alpha = torch.cholesky_solve(Y, L)
    n = X.shape[0]
    logdet = torch.clamp(2.0 * torch.log(L.diagonal()).sum(), -LDBL_LOG_MAX, LDBL_LOG_MAX)
    return -0.5 * (Y * alpha).sum() - 0.5 * logdet - 0.5 * n * math.log(2.0 * math.pi)


def adam_mle(form: str, X, Y, params0, sigma: float, iterations: int, lr: float,
             precision: str = "float64"):
    """MLE of the kernel's (lengthscale, scale) by Adam over their logs, as
    ``torch.optim.Adam`` with its defaults steps (b1 0.9, b2 0.999, eps 1e-8
    outside the square root, bias correction) on minus the objective; a
    non-finite gradient entry steps by 0.  Returns (trace, final, params,
    grad): the objective at the start of each step, at the returned
    parameters, the parameters (float64), and the gradient that the first
    step was given (of minus the objective, in the logs)."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    x = torch.log(torch.as_tensor(params0, dtype=torch.float64, device=X.device))
    m = torch.zeros_like(x)
    v = torch.zeros_like(x)
    trace, first = [], None
    for t in range(1, iterations + 1):
        xg = x.clone().requires_grad_()
        p = torch.exp(xg)
        value = mll(form, X, Y, p[0], p[1], sigma, precision)
        (g,) = torch.autograd.grad(value, xg)
        trace.append(float(value.detach()))
        g = torch.where(torch.isfinite(g), -g, torch.zeros_like(g))
        first = g if first is None else first
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mhat = m / (1 - b1 ** t)
        vhat = v / (1 - b2 ** t)
        x = x - lr * mhat / (vhat.sqrt() + eps)
    p = torch.exp(x)
    with torch.no_grad():
        final = float(mll(form, X, Y, p[0], p[1], sigma, precision))
    return trace, final, p, first
