"""Tiled Gram matrix of the stationary kernel forms (kernels K1 and K6).

Mirrors gpr_tpu/ops/pallas_gram.py:28-321 (``_tile_body``, ``gram_pallas``
and the fleet's ``gram_pallas_batched``).  :func:`gram` (K1) and
:func:`gram_batched` (K6) launch the hand-written CUDA kernels of
``csrc/gram.cu`` for a CUDA tensor and run :func:`gram_reference` /
:func:`gram_batched_reference`, the same tile math in torch ops, for a CPU
tensor.

K[i, j] = scale^2 f(d2) + diag [i == j] with d2 = |x|^2 + |y|^2 - 2 x.y
clamped at 0 (periodic: sum_k sin^2(b (x_k - y_k)); sqdist: d2 itself).  The
output is float32, as on the TPU.  ``tril=True`` (square case) computes the
lower triangle only: the strict upper triangle of the kernel's output is
undefined, valid for consumers that read the lower triangle (potrf 'L').
"""

from __future__ import annotations

import math

import torch

from . import _cuda

# Index = the form code of csrc/gram_tile.cuh.
FORMS = ("gaussian", "rq", "matern12", "matern32", "matern52", "periodic", "sqdist")


def form_value(form: str, d2: torch.Tensor, sigma, scale, third) -> torch.Tensor:
    """The kernel-function epilogue applied to squared distances (for
    periodic: to the sin^2 sum), as in pallas_gram.py:91-111."""
    s2 = scale * scale
    if form in ("gaussian", "periodic"):
        return s2 * torch.exp(-0.5 * d2 / (sigma * sigma))
    if form == "rq":
        return s2 * (1.0 + 0.5 * d2 / (sigma * sigma * third)) ** (-third)
    if form == "matern12":
        return s2 * torch.exp(-torch.sqrt(d2) / sigma)
    if form == "matern32":
        a = math.sqrt(3.0) * torch.sqrt(d2) / sigma
        return s2 * (1.0 + a) * torch.exp(-a)
    if form == "matern52":
        a = math.sqrt(5.0) * torch.sqrt(d2) / sigma
        return s2 * (1.0 + a + a * a / 3.0) * torch.exp(-a)
    if form == "sqdist":
        return d2
    raise ValueError(f"gram: unknown form {form!r}")


def gram_reference(X, Y, sigma=1.0, scale=1.0, third=1.0, diag=0.0, *,
                   form: str = "gaussian", tril: bool = False) -> torch.Tensor:
    """Plain torch version of kernel K1 (float32 in and out).  With
    ``tril`` it returns the full matrix, a valid value for an output whose
    strict upper triangle is undefined."""
    _check(X, Y, form, tril)
    x, y = X, Y
    if form == "periodic":
        s = torch.sin(third * (x[:, None, :] - y[None, :, :]))
        d2 = (s * s).sum(-1)
    else:
        xx = (x * x).sum(1)
        yy = (y * y).sum(1)
        d2 = torch.clamp(xx[:, None] + yy[None, :] - 2.0 * (x @ y.T), min=0.0)
    val = form_value(form, d2, sigma, scale, third)
    n, m = val.shape
    eye = torch.arange(n, device=X.device)[:, None] == torch.arange(m, device=X.device)[None, :]
    return val + torch.where(eye, diag, 0.0)


def gram(X, Y, sigma=1.0, scale=1.0, third=1.0, diag=0.0, *,
         form: str = "gaussian", tril: bool = False) -> torch.Tensor:
    """K(X, Y) for one of :data:`FORMS` (``third`` is rq's alpha or
    periodic's b).  X (n, d), Y (m, d) contiguous float32, on one device.
    A CUDA tensor runs kernel K1 (gaussian, rq, matern32, matern52 and sqdist
    at d % 4 == 0, d >= 32 with the cross term in 3xTF32 on the tensor cores,
    the port's f32-grade tier; the rest in FP32); a CPU tensor runs
    :func:`gram_reference`."""
    _check(X, Y, form, tril)
    if X.device.type == "cpu":
        return gram_reference(X, Y, sigma, scale, third, diag, form=form, tril=tril)
    if X.device.type != "cuda":
        raise ValueError(f"gram: unsupported device {X.device}")
    n, d = X.shape
    m = Y.shape[0]
    K = torch.empty((n, m), dtype=torch.float32, device=X.device)
    _cuda.GRAM.launch(
        X.device, X.data_ptr(), Y.data_ptr(), K.data_ptr(), n, m, d, FORMS.index(form),
        float(sigma), float(scale), float(third), float(diag), int(tril),
    )
    return K


def _check(X, Y, form, tril):
    if form not in FORMS:
        raise ValueError(f"gram: unknown form {form!r}")
    if X.ndim != 2 or Y.ndim != 2 or X.shape[1] != Y.shape[1]:
        raise ValueError(f"gram: shapes {tuple(X.shape)} and {tuple(Y.shape)} must be (n, d), (m, d)")
    if X.shape[0] == 0 or Y.shape[0] == 0 or X.shape[1] == 0:
        raise ValueError("gram: empty input")
    if X.device != Y.device:
        raise ValueError("gram: X and Y must be on one device")
    for t in (X, Y):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("gram: X and Y must be contiguous float32")
    if tril and X.shape[0] != Y.shape[0]:
        raise ValueError("gram: tril requires the symmetric square case")


def gram_batched_reference(X, params, *, form: str = "gaussian") -> torch.Tensor:
    """Plain torch version of kernel K6: K[b] = k(X[b], X[b]) + diag[b] I
    with member b's (sigma, scale, third, diag) = params[b]."""
    _check_batched(X, params, form)
    sigma, scale, third, diag = (params[:, i, None, None] for i in range(4))
    if form == "periodic":
        s = torch.sin(third[..., None] * (X[:, :, None, :] - X[:, None, :, :]))
        d2 = (s * s).sum(-1)
    else:
        xx = (X * X).sum(-1)
        d2 = torch.clamp(xx[:, :, None] + xx[:, None, :] - 2.0 * (X @ X.mT), min=0.0)
    val = form_value(form, d2, sigma, scale, third)
    n = X.shape[1]
    eye = torch.eye(n, dtype=torch.bool, device=X.device)
    return val + torch.where(eye, diag, 0.0)


def gram_batched(X, params, *, form: str = "gaussian") -> torch.Tensor:
    """The fleet Gram (B, n, n), full square, float32: K[b] = k(X[b], X[b])
    + diag[b] I for one of :data:`FORMS`.  X (B, n, d) and params (B, 4) =
    per-member (sigma, scale, third, diag) are contiguous float32 on one
    device, so per-member hyperparameters cost no extra launch.  A CUDA
    tensor runs kernel K6; a CPU tensor runs :func:`gram_batched_reference`."""
    _check_batched(X, params, form)
    if X.device.type == "cpu":
        return gram_batched_reference(X, params, form=form)
    B, n, d = X.shape
    K = torch.empty((B, n, n), dtype=torch.float32, device=X.device)
    _cuda.GRAM_BATCHED.launch(X.device, X.data_ptr(), params.data_ptr(), K.data_ptr(), B, n, d,
                              FORMS.index(form))
    return K


def _check_batched(X, params, form):
    if form not in FORMS:
        raise ValueError(f"gram_batched: unknown form {form!r}")
    if X.ndim != 3 or params.shape != (X.shape[0], 4):
        raise ValueError(f"gram_batched: shapes {tuple(X.shape)} and {tuple(params.shape)} "
                         "must be (B, n, d) and (B, 4)")
    if X.numel() == 0:
        raise ValueError("gram_batched: empty input")
    if X.device != params.device or X.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gram_batched: X and params must be on one CPU or CUDA device, "
                         f"got {X.device} and {params.device}")
    for t in (X, params):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("gram_batched: X and params must be contiguous float32")
