"""Composable GP kernels as ``torch.nn.Module``s.

Mirrors gpr_tpu/kernels/kernels.py:43-62, 76-812 and 532-576.  A kernel's
hyperparameters are float64 0-dim buffers, in the reference's order
(``params``); Gram matrices are computed in the dtype of the inputs, through
the same GEMM forms as the JAX package: the squared-distance identity
|x-y|^2 = |x|^2 + |y|^2 - 2 x.y for the isotropic kernels, and two
cos/sin GEMMs for Periodic.  ``to_string`` gives the reference's kernel
string byte for byte, so model files load in both packages.

Hyperparameters carry gradients: ``with_params`` keeps a tensor that is
part of an autograd graph (or a ``torch.func`` transform) attached, so the
marginal likelihood is differentiated with respect to ``params_vector``.
A 0-dim float64 hyperparameter does not promote a float32 Gram: the
products below keep the dtype of X.  ``analytic_derivative`` holds the
reference's hand-derived forms (golden checks for the tests).

Fleets (gp/batched.py): a kernel's leaves may carry a leading batch axis
(B,), as in ``Gaussian(torch.full((B,), 1.2), torch.ones(B))``;
:func:`fleet_map` evaluates one member per slice of that axis under
``torch.func.vmap``, where each member's leaves are 0-dim again.
Validation checks every member.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
from torch import nn


def _as_2d(X) -> torch.Tensor:
    X = torch.as_tensor(X)
    return X[:, None] if X.ndim == 1 else X


def _is_fleet_member(v) -> bool:
    # a torch.func transform's wrapped tensor: one member's view of a leaf
    return isinstance(v, torch.Tensor) and torch._C._functorch.is_functorch_wrapped_tensor(v)


def _hyper(v) -> torch.Tensor:
    """A float64 hyperparameter.  A tensor that carries a graph keeps it;
    anything else is copied, so that the kernel owns its values."""
    if isinstance(v, torch.Tensor) and (v.requires_grad or _is_fleet_member(v)):
        return v.to(torch.float64)
    return torch.as_tensor(v, dtype=torch.float64).detach().clone()


def sqdist(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Pairwise squared Euclidean distances through one GEMM."""
    xx = (X * X).sum(-1)
    yy = (Y * Y).sum(-1)
    d2 = xx[:, None] + yy[None, :] - 2.0 * (X @ Y.T)
    return torch.clamp(d2, min=0.0)


def _fmt(v) -> str:
    """Scalar -> string as the reference's P2S (include/Kernel.h:127-132)."""
    return format(float(v), ".17g")


class Kernel(nn.Module):
    """Base kernel: ``k(x, y)`` evaluates one pair (or row-wise pairs of two
    (m, d) batches); :func:`gram` builds covariance matrices."""

    _names: Tuple[str, ...] = ()

    def __init__(self, *values):
        super().__init__()
        if len(values) != len(self._names):
            raise TypeError(f"{type(self).__name__} takes {len(self._names)} hyperparameters "
                            f"{self._names}, got {len(values)}")
        for name, v in zip(self._names, values):
            self.register_buffer(name, _hyper(v))

    def forward(self, x, y):
        x = torch.atleast_1d(torch.as_tensor(x))
        y = torch.atleast_1d(torch.as_tensor(y))
        # a single pair reduces to 0-dim, where the float64 hyperparameters
        # would promote: keep the inputs' dtype
        return self._eval(x, y).to(torch.result_type(x, y))

    def _eval(self, x, y):  # pragma: no cover - abstract
        raise NotImplementedError

    def _gram(self, X, Y, symmetric):  # pragma: no cover - abstract
        raise NotImplementedError

    def analytic_derivative(self, x, y) -> torch.Tensor:  # pragma: no cover - abstract
        """d k(x, y) / d params by the reference's hand-derived formulas:
        (p,) for one pair, (p, m) for row-wise pairs of two (m, d) batches."""
        raise NotImplementedError

    @property
    def params(self) -> Tuple[torch.Tensor, ...]:
        return tuple(getattr(self, n) for n in self._names)

    @property
    def num_params(self) -> int:
        return len(self.params)

    def with_params(self, vec) -> "Kernel":
        """A new kernel with the hyperparameters replaced, in reference order."""
        vec = list(vec)
        if len(vec) != self.num_params:
            raise ValueError(f"{type(self).__name__}.with_params: wrong number of parameters.")
        new, _ = self._consume_params(vec)
        return new

    def _consume_params(self, vec):
        k = len(self._names)
        return type(self)(*vec[:k]), vec[k:]

    def to_string(self) -> str:  # pragma: no cover - abstract
        raise NotImplementedError

    def __add__(self, other):
        return Sum(self, other)

    def __mul__(self, other):
        return Product(self, other)


def _r2(x, y):
    return ((x - y) ** 2).sum(-1)


def _r(x, y):
    return torch.sqrt(torch.clamp(_r2(x, y), min=1e-36))


class Gaussian(Kernel):
    """k = scale^2 exp(-0.5 |x-y|^2 / sigma^2) (reference Kernel.h:454-559)."""

    _names = ("sigma", "scale")

    def __init__(self, sigma, scale=1.0):
        for name, v in (("sigma", sigma), ("scale", scale)):
            if _is_fleet_member(v):
                continue  # one member inside fleet_map: its fleet was checked whole
            v = v.detach() if isinstance(v, torch.Tensor) else v
            # every member of a fleet leaf; rejects 0, negatives and NaN
            if not bool((torch.as_tensor(v) > 0).all()):
                raise ValueError(f"GaussianKernel: {name} has to be positive")
        super().__init__(sigma, scale)

    def _eval(self, x, y):
        return self.scale**2 * torch.exp(-0.5 * _r2(x, y) / self.sigma**2)

    def _gram(self, X, Y, symmetric):
        return self.scale**2 * torch.exp(-0.5 * sqdist(X, Y) / self.sigma**2)

    def analytic_derivative(self, x, y):
        """Reference Kernel.h:471-479: d/d[sigma, scale]."""
        r2 = _r2(x, y)
        f = torch.exp(-0.5 * r2 / self.sigma**2)
        return torch.stack([self.scale**2 * r2 / self.sigma**3 * f, 2 * self.scale * f])

    def to_string(self):
        return f"GaussianKernel({_fmt(self.sigma)},{_fmt(self.scale)},)"


class GaussianExp(Kernel):
    """Log-parameterized Gaussian (reference Kernel.h:569-676)."""

    _names = ("sigma", "scale")

    def __init__(self, sigma, scale=1.0):
        super().__init__(sigma, scale)

    def _eval(self, x, y):
        es, ec = torch.exp(self.sigma), torch.exp(self.scale)
        return ec**2 * torch.exp(-0.5 * _r2(x, y) / es**2)

    def _gram(self, X, Y, symmetric):
        es, ec = torch.exp(self.sigma), torch.exp(self.scale)
        return ec**2 * torch.exp(-0.5 * sqdist(X, Y) / es**2)

    def analytic_derivative(self, x, y):
        """Reference Kernel.h:588-598."""
        r2 = _r2(x, y)
        f1 = torch.exp(-2 * self.sigma)
        f2 = torch.exp(2 * self.sigma)
        d_sigma = r2 * torch.exp(-0.5 * f1 * ((4 * self.sigma - 4 * self.scale) * f2 + r2))
        d_scale = 2 * torch.exp(0.5 * f1 * (4 * f2 * self.scale - r2))
        return torch.stack([d_sigma, d_scale])

    def to_string(self):
        return f"GaussianExpKernel({_fmt(self.sigma)},{_fmt(self.scale)},)"


# multipliers of the two row hashes of White (kernels.py:299-304), per lane
def _hash_multipliers(lanes: int):
    out = []
    for seed in (0x9E3779B9, 0x85EBCA6B):
        r = np.random.default_rng(seed).integers(0, 2**32, size=(lanes,), dtype=np.uint64)
        out.append(r.astype(np.uint32).astype(np.int64) | 1)
    return out


def _mul_mod32(u: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    # (u * r) mod 2^32 for u, r in [0, 2^32) held in int64: split u into
    # 16-bit halves so that no partial product leaves int64
    lo = (u & 0xFFFF) * r
    hi = (((u >> 16) * r) & 0xFFFF) << 16
    return (lo + hi) & 0xFFFFFFFF


class White(Kernel):
    """k(x, y) = scale^2 [x == y] (reference Kernel.h:685-773).

    The Gram form compares rows bit for bit, as kernels.py:285-318 does: each
    row is reduced to two independent 32-bit polynomial hashes of its bit
    pattern (-0.0 canonicalized to +0.0), and rows are equal iff both hashes
    match.  No proximity aliasing; a NaN row equals itself.  torch has no
    full uint32 arithmetic, so the hashes are computed mod 2^32 in int64.
    A fleet member under ``torch.func.vmap`` compares its rows element by
    element instead (a fleet's n is small)."""

    _names = ("scale",)

    def __init__(self, scale):
        super().__init__(scale)

    def _eval(self, x, y):
        eq = torch.all(x == y, dim=-1)
        s2 = (self.scale**2).to(dtype=x.dtype, device=x.device)
        return torch.where(eq, s2, torch.zeros((), dtype=x.dtype, device=x.device))

    @staticmethod
    def _row_hashes(Z):
        Z = torch.atleast_2d(Z.detach())
        Z = torch.where(Z == 0, torch.zeros((), dtype=Z.dtype, device=Z.device), Z)
        u = Z.contiguous().view(torch.int32).reshape(Z.shape[0], -1).to(torch.int64) & 0xFFFFFFFF
        hashes = []
        for r in _hash_multipliers(u.shape[1]):
            r = torch.as_tensor(r, device=Z.device)
            h = _mul_mod32(u, r[None, :]).sum(1) & 0xFFFFFFFF
            hashes.append(h)
        return hashes

    def _gram(self, X, Y, symmetric):
        if torch._C._functorch.is_batchedtensor(X) or torch._C._functorch.is_batchedtensor(Y):
            # a fleet member under torch.func.vmap, where torch 2.11 has no
            # batching rule for the bit view the hashes take: compare the
            # rows element by element (-0.0 == +0.0, a NaN equal to a NaN)
            e = (X[:, None, :] == Y[None, :, :]) | (torch.isnan(X)[:, None, :] & torch.isnan(Y)[None, :, :])
            eq = e.all(-1)
            s2 = (self.scale**2).to(dtype=X.dtype, device=X.device)
            return torch.where(eq, s2, torch.zeros((), dtype=X.dtype, device=X.device))
        h1x, h2x = self._row_hashes(X)
        h1y, h2y = (h1x, h2x) if symmetric else self._row_hashes(Y)
        eq = (h1x[:, None] == h1y[None, :]) & (h2x[:, None] == h2y[None, :])
        s2 = (self.scale**2).to(dtype=X.dtype, device=X.device)
        return torch.where(eq, s2, torch.zeros((), dtype=X.dtype, device=X.device))

    def analytic_derivative(self, x, y):
        """Reference Kernel.h:704-713."""
        eq = torch.all(x == y, dim=-1)
        return torch.stack([torch.where(eq, 2 * self.scale, torch.zeros_like(self.scale))])

    def to_string(self):
        return f"WhiteKernel({_fmt(self.scale)},)"


class RationalQuadratic(Kernel):
    """k = scale^2 (1 + r^2 / (2 alpha sigma^2))^-alpha (reference Kernel.h:784-891)."""

    _names = ("scale", "sigma", "alpha")

    def _eval(self, x, y):
        return self.scale**2 * (1 + 0.5 * _r2(x, y) / (self.sigma**2 * self.alpha)) ** (-self.alpha)

    def _gram(self, X, Y, symmetric):
        d2 = sqdist(X, Y)
        return self.scale**2 * (1 + 0.5 * d2 / (self.sigma**2 * self.alpha)) ** (-self.alpha)

    def analytic_derivative(self, x, y):
        """Reference Kernel.h:799-808: d/d[scale, sigma, alpha]."""
        r2 = _r2(x, y)
        f = 0.5 * r2 / (self.sigma**2 * self.alpha) + 1
        d_scale = 2 * self.scale * f ** (-self.alpha)
        d_sigma = self.scale**2 * r2 * f ** (-self.alpha - 1) / self.sigma**3
        d_alpha = (self.scale**2 * (r2 / (2 * self.sigma**2 * f * self.alpha) - torch.log(f))
                   * f ** (-self.alpha))
        return torch.stack([d_scale, d_sigma, d_alpha])

    def to_string(self):
        return (f"RationalQuadraticKernel({_fmt(self.scale)},{_fmt(self.sigma)},"
                f"{_fmt(self.alpha)},)")


class Periodic(Kernel):
    """k = scale^2 exp(-0.5 sum_d sin^2(b (x_d - y_d)) / sigma^2)
    (reference Kernel.h:902-1036).  The Gram form uses sin^2 t = (1 - cos 2t)/2
    and the angle-difference identity: two GEMMs."""

    _names = ("scale", "b", "sigma")

    def _eval(self, x, y):
        s2 = (torch.sin(self.b * (x - y)) ** 2).sum(-1)
        return self.scale**2 * torch.exp(-0.5 * s2 / self.sigma**2)

    def _gram(self, X, Y, symmetric):
        d = X.shape[-1]
        cx, sx = torch.cos(2 * self.b * X), torch.sin(2 * self.b * X)
        cy, sy = torch.cos(2 * self.b * Y), torch.sin(2 * self.b * Y)
        sin2 = torch.clamp(0.5 * (d - (cx @ cy.T + sx @ sy.T)), min=0.0)
        return self.scale**2 * torch.exp(-0.5 * sin2 / self.sigma**2)

    def analytic_derivative(self, x, y):
        """Reference Kernel.h:922-948: d/d[scale, b, sigma]."""
        r = x - y
        s = torch.sin(self.b * r)
        f1 = (s * s).sum(-1)
        f2 = (2 * r * torch.cos(self.b * r) * s).sum(-1)
        e = torch.exp(-0.5 * f1 / self.sigma**2)
        return torch.stack([2 * self.scale * e, -0.5 * self.scale**2 * e * f2 / self.sigma**2,
                            self.scale**2 * e * f1 / self.sigma**3])

    def to_string(self):
        return f"PeriodicKernel({_fmt(self.scale)},{_fmt(self.b)},{_fmt(self.sigma)},)"


class _Combination(Kernel):
    """A binary combination of two kernels; its parameters are k1's, then k2's."""

    def __init__(self, k1: Kernel, k2: Kernel):
        super().__init__()
        self.k1 = k1
        self.k2 = k2

    @property
    def params(self):
        return tuple(self.k1.params) + tuple(self.k2.params)

    def _consume_params(self, vec):
        n1, rest = self.k1._consume_params(vec)
        n2, rest = self.k2._consume_params(rest)
        return type(self)(n1, n2), rest


class Sum(_Combination):
    """k1 + k2 (reference Kernel.h:153-296)."""

    def _eval(self, x, y):
        return self.k1._eval(x, y) + self.k2._eval(x, y)

    def _gram(self, X, Y, symmetric):
        return self.k1._gram(X, Y, symmetric) + self.k2._gram(X, Y, symmetric)

    def analytic_derivative(self, x, y):
        return torch.cat([self.k1.analytic_derivative(x, y), self.k2.analytic_derivative(x, y)])

    def to_string(self):
        return f"SumKernel({self.k1.to_string()},{self.k2.to_string()})"


class Product(_Combination):
    """k1 * k2 (reference Kernel.h:302-444)."""

    def _eval(self, x, y):
        return self.k1._eval(x, y) * self.k2._eval(x, y)

    def _gram(self, X, Y, symmetric):
        return self.k1._gram(X, Y, symmetric) * self.k2._gram(X, Y, symmetric)

    def analytic_derivative(self, x, y):
        """Product rule, matching reference Kernel.h:318-327."""
        d1 = self.k1.analytic_derivative(x, y) * self.k2._eval(x, y)
        d2 = self.k2.analytic_derivative(x, y) * self.k1._eval(x, y)
        return torch.cat([d1, d2])

    def to_string(self):
        return f"ProductKernel({self.k1.to_string()},{self.k2.to_string()})"


class _Matern(Kernel):
    """A Matern kernel: a function of r = sqrt(max(|x-y|^2, 1e-36))."""

    _names = ("sigma", "scale")

    def __init__(self, sigma, scale=1.0):
        super().__init__(sigma, scale)

    def _value(self, r):  # pragma: no cover - abstract
        raise NotImplementedError

    def _eval(self, x, y):
        return self._value(_r(x, y))

    def _gram(self, X, Y, symmetric):
        return self._value(torch.sqrt(torch.clamp(sqdist(X, Y), min=1e-36)))


class Matern32(_Matern):
    """Matern nu=3/2: k = scale^2 (1 + a) exp(-a), a = sqrt(3) r / sigma."""

    def _value(self, r):
        a = math.sqrt(3.0) * r / self.sigma
        return self.scale**2 * (1.0 + a) * torch.exp(-a)

    def analytic_derivative(self, x, y):
        a = math.sqrt(3.0) * _r(x, y) / self.sigma
        e = torch.exp(-a)
        return torch.stack([self.scale**2 * e * a * a / self.sigma,
                            2 * self.scale * (1.0 + a) * e])

    def to_string(self):
        return f"Matern32Kernel({_fmt(self.sigma)},{_fmt(self.scale)},)"


class Matern52(_Matern):
    """Matern nu=5/2: k = scale^2 (1 + a + a^2/3) exp(-a), a = sqrt(5) r / sigma."""

    def _value(self, r):
        a = math.sqrt(5.0) * r / self.sigma
        return self.scale**2 * (1.0 + a + a * a / 3.0) * torch.exp(-a)

    def analytic_derivative(self, x, y):
        a = math.sqrt(5.0) * _r(x, y) / self.sigma
        e = torch.exp(-a)
        return torch.stack([self.scale**2 * e * (a * a * (1.0 + a)) / (3.0 * self.sigma),
                            2 * self.scale * (1.0 + a + a * a / 3.0) * e])

    def to_string(self):
        return f"Matern52Kernel({_fmt(self.sigma)},{_fmt(self.scale)},)"


class Matern12(_Matern):
    """Matern nu=1/2 (exponential): k = scale^2 exp(-r / sigma)."""

    def _value(self, r):
        return self.scale**2 * torch.exp(-r / self.sigma)

    def analytic_derivative(self, x, y):
        r = _r(x, y)
        e = torch.exp(-r / self.sigma)
        return torch.stack([self.scale**2 * e * r / self.sigma**2, 2 * self.scale * e])

    def to_string(self):
        return f"Matern12Kernel({_fmt(self.sigma)},{_fmt(self.scale)},)"


class GaussianARD(Kernel):
    """Anisotropic Gaussian, k = scale^2 exp(-0.5 sum_d (x_d - y_d)^2 / sigmas_d^2):
    the inputs are rescaled by 1/sigmas, then one sqdist GEMM."""

    _names = ("sigmas", "scale")

    def __init__(self, sigmas, scale=1.0):
        super().__init__(sigmas, scale)

    def _eval(self, x, y):
        s = self.sigmas.to(dtype=x.dtype, device=x.device)
        return self.scale**2 * torch.exp(-0.5 * (((x - y) / s) ** 2).sum(-1))

    def _gram(self, X, Y, symmetric):
        s = self.sigmas.to(dtype=X.dtype, device=X.device)
        return self.scale**2 * torch.exp(-0.5 * sqdist(X / s, Y / s))

    def analytic_derivative(self, x, y):
        s = self.sigmas
        diff2 = (x - y) ** 2
        e = torch.exp(-0.5 * (diff2 / s**2).sum(-1))
        d_sig = self.scale**2 * e[..., None] * diff2 / s**3  # (..., d)
        return torch.cat([torch.movedim(d_sig, -1, 0), (2 * self.scale * e)[None]])

    @property
    def params(self):
        # the feature axis is the last: fleet leaves are (B, d)
        return tuple(self.sigmas.unbind(-1)) + (self.scale,)

    def _consume_params(self, vec):
        d = self.sigmas.shape[-1]
        return GaussianARD(torch.stack([_hyper(v) for v in vec[:d]], -1), vec[d]), vec[d + 1:]

    def to_string(self):
        vals = ",".join(_fmt(v) for v in self.sigmas)
        return f"GaussianARDKernel({self.sigmas.shape[0]},{vals},{_fmt(self.scale)},)"


class Linear(Kernel):
    """Dot-product kernel k = scale^2 (x . y + offset)."""

    _names = ("scale", "offset")

    def __init__(self, scale, offset=0.0):
        super().__init__(scale, offset)

    def _eval(self, x, y):
        return self.scale**2 * ((x * y).sum(-1) + self.offset)

    def _gram(self, X, Y, symmetric):
        return self.scale**2 * (X @ Y.T + self.offset)

    def analytic_derivative(self, x, y):
        base = (x * y).sum(-1) + self.offset
        return torch.stack([2 * self.scale * base, self.scale**2 + 0.0 * base])

    def to_string(self):
        return f"LinearKernel({_fmt(self.scale)},{_fmt(self.offset)},)"


class Constant(Kernel):
    """k = value everywhere."""

    _names = ("value",)

    def __init__(self, value):
        super().__init__(value)

    def _eval(self, x, y):
        return self.value + 0.0 * (x * y).sum(-1)

    def _gram(self, X, Y, symmetric):
        # a sum, not torch.full(float(value)): the value keeps its gradient
        return torch.zeros((X.shape[0], Y.shape[0]), dtype=X.dtype, device=X.device) + self.value

    def analytic_derivative(self, x, y):
        return torch.ones((1,) + torch.broadcast_shapes(x.shape, y.shape)[:-1],
                          dtype=torch.float64)

    def to_string(self):
        return f"ConstantKernel({_fmt(self.value)},)"


# ---------------------------------------------------------------------------
# module-level functional API
# ---------------------------------------------------------------------------

def gram(kernel: Kernel, X, Y=None) -> torch.Tensor:
    """K[i, j] = k(X[i], Y[j]); with Y None the symmetric K(X, X),
    symmetrized as 0.5 (K + K^T) as kernels.py:541-542 does."""
    X = _as_2d(X)
    symmetric = Y is None
    Y2 = X if symmetric else _as_2d(Y)
    K = kernel._gram(X, Y2, symmetric)
    if symmetric:
        K = 0.5 * (K + K.T)
    return K


def kvec(kernel: Kernel, X, x) -> torch.Tensor:
    """Kx[i] = k(x, X[i]) (reference lib/GaussianProcess.cpp:683-693)."""
    x = torch.atleast_1d(torch.as_tensor(x))
    return gram(kernel, x[None, :], X)[0]


def params_vector(kernel: Kernel) -> torch.Tensor:
    """The hyperparameters in reference order as one float64 vector (p,)."""
    return torch.stack([torch.as_tensor(p, dtype=torch.float64) for p in kernel.params])


def gram_derivative(kernel: Kernel, X) -> torch.Tensor:
    """Stack of dK/dtheta_p, shape (p, n, n), by forward-mode autodiff of
    :func:`gram` (kernels.py:557-568; the reference stacks the same blocks
    into an (n p, n) matrix, lib/GaussianProcess.cpp:471-495)."""
    X = _as_2d(X)
    vec = params_vector(kernel).detach()
    J = torch.func.jacfwd(lambda v: gram(kernel.with_params(list(v)), X))(vec)  # (n, n, p)
    return torch.movedim(J, -1, 0)


def kernel_form(kernel: Kernel):
    """(form, sigma, scale, third) of a kernel that the Gram kernels of
    ``ops/gram.py`` evaluate, with its hyperparameters as the kernel holds
    them (0-dim, or (B,) for a fleet), or None (gpr_tpu exact.py:358-374 and
    batched.py:150-164)."""
    t = type(kernel)
    if t is Gaussian:
        return "gaussian", kernel.sigma, kernel.scale, 1.0
    if t is GaussianExp:
        return "gaussian", torch.exp(kernel.sigma), torch.exp(kernel.scale), 1.0
    if t is RationalQuadratic:
        return "rq", kernel.sigma, kernel.scale, kernel.alpha
    if t in (Matern12, Matern32, Matern52):
        return t.__name__.lower(), kernel.sigma, kernel.scale, 1.0
    if t is Periodic:
        return "periodic", kernel.sigma, kernel.scale, kernel.b
    return None


def fleet_map(fn, kernel: Kernel, batched_kernel: bool, *tensors) -> torch.Tensor:
    """``fn(kernel_b, *tensors_b)`` for every member b of a fleet, stacked:
    ``torch.func.vmap`` over the leading axis of ``tensors``, as
    gpr_tpu/gp/batched.py vmaps its per-member functions.  With
    ``batched_kernel`` every hyperparameter leaf carries that axis too and
    each member gets ``kernel.with_params`` of its own values; otherwise
    all members share ``kernel``.  Autograd runs through it."""
    if batched_kernel:
        device = tensors[0].device
        return torch.func.vmap(lambda ps, *ts: fn(kernel.with_params(ps), *ts))(
            [p.to(device) for p in kernel.params], *tensors)
    return torch.func.vmap(lambda *ts: fn(kernel, *ts))(*tensors)


def analytic_gram_derivative(kernel: Kernel, X, Y=None) -> torch.Tensor:
    """The same stack, (p, n, m), from the reference's hand-derived formulas
    (kernels.py:571-576): every pair (X[i], Y[j]) in one row-wise batch."""
    X = _as_2d(X)
    Y2 = X if Y is None else _as_2d(Y)
    n, m = X.shape[0], Y2.shape[0]
    xs = X[:, None, :].expand(n, m, X.shape[1]).reshape(n * m, -1)
    ys = Y2[None, :, :].expand(n, m, Y2.shape[1]).reshape(n * m, -1)
    return kernel.analytic_derivative(xs, ys).reshape(-1, n, m)
