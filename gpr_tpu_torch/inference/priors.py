"""Prior densities over hyperparameters.

Mirrors gpr_tpu/inference/priors.py (whole file), the reference's density
hierarchy (include/Prior.h:66-751): Gaussian, LogGaussian, InverseGaussian
and Gamma densities with pdf / log-pdf / cdf / bisection icdf / sampling /
mode-variance parameter solvers.  A density's parameters are float64 0-dim
tensors; every method takes a float or a tensor and is differentiable, so
``log_pdf`` feeds the MAP objective.  The special functions are
``torch.special``'s (erf, gammaln, gammainc).  Sampling takes an explicit
``torch.Generator``, where the JAX package takes a PRNG key: the two give
different draws from the same seed, so they agree in distribution only.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float64)


def _positive(cls_name, message, *values):
    for v in values:
        if not float(v) > 0:  # rejects 0, negatives and NaN
            raise ValueError(f"{cls_name}: {message}")


class Density:
    """Base density (reference Prior.h:66-127)."""

    # bisection bracket matching the density's support: a positive-support
    # density has NaN cdfs at negative x, and a NaN bracket endpoint would
    # collapse the bisection to a wrong constant (priors.py:64-69)
    icdf_support = (-1e8, 1e8)

    def __call__(self, x):
        return self.pdf(x)

    def pdf(self, x):  # pragma: no cover - abstract
        raise NotImplementedError

    def log_pdf(self, x):  # pragma: no cover - abstract
        raise NotImplementedError

    def cdf(self, x):  # pragma: no cover - abstract
        raise NotImplementedError

    def log_derivative(self, x):  # pragma: no cover - abstract
        """d/dx log p(x), the reference's GetLogDerivative."""
        raise NotImplementedError

    def icdf(self, u, a=None, b=None, iters: int = 1000, tol: float = 1e-10) -> torch.Tensor:
        """Bisection inverse cdf (reference Density::icdf, Prior.h:87-116).
        ``a``/``b`` default to the support bracket; ``tol`` caps the iteration
        count at log2(bracket / tol) when the bracket is a pair of numbers."""
        a = self.icdf_support[0] if a is None else a
        b = self.icdf_support[1] if b is None else b
        if isinstance(a, (int, float)) and isinstance(b, (int, float)):
            span = float(b) - float(a)
            if span > 0 and tol > 0:
                iters = min(iters, max(1, int(math.ceil(math.log2(span / tol)))))
        u = _t(u)
        a = torch.broadcast_to(_t(a), u.shape)
        b = torch.broadcast_to(_t(b), u.shape)
        for _ in range(iters):
            c = 0.5 * (a + b)
            f = self.cdf(c) - u
            fa = self.cdf(a) - u
            b_new = torch.where(torch.sign(fa) != torch.sign(f), c, b)
            a = torch.where(torch.sign(self.cdf(b) - u) != torch.sign(f), c, a)
            b = b_new
        return 0.5 * (a + b)


class GaussianDensity(Density):
    """N(mu, sigma^2) (reference Prior.h:138-191)."""

    def __init__(self, mu, sigma):
        _positive("GaussianDensity", "the Gaussian density is only defined for sigma>0", sigma)
        self.mu, self.sigma = _t(mu), _t(sigma)

    def pdf(self, x):
        s = self.sigma
        return 1.0 / (s * math.sqrt(2 * math.pi)) * torch.exp(-((_t(x) - self.mu) ** 2) / (2 * s**2))

    def log_pdf(self, x):
        s = self.sigma
        return -torch.log(s * math.sqrt(2 * math.pi)) - (_t(x) - self.mu) ** 2 / (2 * s**2)

    def derivative(self, x):
        """Reference Prior.h:159-161."""
        s, d = self.sigma, _t(x) - self.mu
        return -d * torch.exp(-(d**2) / (2 * s**2)) / (math.sqrt(2.0) * math.sqrt(math.pi) * s**3)

    def log_derivative(self, x):
        return -(_t(x) - self.mu) / self.sigma**2

    def cdf(self, x):
        return 0.5 * (1 + torch.special.erf((_t(x) - self.mu) / (self.sigma * math.sqrt(2.0))))

    def mean(self):
        return self.mu

    def variance(self):
        # the reference returns sigma here (Prior.h:175-177); as the JAX
        # package, the port returns the variance and exposes std separately
        return self.sigma**2

    def std(self):
        return self.sigma

    def mode(self):
        return self.mu

    def sample(self, generator: torch.Generator, shape=()):
        return self.mu + self.sigma * torch.randn(shape, generator=generator, dtype=torch.float64)


class LogGaussianDensity(Density):
    """Log-normal (reference Prior.h:199-432)."""

    icdf_support = (1e-12, 1e8)

    def __init__(self, mu, sigma):
        _positive("LogGaussianDensity", "the LogGaussian density is only defined for sigma>0",
                  sigma)
        self.mu, self.sigma = _t(mu), _t(sigma)

    def pdf(self, x):
        x, m, s = _t(x), self.mu, self.sigma
        return 1.0 / (x * s * math.sqrt(2 * math.pi)) * torch.exp(-((torch.log(x) - m) ** 2)
                                                                    / (2 * s**2))

    def log_pdf(self, x):
        x, m, s = _t(x), self.mu, self.sigma
        return -torch.log(x * s * math.sqrt(2 * math.pi)) - (torch.log(x) - m) ** 2 / (2 * s**2)

    def log_derivative(self, x):
        """Reference Prior.h:235-238."""
        x, m, s = _t(x), self.mu, self.sigma
        return -(torch.log(x) + s**2 - m) / (s**2 * x)

    def cdf(self, x):
        return 0.5 + 0.5 * torch.special.erf((torch.log(_t(x)) - self.mu)
                                             / (math.sqrt(2.0) * self.sigma))

    def mean(self):
        return torch.exp(self.mu + self.sigma**2 / 2)

    def variance(self):
        s2 = self.sigma**2
        return (torch.exp(s2) - 1) * torch.exp(2 * self.mu + s2)

    def mode(self):
        return torch.exp(self.mu - self.sigma**2)

    def sample(self, generator: torch.Generator, shape=()):
        z = torch.randn(shape, generator=generator, dtype=torch.float64)
        return torch.exp(self.mu + self.sigma * z)

    @staticmethod
    def from_mode_and_variance(mode: float, variance: float) -> "LogGaussianDensity":
        """(mu, sigma) from (mode, variance): the reference's fixed-point
        start (Prior.h:364-388), then Newton on the 2x2 system in float64 on
        the host, as priors.py:231-292."""
        mode, variance = float(mode), float(variance)
        s, avg, cnt = 0.0, 0.0, 0
        for i in range(20):
            s = math.sqrt(math.log(1 + variance / math.exp(math.log(mode) + 1.5 * s * s)))
            if i > 10:
                avg += s
                cnt += 1
        s = avg / cnt
        p = np.array([math.log(mode) + s * s, s])

        def F(mu, s):
            return np.array([math.exp(mu - s * s) - mode,
                             (math.exp(s * s) - 1) * math.exp(2 * mu + s * s) - variance])

        def J(mu, s):
            e1, e2 = math.exp(mu - s * s), math.exp(2 * mu + s * s)
            return np.array([[e1, -2 * s * e1],
                             [2 * (math.exp(s * s) - 1) * e2,
                              2 * s * (2 * math.exp(s * s) - 1) * e2]])

        for _ in range(200):
            try:
                step = np.linalg.solve(J(p[0], p[1]), F(p[0], p[1]))
            except np.linalg.LinAlgError:
                break
            p_new = p - step
            if not np.all(np.isfinite(p_new)):
                break
            converged = np.linalg.norm(p_new - p) < 1e-15
            p = p_new
            if converged:
                break
        mu, s = float(p[0]), abs(float(p[1]))
        err_mode = abs(math.exp(mu - s * s) - mode)
        err_var = abs((math.exp(s * s) - 1) * math.exp(2 * mu + s * s) - variance)
        if err_mode > 1e-10 or err_var > 1e-10 or math.isnan(mu) or math.isnan(s):
            raise ValueError(
                f"LogGaussianDensity::GetMuAndSigma: cannot determ mu and sigma for mode={mode} "
                f"and variance={variance}. Errors: mode {err_mode}, variance {err_var}")
        return LogGaussianDensity(mu, s)


class InverseGaussianDensity(Density):
    """Inverse Gaussian / Wald (reference Prior.h:442-668):
    p(x | lambda, mu) = sqrt(lambda / (2 pi x^3)) exp(-lambda (x - mu)^2 / (2 mu^2 x))."""

    icdf_support = (1e-12, 1e8)

    def __init__(self, lam, mu):
        _positive("InverseGaussianDensity",
                  "the inverse Gaussian density is only defined for lambda>0 and mu>0", lam, mu)
        self.lam, self.mu = _t(lam), _t(mu)

    def pdf(self, x):
        x, lam, mu = _t(x), self.lam, self.mu
        return torch.sqrt(lam / (2 * math.pi * x**3)) * torch.exp(-lam * (x - mu) ** 2
                                                                   / (2 * mu**2 * x))

    def log_pdf(self, x):
        x, lam, mu = _t(x), self.lam, self.mu
        return (0.5 * (torch.log(lam) - math.log(2 * math.pi) - 3 * torch.log(x))
                - lam * (x - mu) ** 2 / (2 * mu**2 * x))

    def log_derivative(self, x):
        """Reference Prior.h:486-488."""
        x, lam, mu = _t(x), self.lam, self.mu
        return -3 / (2 * x) + lam / (2 * x**2) - lam / (2 * mu**2)

    def cdf(self, x):
        x, lam, mu = _t(x), self.lam, self.mu

        def phi(t):
            return 0.5 * (1 + torch.special.erf(t / math.sqrt(2.0)))

        safe_x = torch.where(x > 0, x, 1.0)
        root = torch.sqrt(lam / safe_x)
        big = torch.clamp(2 * lam / mu, max=math.log(torch.finfo(x.dtype).max))
        val = phi(root * (safe_x / mu - 1)) + torch.exp(big) * phi(-root * (safe_x / mu + 1))
        return torch.where(x > 0, val, 0.0)

    def mean(self):
        return self.mu

    def variance(self):
        return self.mu**3 / self.lam

    def mode(self):
        mu, lam = self.mu, self.lam
        return mu * (torch.sqrt(1 + 9 * mu**2 / (4 * lam**2)) - 3 * mu / (2 * lam))

    def sample(self, generator: torch.Generator, shape=()):
        """Michael-Schucany-Haas transformation (reference Prior.h:466-478)."""
        mu, lam = self.mu, self.lam
        v = torch.randn(shape, generator=generator, dtype=torch.float64)
        y = v * v
        x = mu + mu**2 * y / (2 * lam) - mu / (2 * lam) * torch.sqrt(4 * mu * lam * y + mu**2 * y**2)
        z = torch.rand(shape, generator=generator, dtype=torch.float64)
        return torch.where(z <= mu / (mu + x), x, mu**2 / x)

    @staticmethod
    def from_mode_and_variance(mode: float, variance: float,
                               method: str = "halley") -> "InverseGaussianDensity":
        """(lambda, mu) from (mode, variance) by Halley's method or bisection
        (reference Prior.h:547-662), as priors.py:369-433."""
        mode, variance = float(mode), float(variance)

        def f(mu):
            return (math.sqrt(4 * mu**4 + 9 * variance**2) - 2 * mode * mu - 3 * variance) / (2 * mu)

        if method == "halley":
            def df(mu):
                r = math.sqrt(4 * mu**4 + 9 * variance**2)
                return (3 * variance * (r - 3 * variance) + 4 * mu**4) / (2 * mu**2 * r)

            def ddf(mu):
                a = 4 * mu**4 + 9 * variance**2
                r = math.sqrt(a**3)
                return -(3 * variance * (r - 36 * variance * mu**4 - 27 * variance**3)) / (mu**3 * r)

            mu = 1.6
            for _ in range(100):
                fm, dfm, ddfm = f(mu), df(mu), ddf(mu)
                mu_new = mu - (2 * fm * dfm) / (2 * dfm**2 - fm * ddfm)
                done = abs(mu_new - mu) < 1e-14
                mu = mu_new
                if done:
                    break
        else:  # bisection (reference Prior.h:619-662)
            a, b, mu = 1e-16, 1e8, 0.0
            for _ in range(1000):
                c = 0.5 * (a + b)
                fc = f(c)
                if abs(a - c) < 1e-14:
                    mu = c
                    break
                if math.copysign(1, f(a)) != math.copysign(1, fc):
                    b = c
                if math.copysign(1, f(b)) != math.copysign(1, fc):
                    a = c
        if math.isnan(mu) or math.isinf(mu):
            raise ValueError(f"InverseGaussianDensity::GetMeanAndLambda: cannot determ mean "
                             f"and lambda for mode={mode} and variance={variance}")
        cand = InverseGaussianDensity(mu**3 / variance, mu)
        if abs(float(cand.mode()) - mode) > 1e-10:
            raise ValueError(f"InverseGaussianDensity::GetMeanAndLambda: cannot determ mean "
                             f"and lambda for mode={mode} and variance={variance}")
        return cand


class GammaDensity(Density):
    """Gamma with rate beta (reference Prior.h:677-751), in the rate
    convention the reference's cdf, moments and solvers use:
    p(x) = beta^alpha / Gamma(alpha) x^(alpha-1) exp(-beta x)."""

    icdf_support = (1e-12, 1e8)

    def __init__(self, alpha, beta):
        _positive("GammaDensity", "the Gamma density is only defined for alpha>0 and beta>0",
                  alpha, beta)
        self.alpha, self.beta = _t(alpha), _t(beta)

    def pdf(self, x):
        return torch.exp(self.log_pdf(x))

    def log_pdf(self, x):
        a, b, x = self.alpha, self.beta, _t(x)
        return a * torch.log(b) - torch.special.gammaln(a) + (a - 1) * torch.log(x) - b * x

    def log_derivative(self, x):
        return (self.alpha - 1) / _t(x) - self.beta

    def cdf(self, x):
        """Reference Prior.h:719-721: tgamma_lower(alpha, beta x) / Gamma(alpha)."""
        return torch.special.gammainc(self.alpha, self.beta * _t(x))

    def mean(self):
        return self.alpha / self.beta

    def variance(self):
        return self.alpha / self.beta**2

    def mode(self):
        return (self.alpha - 1) / self.beta

    def sample(self, generator: torch.Generator, shape=()):
        g = torch._standard_gamma(self.alpha.expand(shape).contiguous(), generator=generator)
        return g / self.beta

    @staticmethod
    def get_alpha(mode: float, variance: float) -> float:
        """Reference Prior.h:739-741."""
        m2 = mode * mode
        return (math.sqrt(m2 * (m2 + 4 * variance)) + m2 + 2 * variance) / (2 * variance)

    @staticmethod
    def get_beta(mode: float, variance: float) -> float:
        """Reference Prior.h:742-744."""
        return math.sqrt(GammaDensity.get_alpha(mode, variance) / variance)

    @staticmethod
    def from_mode_and_variance(mode: float, variance: float) -> "GammaDensity":
        return GammaDensity(GammaDensity.get_alpha(mode, variance),
                            GammaDensity.get_beta(mode, variance))


def get_samples(density: Density, n: int) -> np.ndarray:
    """Equidistant inverse-transform samples clipped to mode +/- std
    (reference include/PriorUtils.h:33-58; priors.py:510-522)."""
    mode = float(density.mode())
    std = math.sqrt(abs(float(density.variance())))
    lo = max(mode - std, 1e-10)
    hi = mode + std
    us = np.linspace(float(density.cdf(lo)), float(density.cdf(hi)), n)
    return np.array([float(density.icdf(u, a=1e-10, b=1e8)) for u in us])
