"""The port's prior densities (gpr_tpu_torch.inference.priors, prior_utils)
against gpr_tpu's, on the CPU in float64.

Every closed-form method agrees to 1e-12 relative (the same formulas; erf,
gammaln and gammainc are torch.special's against jax.scipy.special's).  The
bisection icdf runs the same iterations on the same bracket; its answer may
differ in the last bits where a cdf difference of an ulp flips one step, so
it is held to 1e-9 relative.  Sampling draws from a torch.Generator and
JAX's key alike, so only the moments are compared: the sample mean within 5
standard errors.
"""

import math

import numpy as np
import pytest
import torch

from gpr_tpu.inference import prior_utils as jpu
from gpr_tpu.inference import priors as jpr
from gpr_tpu_torch import convert
from gpr_tpu_torch.inference import prior_utils as tpu
from gpr_tpu_torch.inference import priors as tpr

PARAMS = [
    ("GaussianDensity", (1.0, 2.0)),
    ("LogGaussianDensity", (0.5, 0.7)),
    ("InverseGaussianDensity", (2.0, 1.5)),
    ("GammaDensity", (3.0, 2.0)),
]
IDS = [p[0] for p in PARAMS]
XS = np.array([0.05, 0.5, 1.0, 2.5, 7.0])


def _pair(name, args):
    return getattr(jpr, name)(*args), convert.density_from_numpy((name, np.array(args)))


def _close(a, b, rel=1e-12):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=rel, atol=rel * np.abs(b).max())


@pytest.mark.parametrize("name,args", PARAMS, ids=IDS)
def test_density_methods_match_jax(name, args):
    jd, td = _pair(name, args)
    assert type(td).__name__ == name
    for m in ("pdf", "log_pdf", "cdf", "log_derivative"):
        _close(getattr(td, m)(torch.tensor(XS)), getattr(jd, m)(XS))
        _close(getattr(td, m)(1.7), getattr(jd, m)(1.7))  # a float too
    _close(td(torch.tensor(XS)), jd(XS))
    for m in ("mean", "variance", "mode"):
        _close(getattr(td, m)(), getattr(jd, m)())
    if name == "GaussianDensity":
        _close(td.derivative(torch.tensor(XS)), jd.derivative(XS))
        _close(td.std(), jd.std())
    lo = -1e8 if name == "GaussianDensity" else 1e-10
    for u in (0.1, 0.5, 0.9):
        x = td.icdf(u, a=lo, b=1e8)
        _close(x, jd.icdf(u, a=lo, b=1e8), rel=1e-9)
        assert abs(float(td.cdf(x)) - u) < 1e-7
    _close(td.icdf(torch.tensor([0.2, 0.7], dtype=torch.float64)), jd.icdf(np.array([0.2, 0.7])),
           rel=1e-9)


@pytest.mark.parametrize("name,args", PARAMS, ids=IDS)
def test_log_derivative_is_the_autograd_derivative(name, args):
    _, td = _pair(name, args)
    for x in (0.5, 1.0, 2.5):
        t = torch.tensor(x, dtype=torch.float64, requires_grad=True)
        (g,) = torch.autograd.grad(td.log_pdf(t), t)
        assert abs(float(g) - float(td.log_derivative(x))) < 1e-8


@pytest.mark.parametrize("name,args", PARAMS, ids=IDS)
def test_sampling_moments(name, args):
    _, td = _pair(name, args)
    g = torch.Generator().manual_seed(3)
    s = td.sample(g, (200000,))
    assert s.shape == (200000,) and s.dtype == torch.float64
    se = math.sqrt(float(td.variance()) / s.shape[0])
    assert abs(float(s.mean()) - float(td.mean())) < 5 * se
    again = td.sample(torch.Generator().manual_seed(3), (200000,))
    assert torch.equal(s, again)  # the generator alone sets the draws


def test_parameter_solvers_match_jax():
    _close(tpr.LogGaussianDensity.from_mode_and_variance(2.0, 1.5).mu,
           jpr.LogGaussianDensity.from_mode_and_variance(2.0, 1.5).mu, rel=1e-10)
    d = tpr.LogGaussianDensity.from_mode_and_variance(2.0, 1.5)
    assert abs(float(d.mode()) - 2.0) < 1e-9 and abs(float(d.variance()) - 1.5) < 1e-9
    for method in ("halley", "bisection"):
        t = tpr.InverseGaussianDensity.from_mode_and_variance(1.2, 0.8, method)
        j = jpr.InverseGaussianDensity.from_mode_and_variance(1.2, 0.8, method)
        _close(t.mu, j.mu, rel=1e-12)
        _close(t.lam, j.lam, rel=1e-12)
        assert abs(float(t.mode()) - 1.2) < 1e-10
    assert tpr.GammaDensity.get_alpha(2.0, 1.0) == jpr.GammaDensity.get_alpha(2.0, 1.0)
    assert tpr.GammaDensity.get_beta(2.0, 1.0) == jpr.GammaDensity.get_beta(2.0, 1.0)
    g = tpr.GammaDensity.from_mode_and_variance(2.0, 1.0)
    _close(g.alpha / g.beta**2, 1.0)  # the variance relation the reference's formulas keep
    with pytest.raises(ValueError):
        tpr.LogGaussianDensity.from_mode_and_variance(-1.0, 1.0)


def test_invalid_parameters_rejected():
    for cls, args in ((tpr.GaussianDensity, (0.0, -1.0)), (tpr.GammaDensity, (-1.0, 1.0)),
                      (tpr.InverseGaussianDensity, (0.0, 1.0)),
                      (tpr.LogGaussianDensity, (0.0, 0.0)),
                      (tpr.GaussianDensity, (0.0, float("nan")))):
        with pytest.raises(ValueError):
            cls(*args)
    with pytest.raises(ValueError):
        convert.density_from_numpy(("CauchyDensity", [0.0, 1.0]))


def test_get_samples_match_jax():
    jd, td = _pair("GammaDensity", (4.0, 2.0))
    _close(tpr.get_samples(td, 7), jpr.get_samples(jd, 7), rel=1e-9)
    jd, td = _pair("LogGaussianDensity", (0.5, 0.4))
    t, j = tpu.get_samples(td, 6), jpu.get_samples(jd, 6)
    assert len(t) == len(j) and t[0] == pytest.approx(float(jd.mode()), rel=1e-12)
    _close(t, j, rel=1e-9)
    assert tpu.get_samples(td, 0) == pytest.approx([float(jd.mode())], rel=1e-12)
