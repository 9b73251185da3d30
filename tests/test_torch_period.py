"""The port's period estimation (gpr_tpu_torch.inference.period) against
gpr_tpu's, on the CPU: the period, the dominant amplitude and the
sinus-likeness of random and sinusoidal signals for omit 0-2 agree to 1e-10
relative in float64 (the same FFT formulas), the dtype's largest value where
one bin holds all the amplitude, and the same error for a short signal."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpr_tpu.inference import period as jper
from gpr_tpu_torch.inference import period as tper


def _signal(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.standard_normal(n)
    t = np.arange(n)
    return 1.5 + np.sin(2 * np.pi * t / 12.5) + 0.3 * np.sin(2 * np.pi * t / 40) \
        + 0.05 * rng.standard_normal(n)


def _same(a, b):
    a, b = float(a), float(b)
    if math.isinf(b) or math.isinf(a):
        assert a == b
    else:
        assert abs(a - b) <= 1e-10 * max(abs(b), 1e-300)


@pytest.mark.parametrize("omit", [0, 1, 2])
@pytest.mark.parametrize("kind,n", [("random", 64), ("random", 101), ("sinus", 200), ("sinus", 37)])
def test_period_matches_jax(kind, n, omit):
    x = _signal(kind, n, n + omit)
    for a, b in zip(tper.get_local_period_length(torch.tensor(x), omit),
                    jper.get_local_period_length(jnp.asarray(x), omit)):
        _same(a, b)
    # a numpy signal goes to the device it is told
    p, _, _ = tper.get_local_period_length(x, omit, device="cpu")
    _same(p, jper.get_local_period_length(jnp.asarray(x), omit)[0])


def test_single_bin_sinus_likeness_is_the_largest_value():
    x = np.array([0.0, 1.0, -1.0, 2.0, 0.5, -0.5, 1.5, 0.25])  # n = 8: bins 0-3
    t = tper.get_local_period_length(torch.tensor(x), 3)
    j = jper.get_local_period_length(jnp.asarray(x), 3)
    assert float(t[2]) == float(j[2]) == torch.finfo(torch.float64).max
    for a, b in zip(t, j):
        _same(a, b)
    t32 = tper.get_local_period_length(torch.tensor(x, dtype=torch.float32), 3)
    assert float(t32[2]) == torch.finfo(torch.float32).max


@pytest.mark.parametrize("n,omit", [(4, 1), (5, 2), (3, 0)])
def test_short_signal_raises(n, omit):
    with pytest.raises(ValueError, match="longer signal required"):
        jper.get_local_period_length(jnp.ones(n), omit)
    with pytest.raises(ValueError, match="longer signal required"):
        tper.get_local_period_length(torch.ones(n), omit)


def test_periodic_b_from_period():
    for p in (12.5, 40, torch.tensor(7.0, dtype=torch.float64)):
        b = tper.periodic_b_from_period(p)
        _same(b, jper.periodic_b_from_period(float(p)))
        assert b.dtype == torch.float64
    assert tper.periodic_b_from_period(4.0, torch.float32).dtype == torch.float32
