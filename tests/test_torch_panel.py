"""The port's fused panel factor (gpr_tpu_torch.ops.panel: K15's plain version)
and the two panel schedules built on it, against gpr_tpu.ops.pallas_panel on
the CPU, where the JAX package runs its Pallas panel kernel in interpret mode
(about 0.65 s for a (1024, 256) panel).

The same numpy inputs (seeded) go through both packages, in float32.
Tolerance: 1e-5 relative to the largest entry, for the panel and for the
whole factor (as tests/test_torch_leaf.py holds the leaf kernels): both sides
sum in float32 in other orders, the port's plain version by cholesky_ex and a
triangular solve, JAX's by strip factors and products with the inverse.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpr_tpu.ops import pallas_panel as jpp
from gpr_tpu_torch.ops import _cuda, panel

TOL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / np.abs(b).max()


def _spd(n, seed):
    G = np.random.default_rng(seed).standard_normal((n, n))
    return (G @ G.T + n * np.eye(n)).astype(np.float32)


@pytest.mark.parametrize("n", [512, 1024])
@pytest.mark.parametrize("fn", ["panel_factor", "cholesky_panels", "cholesky_left_panels"])
def test_matches_jax(fn, n):
    A = _spd(n, seed=n + 1)
    arg = A[:, :256] if fn == "panel_factor" else A
    out_j = np.asarray(getattr(jpp, fn)(jnp.asarray(arg), interpret=True))
    _cuda.reset_launch_counts()
    out = getattr(panel, fn)(torch.tensor(arg))
    assert sum(_cuda.launch_counts().values()) == 0  # the plain version on the CPU
    assert out.dtype == torch.float32 and out.shape == arg.shape
    assert _rel(out, out_j) < TOL
    if fn != "panel_factor":
        assert np.all(np.triu(out.numpy(), 1) == 0)
        assert _rel(out, np.linalg.cholesky(A.astype(np.float64))) < TOL


def test_panel_reads_the_diagonal_block_as_rows():
    # the top block is read from its upper triangle (pallas_panel.py:42-89
    # reads row j at columns >= j), on a strided view of a wider matrix
    A = _spd(1024, seed=7)
    P = np.array(A[:, :256])
    P[np.tril_indices(256, -1)] = np.nan
    L = panel.panel_factor(torch.tensor(A)[:, :256])
    assert _rel(panel.panel_factor(torch.tensor(P)), L) == 0.0
    assert np.all(np.triu(L[:256].numpy(), 1) == 0)


def test_shape_gate_and_failed_pivot():
    for shape in ((1000, 256), (1024, 128), (1024,)):
        with pytest.raises(ValueError, match="must be"):
            panel.panel_factor(torch.zeros(shape))
    with pytest.raises(ValueError, match="multiple of 256"):
        panel.cholesky_panels(torch.eye(1000))
    A = _spd(512, seed=8)
    A[100, 100] = -A[100, 100]
    P = panel.panel_factor(torch.tensor(A[:, :256]))
    assert bool(torch.isnan(P[-1]).all())  # a failed pivot reaches every row below
    assert np.isnan(float(panel.cholesky_left_panels(torch.tensor(A))[-1, -1]))
