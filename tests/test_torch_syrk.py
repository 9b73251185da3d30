"""K5's plain version (gpr_tpu_torch.ops.syrk) against the JAX package's Pallas
SYRK (gpr_tpu.ops.pallas_syrk.syrk_update) in interpret mode, and the
wrapper's refusals.

Both compute A22 - L21 L21^T in float32; the JAX kernel sums in 128-deep
slices, torch in one GEMM, so the lower triangles agree to 1e-5 of the
largest entry (float32 sums of k terms in another order).  The kernel
itself runs only on the card (tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpr_tpu.ops.pallas_syrk import syrk_update as jax_syrk
from gpr_tpu_torch.ops import _cuda, syrk


@pytest.mark.parametrize("m,k", [(256, 384), (512, 128)])
def test_plain_syrk_matches_jax(m, k):
    rng = np.random.default_rng(12)
    A22 = rng.standard_normal((m, m)).astype(np.float32)
    L21 = rng.standard_normal((m, k)).astype(np.float32)
    Sj = np.asarray(jax_syrk(jnp.asarray(A22), jnp.asarray(L21), bm=128, bk=128,
                             precision="highest", interpret=True))
    _cuda.reset_launch_counts()
    St = syrk.syrk_update(torch.tensor(A22), torch.tensor(L21)).numpy()
    assert _cuda.launch_counts()["syrk_update"] == 0  # a CPU tensor runs the plain version
    tl = np.tril_indices(m)
    scale = np.abs(Sj[tl]).max()
    assert np.abs(St[tl] - Sj[tl]).max() <= 1e-5 * scale
    np.testing.assert_array_equal(syrk.syrk_update_reference(torch.tensor(A22),
                                                             torch.tensor(L21)).numpy(), St)


def test_plain_syrk_matches_jax_on_an_unaligned_view():
    # the recursion's case at odd n: views of one buffer with an odd row
    # stride, a ragged (m, k) (not multiples of the card's 128-row tiles or
    # 32-deep slices), updated in place; JAX's kernel takes blocks that
    # divide m and k
    rng = np.random.default_rng(14)
    n, m0 = 301, 106
    W = rng.standard_normal((n, n)).astype(np.float32)
    A22, L21 = W[m0:, m0:], W[m0:, 1:m0]
    m, k = L21.shape
    Sj = np.asarray(jax_syrk(jnp.asarray(A22), jnp.asarray(L21), bm=65, bk=35,
                             precision="highest", interpret=True))
    Wt = torch.tensor(W)
    A22t, L21t = Wt[m0:, m0:], Wt[m0:, 1:m0]
    assert (m, k) == (195, 105) and A22t.stride(0) == L21t.stride(0) == n
    out = syrk.syrk_update(A22t, L21t, out=A22t)
    assert out.data_ptr() == A22t.data_ptr()
    tl = np.tril_indices(m)
    scale = np.abs(Sj[tl]).max()
    assert np.abs(A22t.numpy()[tl] - Sj[tl]).max() <= 1e-5 * scale
    np.testing.assert_array_equal(Wt[:m0].numpy(), W[:m0])  # nothing else written
    np.testing.assert_array_equal(L21t.numpy(), L21)


def test_in_place_on_views_of_one_buffer():
    rng = np.random.default_rng(13)
    W = torch.tensor(rng.standard_normal((300, 300)), dtype=torch.float32)
    A22, L21 = W[120:, 120:], W[120:, :120]
    expect = A22 - L21 @ L21.T
    out = syrk.syrk_update(A22, L21, out=A22)
    assert out.data_ptr() == A22.data_ptr()
    torch.testing.assert_close(W[120:, 120:], expect, rtol=0, atol=0)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    A = torch.zeros((8, 8))
    L = torch.zeros((8, 3))
    with pytest.raises(ValueError):
        syrk.syrk_update(A.double(), L.double())  # dtype
    with pytest.raises(ValueError):
        syrk.syrk_update(A, torch.zeros((7, 3)))  # rows differ
    with pytest.raises(ValueError):
        syrk.syrk_update(torch.zeros((8, 9)), L)  # A22 not square
    with pytest.raises(ValueError):
        syrk.syrk_update(A, torch.zeros((3, 8)).T)  # L21 rows not contiguous
    with pytest.raises(ValueError):
        syrk.syrk_update(A, L, out=torch.zeros((8, 7)))  # out of the wrong shape
    with pytest.raises(ValueError):
        syrk.syrk_update(A, L, out=torch.zeros((8, 8), dtype=torch.float64))
    with pytest.raises(ValueError):
        syrk.syrk_update(torch.zeros((0, 0)), torch.zeros((0, 3)))  # empty
    with pytest.raises(ValueError):
        syrk.syrk_update(A.to("meta"), L.to("meta"))  # neither CPU nor CUDA
    with pytest.raises(ValueError):
        syrk.syrk_update(A, L.to("meta"))  # two devices
