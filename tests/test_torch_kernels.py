"""Kernel algebra of the port (gpr_tpu_torch.kernels) against gpr_tpu.kernels.

Both packages build each kernel from the same kernel string and evaluate it
on the same numpy inputs in float64.  Tolerance 1e-10: both compute the same
GEMM forms in float64 and differ only in summation order.
"""

import numpy as np
import pytest
import torch

import gpr_tpu as jg
import gpr_tpu_torch as tg

KERNEL_STRINGS = [
    "GaussianKernel(2.5,1.3,)",
    "GaussianExpKernel(0.7,0.2,)",
    "WhiteKernel(1.7,)",
    "RationalQuadraticKernel(1.2,2,3,)",
    "PeriodicKernel(1.5,0.80000000000000004,1.1000000000000001,)",
    "Matern12Kernel(1.3,0.90000000000000002,)",
    "Matern32Kernel(1.3,0.90000000000000002,)",
    "Matern52Kernel(1.3,0.90000000000000002,)",
    "GaussianARDKernel(3,0.5,1.5,2.5,1.2,)",
    "LinearKernel(0.69999999999999996,0.29999999999999999,)",
    "ConstantKernel(0.40000000000000002,)",
    "SumKernel(GaussianKernel(2,1,),PeriodicKernel(1.5,0.80000000000000004,1.1000000000000001,))",
    "ProductKernel(GaussianKernel(2,1,),RationalQuadraticKernel(1.2,2,3,))",
    "SumKernel(ProductKernel(GaussianKernel(2,1.5,),PeriodicKernel(1.5,0.80000000000000004,"
    "1.1000000000000001,)),WhiteKernel(0.29999999999999999,))",
    "SumKernel(GaussianKernel(1.5,1,),WhiteKernel(0.10000000000000001,))",
]

# composites for the string round trip (parsed, printed, compared byte for byte)
COMPOSITES = [
    "SumKernel(GaussianKernel(1,1,),GaussianKernel(2,0.5,))",
    "ProductKernel(PeriodicKernel(1,M_PI,2,),GaussianKernel(3.5,1,))",
    "SumKernel(SumKernel(GaussianKernel(1,1,),WhiteKernel(0.01,)),ConstantKernel(0.5,))",
    "ProductKernel(SumKernel(Matern32Kernel(1.5,1,),LinearKernel(0.3,0.1,)),WhiteKernel(2,))",
    "SumKernel(GaussianARDKernel(2,0.5,1.5,1,),WhiteKernel(0.1,))",
    "ProductKernel(ProductKernel(GaussianKernel(1,1,),PeriodicKernel(1,2,3,)),"
    "RationalQuadraticKernel(1,2,0.5,))",
    "SumKernel(Matern12Kernel(0.7,1.1,),Matern52Kernel(2.2,0.9,))",
    "SumKernel( GaussianKernel( 130 , 2 , ) , PeriodicKernel( 1 , 3.14 , 2 , ) )",
    "ProductKernel(GaussianExpKernel(-0.5,0.25,),ConstantKernel(3,))",
    "SumKernel(ProductKernel(LinearKernel(1,0,),LinearKernel(2,1,)),"
    "SumKernel(WhiteKernel(1e-3,),GaussianKernel(1e2,1e-2,)))",
    "SumKernel(PeriodicKernel(1,M_PI_2,1,),ProductKernel(GaussianKernel(1,M_E,),WhiteKernel(1,)))",
    "ProductKernel(SumKernel(GaussianKernel(0.1,0.2,),GaussianKernel(0.3,0.4,)),"
    "SumKernel(Matern32Kernel(0.5,0.6,),RationalQuadraticKernel(0.7,0.8,0.9,)))",
]

TOL = 1e-10


def _pair(s):
    return jg.parse_kernel(s), tg.parse_kernel(s)


@pytest.mark.parametrize("kstr", KERNEL_STRINGS)
def test_gram_parity_f64(kstr, rng):
    jk, tk = _pair(kstr)
    X = rng.standard_normal((17, 3))
    Y = rng.standard_normal((11, 3))
    X[5] = X[2]  # a repeated row, so White's equality is exercised
    for args in ((X, Y), (X,)):
        Kj = np.asarray(jg.gram(jk, *args))
        Kt = tg.gram(tk, *[torch.tensor(a) for a in args]).numpy()
        assert Kt.dtype == np.float64
        np.testing.assert_allclose(Kt, Kj, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        float(tk(torch.tensor(X[0]), torch.tensor(Y[1]))), float(jk(X[0], Y[1])),
        rtol=TOL, atol=TOL,
    )
    np.testing.assert_allclose(
        tg.kvec(tk, torch.tensor(X), torch.tensor(Y[3])).numpy(),
        np.asarray(jg.kvec(jk, X, Y[3])), rtol=TOL, atol=TOL,
    )


@pytest.mark.parametrize("kstr", KERNEL_STRINGS)
def test_params_and_strings(kstr):
    jk, tk = _pair(kstr)
    assert tk.to_string() == jk.to_string() == tg.kernel_to_string(tk)
    np.testing.assert_array_equal([float(p) for p in tk.params],
                                  [float(p) for p in jk.params])
    # parse -> to_string -> parse is a fixed point
    assert tg.parse_kernel(tk.to_string()).to_string() == tk.to_string()
    vec = [0.5 + 0.25 * i for i in range(tk.num_params)]
    assert tk.with_params(vec).to_string() == jk.with_params(vec).to_string()


@pytest.mark.parametrize("kstr", COMPOSITES)
def test_composite_strings_identical(kstr, rng):
    jk, tk = _pair(kstr)
    assert tk.to_string() == jk.to_string()
    assert tg.parse_kernel(tk.to_string()).to_string() == tk.to_string()
    X = rng.standard_normal((9, 2))
    np.testing.assert_allclose(tg.gram(tk, torch.tensor(X)).numpy(), np.asarray(jg.gram(jk, X)),
                               rtol=TOL, atol=TOL)


def test_white_is_bit_exact():
    # -0.0 == +0.0, a NaN row equals itself, and rows one ulp apart differ
    for dtype in (np.float64, np.float32):
        Xd = np.zeros((6, 2), dtype)
        Xd[0] = [1.0, 2.0]
        Xd[1] = [1.0, np.nextafter(dtype(2.0), dtype(3.0))]
        Xd[2] = [-0.0, 0.0]
        Xd[3] = [0.0, -0.0]
        Xd[4] = [np.nan, 1.0]
        Xd[5] = [np.nan, 1.0]
        Kt = tg.gram(tg.White(2.0), torch.tensor(Xd)).numpy()
        Kj = np.asarray(jg.gram(jg.White(2.0), Xd))
        np.testing.assert_array_equal(Kt, Kj)
        eq = Kt == 4.0
        assert not eq[0, 1]
        assert eq[2, 3] and eq[3, 2]
        assert eq[4, 5] and eq[4, 4]
        # the port's int64 emulation gives the JAX package's uint32 hashes
        ht = [h.numpy() for h in tg.White._row_hashes(torch.tensor(Xd))]
        hj = [np.asarray(h).astype(np.int64) for h in jg.White._row_hashes(Xd)]
        np.testing.assert_array_equal(ht, hj)


def test_float32_inputs_keep_float32(rng):
    tk = tg.parse_kernel(KERNEL_STRINGS[-1])
    X = torch.tensor(rng.standard_normal((7, 3)), dtype=torch.float32)
    assert tg.gram(tk, X).dtype == torch.float32
    assert tk(X[0], X[1]).dtype == torch.float32
    assert tk._eval(X, X).dtype == torch.float32


def test_gaussian_rejects_non_positive():
    with pytest.raises(ValueError):
        tg.Gaussian(0.0)
    with pytest.raises(ValueError):
        tg.Gaussian(1.0, float("nan"))


def test_general_kernel_matches_jax(rng):
    params = [1.1, 2.0, 0.7, 1.3, 0.9, 1.7, 2.1, 0.8, 1.5, 2.5, 0.6, 1.9, 0.05]
    kj, kt = jg.get_general_kernel(params), tg.get_general_kernel(params)
    assert kt.to_string() == kj.to_string()
    X = rng.standard_normal((30, 3))
    np.testing.assert_allclose(tg.gram(kt, torch.tensor(X)).numpy(), np.asarray(jg.gram(kj, X)),
                               rtol=TOL, atol=TOL)
    assert kt.num_params == 13
    with pytest.raises(ValueError, match="Wrong number"):
        tg.get_general_kernel(params[:12])


def test_white_gram_under_vmap_matches_its_hashes():
    """A fleet member under torch.func.vmap compares rows element by element
    (the card's torch has no batching rule for the hashes' bit view); the
    result equals the hashed Gram, repeated rows, a NaN row and -0.0 included."""
    from gpr_tpu_torch.kernels import kernels as km

    X = torch.tensor(np.random.default_rng(0).standard_normal((4, 16, 3)))
    X[:, 5] = X[:, 2]
    X[2, 3, 0] = float("nan")
    X[2, 4] = X[2, 3]
    X[3, 0, 1] = -0.0
    X[3, 1] = X[3, 0]
    X[3, 1, 1] = 0.0
    k = tg.Sum(tg.Gaussian(1.5, 1.0), tg.White(0.3))
    batched = km.fleet_map(km.gram, k, False, X)
    one_by_one = torch.stack([km.gram(k, x) for x in X])
    assert torch.equal(torch.nan_to_num(batched, nan=-1.0), torch.nan_to_num(one_by_one, nan=-1.0))
