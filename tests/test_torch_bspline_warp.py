"""The port's B-spline resampling and warping (gpr_tpu_torch.pipeline.bspline,
.warp) against gpr_tpu's and scipy.ndimage, on the CPU in float64.

Tolerance: 1e-10 relative to the largest magnitude of the reference.  Both
sides sum the same taps in float64; the port's prefilter is one product with
the filter matrix where JAX runs the recursion (both ~1e-16 from scipy).
Shapes are 1-D, 2-D and 3-D with axes of length 1 and 2 (the spline's and
the modes' special cases).  At orders 0-1 the port's map_coordinates holds
to JAX's in all five modes; to scipy's where scipy's mode is the same
function ('nearest', 'mirror', 'reflect'; at order 1 JAX's 'wrap' and
'constant' are scipy's 'grid-wrap' and 'grid-constant'), with coordinates
off the half-integers at order 0 (scipy rounds halves up, JAX away from
zero).  The order-3 mode check is the port's own (warp.py:54-58 ignores the
mode): no test compares order 3 under an explicit non-mirror mode.
"""

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch
import jax

from gpr_tpu.pipeline import bspline as jbs
from gpr_tpu.pipeline import imageio as jio
from gpr_tpu.pipeline import warp as jwarp
from gpr_tpu_torch.pipeline import bspline as tbs
from gpr_tpu_torch.pipeline import imageio as tio
from gpr_tpu_torch.pipeline import warp as twarp

from test_torch_hmc import _one_torch_thread  # noqa: F401

RTOL = 1e-10
SHAPES = [(7,), (1, 5), (2, 1, 4), (5, 4, 3)]
MODES = ("constant", "nearest", "wrap", "mirror", "reflect")
SCIPY_MODE = {"nearest": "nearest", "mirror": "mirror", "reflect": "reflect",
              "wrap": "grid-wrap", "constant": "grid-constant"}


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-300))


def _case(shape, seed):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal(shape)
    coords = [rng.uniform(-3.0, s + 2.0, (4, 5)) for s in shape]
    return img, coords


def _t(coords):
    return [torch.tensor(c) for c in coords]


@pytest.mark.parametrize("shape", SHAPES)
def test_spline_filter_matches_jax_and_scipy(shape):
    img, _ = _case(shape, 1)
    got = tbs.spline_filter(img, device="cpu")
    _close(got, jbs.spline_filter(img))
    _close(got, ndi.spline_filter(img, order=3, mode="mirror"))


@pytest.mark.parametrize("shape", SHAPES)
def test_map_coordinates_cubic_matches_jax_and_scipy(shape):
    img, coords = _case(shape, 2)
    got = tbs.map_coordinates_cubic(img, _t(coords), device="cpu")
    _close(got, jbs.map_coordinates_cubic(img, coords))
    _close(got, ndi.map_coordinates(img, coords, order=3, mode="mirror"))
    coef = tbs.spline_filter(img, device="cpu")
    _close(tbs.map_coordinates_cubic(coef, _t(coords), prefilter=False), got)


def test_mirror_index_and_cubic_weights():
    i = np.arange(-9, 12)
    for n in (1, 2, 5):
        np.testing.assert_array_equal(tbs._mirror_index(torch.tensor(i), n).numpy(),
                                      np.asarray(jbs._mirror_index(jax.numpy.asarray(i), n)))
    f = np.linspace(0.0, 0.999, 17)
    for got, want in zip(tbs._cubic_weights(torch.tensor(f)), jbs._cubic_weights(f)):
        _close(got, want)
    assert sum(w.numpy() for w in tbs._cubic_weights(torch.tensor(f))) == pytest.approx(1.0)


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("mode", MODES)
def test_map_coordinates_matches_jax(order, mode):
    for k, shape in enumerate(SHAPES):
        img, coords = _case(shape, 10 + k)
        if order == 0:  # half-integers, where the two roundings differ
            coords = [np.round(2 * c) / 2 for c in coords]
        got = twarp.map_coordinates(img, _t(coords), order, mode, device="cpu")
        _close(got, jax.scipy.ndimage.map_coordinates(img, coords, order, mode))
        if order == 1 or mode in ("nearest", "mirror", "reflect"):
            if order == 0:
                coords = [c + 0.25 for c in coords]
                got = twarp.map_coordinates(img, _t(coords), order, mode, device="cpu")
            _close(got, ndi.map_coordinates(img, coords, order=order, mode=SCIPY_MODE[mode]))


def test_order_0_rounds_half_away_from_zero():
    img = np.arange(8.0)
    c = np.array([0.5, 1.5, 2.5, -0.5, 3.5, 6.5])
    got = twarp.map_coordinates(img, [torch.tensor(c)], 0, "nearest", device="cpu")
    np.testing.assert_array_equal(got.numpy(), [1.0, 2.0, 3.0, 0.0, 4.0, 7.0])
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax.scipy.ndimage.map_coordinates(img, [c], 0, "nearest")))
    np.testing.assert_array_equal(twarp._round_half_away_from_zero(torch.tensor(c)).numpy(),
                                  [1.0, 2.0, 3.0, -1.0, 4.0, 7.0])


@pytest.mark.parametrize("order", [0, 1, 3])
def test_warp_array_matches_jax(order):
    # order 3 at the 3-D shape only: map_coordinates_cubic's tests take the others
    rng = np.random.default_rng(20 + order)
    cases = (((5, 6, 7), (1.0, 2.0, 0.5)), ((9, 8), None))
    for shape, spacing in cases[:1] if order == 3 else cases:
        img = rng.standard_normal(shape)
        disp = rng.uniform(-2.0, 2.0, shape + (len(shape),))
        if order == 0:
            disp = np.round(2 * disp) / 2
        got = twarp.warp_array(img, disp, spacing=spacing, order=order, device="cpu")
        _close(got, jwarp.warp_array(img, disp, spacing=spacing, order=order))
        for mode in ("mirror", "reflect", "wrap", "constant") if order < 3 and len(shape) == 3 else ():
            got = twarp.warp_array(img, disp, spacing=spacing, order=order, mode=mode, device="cpu")
            _close(got, jwarp.warp_array(img, disp, spacing=spacing, order=order, mode=mode))


def test_warp_array_order_3_against_scipy():
    rng = np.random.default_rng(30)
    img = rng.standard_normal((8, 9, 7))
    disp = rng.uniform(-3.0, 3.0, (8, 9, 7, 3))
    grid = np.meshgrid(*[np.arange(s, dtype=np.float64) for s in img.shape], indexing="ij")
    coords = [grid[ax] + disp[..., 2 - ax] for ax in range(3)]
    want = ndi.map_coordinates(img, coords, order=3, mode="mirror")
    for mode in (None, "mirror"):
        _close(twarp.warp_array(img, disp, order=3, mode=mode, device="cpu"), want)


@pytest.mark.parametrize("mode", ["nearest", "constant", "wrap", "reflect"])
def test_warp_array_order_3_refuses_other_modes(mode):
    img = np.zeros((4, 5))
    with pytest.raises(ValueError, match="mirror"):
        twarp.warp_array(img, np.zeros((4, 5, 2)), order=3, mode=mode, device="cpu")


def test_warp_image_magnitude_and_diff():
    rng = np.random.default_rng(40)
    img = rng.uniform(0, 255, (5, 6, 7))
    field = rng.uniform(-1.5, 1.5, (5, 6, 7, 3))
    spacing, origin = (1.0, 0.5, 2.0), (1.0, -2.0, 0.5)
    t_img, t_df = tio.Image(img, spacing, origin), tio.Image(field, spacing, origin, ncomponents=3)
    j_img, j_df = jio.Image(img, spacing, origin), jio.Image(field, spacing, origin, ncomponents=3)
    for order in (1, 3):
        got = twarp.warp_image(t_img, t_df, order=order, device="cpu")
        want = jwarp.warp_image(j_img, j_df, order=order)
        _close(got.data, want.data)
        assert (got.spacing, got.origin, got.ncomponents) == (tuple(want.spacing), tuple(want.origin), 1)
    np.testing.assert_array_equal(twarp.displacement_magnitude(t_df), jwarp.displacement_magnitude(j_df))
    other = rng.uniform(-1, 1, field.shape)
    d_t = twarp.diff_image(t_df, tio.Image(other, spacing, origin, ncomponents=3))
    d_j = jwarp.diff_image(j_df, jio.Image(other, spacing, origin, ncomponents=3))
    np.testing.assert_array_equal(d_t.data, d_j.data)
    assert d_t.ncomponents == 3
    with pytest.raises(ValueError, match="vector"):
        twarp.warp_image(t_img, t_img, device="cpu")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twarp.warp_array(np.zeros((3, 3)), np.zeros((3, 3, 2)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbs.spline_filter(np.zeros(4))
