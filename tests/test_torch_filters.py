"""The port's image filters (gpr_tpu_torch.pipeline.filters) against
gpr_tpu.pipeline.filters, all 22 public functions, on the CPU in float64.

Tolerance: 1e-12 relative to the largest magnitude of JAX's result.  The
separable convolutions sum the same float32-valued taps in another order
(``conv1d`` against JAX's einsum), ``normalize_image`` takes its standard
deviation by another algorithm; everything else is the same arithmetic.
``histogram_matching`` is held on random images, on a flat histogram (most
pixels one value, so the quantile nodes repeat) and on images whose values
sit on the top bin edge.
"""

import numpy as np
import pytest
import torch

from gpr_tpu.pipeline import filters as jf
from gpr_tpu_torch.pipeline import filters as tf

from test_torch_hmc import _one_torch_thread  # noqa: F401

RTOL = 1e-12


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-300))


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(7)
    flat = np.full((12, 10), 3.0)
    flat[0, :3] = 5.0
    top = rng.uniform(0, 10, (12, 10))
    top[:, -2:] = 10.0  # the top edge: numpy's last bin holds it
    return {
        "a": rng.uniform(0, 255, (9, 12, 10)),
        "b": rng.uniform(-50, 100, (9, 12, 10)),
        "img2d": rng.uniform(0, 255, (13, 11)),
        "flat": flat,
        "top": top,
        "half": np.array([[0.5, 1.5, 2.5], [-0.5, -1.5, 3.2]]),
    }


CASES = {
    "gaussian_smoothing": lambda m, x: m.gaussian_smoothing(x["a"], 2.0),
    "gaussian_smoothing_slices": lambda m, x: m.gaussian_smoothing(x["a"], 4.0, spacing=(1.0, 2.0),
                                                                   axes=(1, 2)),
    "gaussian_smoothing_capped": lambda m, x: m.gaussian_smoothing(x["img2d"], 900.0, max_kernel_width=8),
    "mean_filter": lambda m, x: m.mean_filter(x["a"], 2),
    "mean_filter_axes": lambda m, x: m.mean_filter(x["a"], 1, axes=(0,)),
    "image_variance": lambda m, x: m.image_variance(x["a"], 2.0, x["b"]),
    "image_pyramid": lambda m, x: m.image_pyramid(x["a"], 3),
    "image_pyramid_series": lambda m, x: m.image_pyramid_series(x["a"], 3),
    "pyramid_schedule": lambda m, x: np.array(m.pyramid_schedule(4)),
    "median_filter": lambda m, x: m.median_filter(x["a"], 1),
    "median_filter_2d_r2": lambda m, x: m.median_filter(x["img2d"], 2),
    "histogram_matching": lambda m, x: m.histogram_matching(x["a"], x["b"]),
    "histogram_matching_flat_source": lambda m, x: m.histogram_matching(x["flat"], x["img2d"], levels=64),
    "histogram_matching_flat_reference": lambda m, x: m.histogram_matching(x["img2d"], x["flat"], levels=16),
    "histogram_matching_top_edge": lambda m, x: m.histogram_matching(x["top"], x["top"][::-1] * 2.0,
                                                                     levels=32, match_points=5),
    "threshold_below": lambda m, x: m.threshold_below(x["a"], 100.0),
    "threshold_window": lambda m, x: m.threshold_window(x["a"], 200.0, 50.0),
    "threshold_window_empty": lambda m, x: m.threshold_window(x["a"], -1.0, 300.0),
    "rescale_intensity": lambda m, x: m.rescale_intensity(x["b"], -1.0, 1.0),
    "rescale_intensity_flat": lambda m, x: m.rescale_intensity(np.ones((3, 4)), 0.0, 1.0),
    "shrink_image": lambda m, x: m.shrink_image(x["a"], 3, 2),
    "invert_image": lambda m, x: m.invert_image(x["b"]),
    "round_image": lambda m, x: m.round_image(x["half"]),
    "normalize_image": lambda m, x: m.normalize_image(x["b"]),
    "multiply_images": lambda m, x: m.multiply_images(x["a"], x["b"]),
    "subtract_images": lambda m, x: m.subtract_images(x["a"], x["b"]),
    "multiply_constant": lambda m, x: m.multiply_constant(x["a"], 2.5),
    "abs_difference": lambda m, x: m.abs_difference(x["a"], x["b"]),
    "accumulate_image": lambda m, x: m.accumulate_image(x["a"]),
}


class _OnCpu:
    """``filters`` with ``device="cpu"`` on every call."""

    def __getattr__(self, name):
        fn = getattr(tf, name)
        return fn if name == "pyramid_schedule" else (lambda *a, **k: fn(*a, device="cpu", **k))


@pytest.mark.parametrize("case", sorted(CASES))
def test_filter_matches_jax(case, images):
    got, want = CASES[case](_OnCpu(), images), CASES[case](jf, images)
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
    else:
        _close(got, want)


def test_target_image_and_shuffle(images):
    a = images["a"]
    got, idx = tf.get_target_image_from_series(a, device="cpu")
    want, jidx = jf.get_target_image_from_series(a)
    assert int(idx) == int(jidx)
    _close(got, want)
    perm = np.random.default_rng(8).permutation(a.shape[0])
    _close(tf.shuffle_image_data(a, perm, device="cpu"), jf.shuffle_image_data(a, perm))


def test_every_public_function_is_ported():
    names = {n for n in dir(jf) if not n.startswith("_") and callable(getattr(jf, n))
             and getattr(getattr(jf, n), "__module__", "") == jf.__name__}
    assert len(names) == 22
    assert all(callable(getattr(tf, n, None)) for n in names)


def test_normalize_image_takes_the_population_sd():
    x = torch.tensor([1.0, 2.0, 3.0, 4.0], dtype=torch.float64)
    out = tf.normalize_image(x)
    assert float(out.std(correction=0)) == pytest.approx(1.0, rel=1e-15)
    assert float(out.std()) != pytest.approx(1.0, rel=1e-3)


def test_interp_clamps_and_takes_the_left_value_on_repeated_nodes():
    xp = torch.tensor([0.0, 1.0, 1.0, 2.0], dtype=torch.float64)
    fp = torch.tensor([0.0, 10.0, 20.0, 30.0], dtype=torch.float64)
    x = torch.tensor([-1.0, 0.5, 1.0, 1.5, 3.0], dtype=torch.float64)
    np.testing.assert_array_equal(tf._interp(x, xp, fp).numpy(),
                                  np.interp(x.numpy(), xp.numpy(), fp.numpy()))


def test_median_filter_against_scipy():
    from scipy.ndimage import median_filter

    a = np.random.default_rng(9).standard_normal((6, 7, 5))
    np.testing.assert_array_equal(tf.median_filter(a, 1, device="cpu").numpy(),
                                  median_filter(a, size=3, mode="nearest"))
