"""The port's feature pipeline (gpr_tpu_torch.pipeline: PCA, AR, the data
parser, image I/O) against gpr_tpu's, on the CPU in float64.

PCA: both branches of ``fit_pca`` (the thin SVD and the Gram trick, reached
by a small ``gram_threshold``) on data with a distinct spectrum (adjacent
singular values at least 20 % apart).  An eigensolver may return a basis
column with either sign, so U is compared up to one sign a column and the
features up to one sign a row; the mean, sigma, the reconstruction and the
explained variance are compared as they are, at rtol 1e-10.  The centered
matrix's last singular value is zero in exact arithmetic; the Gram trick
gives it as the root of a rounding-level eigenvalue, ~sqrt(eps) sigma_max,
so that entry is held to 1e-7 sigma_max, its basis column is not compared,
and the explained variance (whose total holds it) is held at 1e-7.  AR: the
design exactly, theta (a rank-deficient design too) and the rollouts at
rtol 1e-10.  The data parser's features, trained and
predicted with and without AR, under the ``parity`` policy, against JAX's up
to a sign a feature row, and the precomputed caches against the parsed
features within the CSV's 6 decimals.  The image codecs read each other's
files bit for bit.
"""

import numpy as np
import pytest
import torch

from gpr_tpu.pipeline import autoregression as jar
from gpr_tpu.pipeline import dataparser as jdp
from gpr_tpu.pipeline import imageio as jio
from gpr_tpu.pipeline import pca as jpca
from gpr_tpu_torch import convert
from gpr_tpu_torch.pipeline import autoregression as tar
from gpr_tpu_torch.pipeline import dataparser as tdp
from gpr_tpu_torch.pipeline import imageio as tio
from gpr_tpu_torch.pipeline import pca as tpca
from gpr_tpu_torch.utils import config

from test_apps import CONFIG_LEARN, CONFIG_MODEL, CONFIG_PREDICT, synthetic_dataset  # noqa: F401
from test_ar_pipeline import ar_dataset  # noqa: F401
from test_torch_hmc import _one_torch_thread  # noqa: F401

RTOL = 1e-10


def _close(a, b, rtol=RTOL):
    a = np.asarray(a.detach() if isinstance(a, torch.Tensor) else a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * max(np.abs(b).max(), 1e-300))


def _signs(a, b, axis):
    # +-1 per column (axis 0) or row (axis 1) that turns a towards b
    s = np.sign((np.asarray(a) * np.asarray(b)).sum(axis))
    return np.where(s == 0, 1.0, s)


def _pca_data(d, N, seed=0):
    """(d, N) data with singular values 8 * 0.75^k around a nonzero mean."""
    rng = np.random.default_rng(seed)
    r = min(d, N)
    U, _ = np.linalg.qr(rng.standard_normal((d, r)))
    V, _ = np.linalg.qr(rng.standard_normal((N, r)))
    return (U * (8.0 * 0.75 ** np.arange(r))) @ V.T + rng.standard_normal(d)[:, None]


@pytest.mark.parametrize("d,N,threshold,branch", [(40, 12, 4096, "svd"), (40, 12, 8, "gram"),
                                                  (9, 30, 4096, "svd")])
def test_fit_pca_matches_jax_up_to_column_sign(d, N, threshold, branch):
    X = _pca_data(d, N)
    jm = jpca.fit_pca(X, gram_threshold=threshold)
    tm = tpca.fit_pca(X, gram_threshold=threshold, device="cpu")
    r = tm.num_modes
    assert r == min(d, N) and (branch == "gram") == (d > N and d > threshold)
    js, ts = np.asarray(jm.sigma), tm.sigma.numpy()
    assert (np.diff(js[: r - 1]) < -0.2 * js[1:r - 1]).all()  # a distinct spectrum
    _close(tm.mean, jm.mean)
    full = r - 1 if N <= d else r  # centering leaves N - 1 nonzero values
    _close(ts[:full], js[:full])
    assert abs(ts[-1] - js[-1]) <= 1e-7 * js[0]
    U, jU = tm.U.numpy()[:, :full], np.asarray(jm.U)[:, :full]
    _close(U * _signs(U, jU, 0), jU)
    # features flip with their column; the reconstruction does not
    F, jF = tm.reduce(X, 3).numpy(), np.asarray(jm.reduce(X, 3))
    _close(F * _signs(F, jF, 1)[:, None], jF)
    _close(tm.reconstruct(tm.reduce(X, 3)), jm.reconstruct(jm.reduce(X, 3)))
    _close(tm.reconstruct(tm.reduce(X)[:, 0]), jm.reconstruct(jm.reduce(X)[:, 0]), 1e-8)
    # the null value enters the spectrum's total: 1e-7 sigma_max of ~3 sigma_max
    _close(tm.explained_variance(), jm.explained_variance(), 1e-7)
    for t in (0.5, 0.9, 0.99):
        assert tm.modes_for_compactness(t) == jm.modes_for_compactness(t)
    # the zero-singular-value guard: a zero column, never inf / NaN
    B = tpca.PCAModel(tm.mean, torch.cat([tm.sigma[:-1], tm.sigma.new_zeros(1)]), tm.U).basis()
    assert torch.isfinite(B).all() and (B[:, -1] == 0).all()


def test_pca_artifacts_and_converter_across_packages(tmp_path):
    X = _pca_data(30, 10, seed=1)
    jm = jpca.fit_pca(X)
    jm.save(str(tmp_path / "jax-"))
    tm = tpca.load_pca(str(tmp_path / "jax-"), device="cpu")
    conv = convert.pca_from_numpy(np.asarray(jm.mean), np.asarray(jm.sigma), np.asarray(jm.U),
                                  device="cpu")
    for model in (tm, conv):
        for key in ("mean", "sigma", "U"):
            np.testing.assert_array_equal(getattr(model, key).numpy(), np.asarray(getattr(jm, key)))
        _close(model.reduce(X, 4), jm.reduce(X, 4), 1e-12)
        _close(model.basis(4), jm.basis(4), 1e-14)
    tm.save(str(tmp_path / "port-"))
    back = jpca.load_pca(str(tmp_path / "port-"))
    for key in ("mean", "sigma", "U"):
        np.testing.assert_array_equal(np.asarray(getattr(back, key)), np.asarray(getattr(jm, key)))
    f32 = tpca.load_pca(str(tmp_path / "port-"), np.float32, "cpu")
    assert f32.U.dtype == torch.float32


def _series(T=24, F=3, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(T)[:, None]
    return np.sin(0.4 * t + rng.uniform(0, 3, F)) + 0.05 * rng.standard_normal((T, F))


@pytest.mark.parametrize("p,batches", [(3, [(6, 4)]), (2, None), (4, [(3, 2), (6, 3)]),
                                       (5, [(8, 3)])])
def test_ar_design_fit_and_rollouts_match_jax(p, batches):
    # (4, [(3, 2), (6, 3)]): batches shorter than p give zero columns, a
    # rank-deficient design solved for the minimum-norm theta
    T = 24
    X = _series(T)
    D, Y = tar.build_design(X, p, batches, device="cpu")
    jD, jY = jar.build_design(X, p, batches)
    np.testing.assert_array_equal(D.numpy(), np.asarray(jD))
    np.testing.assert_array_equal(Y.numpy(), np.asarray(jY))
    theta = tar.fit_ar(X, p, batches, device="cpu")
    jtheta = jar.fit_ar(X, p, batches)
    _close(theta, jtheta)
    for n in (1, 3):
        for one in (None, False, True):
            _close(tar.predict_ar(X, theta, n, batches, one, device="cpu"),
                   jar.predict_ar(X, jtheta, n, batches, one))


def test_ar_model_file_across_packages(tmp_path):
    X = _series()
    jtheta = jar.fit_ar(X, 3, [(6, 4)])
    jar.save_ar(jtheta, str(tmp_path / "jax.bin"))
    theta = tar.load_ar(str(tmp_path / "jax.bin"), device="cpu")
    np.testing.assert_array_equal(theta.numpy(), np.asarray(jtheta))
    tar.save_ar(theta, str(tmp_path / "port.bin"))
    np.testing.assert_array_equal(np.asarray(jar.load_ar(str(tmp_path / "port.bin"))), np.asarray(jtheta))
    with pytest.raises(ValueError, match="Batch parameters"):
        tar.fit_ar(X, 3, [(5, 4)], device="cpu")


def _rows_close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    _close(a * _signs(a, b, 1)[:, None], b, rtol)


def _features(parser):
    return np.stack([x for x, _ in parser.get_training_data()], 1), parser.output_features


def test_dataparser_features_match_jax(synthetic_dataset, tmp_path):  # noqa: F811
    root, paths = synthetic_dataset
    us_train, dvf_train = paths["train"]
    us_test, dvf_test = paths["test"]
    pj, pt = str(tmp_path / "jax"), str(tmp_path / "port")
    jparser = jdp.DataParser.for_training(us_train, dvf_train, "", pj, CONFIG_MODEL, CONFIG_LEARN)
    jin, jout = _features(jparser)
    with config.policy_scope("parity"):
        tparser = tdp.DataParser.for_training(us_train, dvf_train, "", pt, CONFIG_MODEL, CONFIG_LEARN,
                                              device="cpu")
        tin, tout = _features(tparser)
        assert tin.dtype == np.float64
        _rows_close(tin, jin)
        _rows_close(tout, jout)
        # the caches: the port reads its own and JAX's precomputed features
        cached = dict(CONFIG_LEARN, use_precomputed=True)
        for prefix in (pt, pj):
            cin, cout = _features(tdp.DataParser.for_training(us_train, dvf_train, "", prefix,
                                                              CONFIG_MODEL, cached, device="cpu"))
            np.testing.assert_allclose(cin, tin if prefix == pt else jin, atol=2e-6)
            np.testing.assert_allclose(cout, tout if prefix == pt else jout, atol=2e-6)
        # prediction features, from the port's artifacts and from JAX's
        cfg = dict(CONFIG_PREDICT, compute_groundtruth_features=True)
        jpred = jdp.DataParser.for_prediction(us_test, dvf_test, pj, CONFIG_MODEL, cfg)
        jv = np.stack(jpred.get_test_data(), 1)
        tpred = tdp.DataParser.for_prediction(us_test, dvf_test, pt, CONFIG_MODEL, cfg, device="cpu")
        _rows_close(np.stack(tpred.get_test_data(), 1), jv)
        _rows_close(tpred.output_features, jpred.output_features)
        xpred = tdp.DataParser.for_prediction(us_test, dvf_test, pj, CONFIG_MODEL, cfg, device="cpu")
        _close(np.stack(xpred.get_test_data(), 1), jv)
        _close(xpred.output_features, jpred.output_features)
        again = tdp.DataParser.for_prediction(us_test, dvf_test, pt, CONFIG_MODEL,
                                              dict(cfg, use_precomputed=True), device="cpu")
        np.testing.assert_allclose(np.stack(again.get_test_data(), 1),
                                   np.stack(tpred.get_test_data(), 1), atol=2e-6)
        # the reconstruction from predicted features, from JAX's basis
        F = jv[: CONFIG_MODEL["n_outputModes"]]
        _close(np.stack(xpred.get_results(list(F.T)), 1), np.stack(jpred.get_results(list(F.T)), 1))
    for name in ("-inputMean.vtk", "-outputBasis000.vtk", "-inputCompactness.csv", "-outputFeatures.csv"):
        assert (tmp_path / ("port" + name)).exists(), name


def test_dataparser_ar_features_match_jax(ar_dataset, tmp_path):  # noqa: F811
    root, dirs, cm, cl, cp = ar_dataset
    ar = str(root / "ar")
    pj, pt = str(tmp_path / "jax"), str(tmp_path / "port")
    jin, jout = _features(jdp.DataParser.for_training(str(dirs["us_train"]), str(dirs["dvf_train"]),
                                                      ar, pj, cm, cl))
    with config.policy_scope("parity"):
        tin, tout = _features(tdp.DataParser.for_training(str(dirs["us_train"]), str(dirs["dvf_train"]),
                                                          ar, pt, cm, cl, device="cpu"))
        _rows_close(tin, jin)
        _rows_close(tout, jout)
        _rows_close(jdp.read_csv(pt + "-arModel.csv").T, jdp.read_csv(pj + "-arModel.csv").T, 1e-5)
        cin, _ = _features(tdp.DataParser.for_training(str(dirs["us_train"]), str(dirs["dvf_train"]), ar,
                                                       pt, cm, dict(cl, use_precomputed=True),
                                                       device="cpu"))
        np.testing.assert_allclose(cin, tin, atol=1e-5)  # the AR rollout of 6-decimal features
        jv = np.stack(jdp.DataParser.for_prediction(str(dirs["us_test"]), str(dirs["dvf_test"]), pj, cm,
                                                    cp).get_test_data(), 1)
        tv = np.stack(tdp.DataParser.for_prediction(str(dirs["us_test"]), str(dirs["dvf_test"]), pj, cm,
                                                    cp, device="cpu").get_test_data(), 1)
        _close(tv, jv)


@pytest.mark.parametrize("ext,kw,shape,ncomp", [(".vtk", {}, (3, 4, 5), 1),
                                                (".vtk", {"binary": False}, (4, 5), 1),
                                                (".vtk", {}, (2, 3, 4, 3), 3),
                                                (".mha", {}, (3, 4, 5), 1),
                                                (".mha", {"compressed": True}, (2, 3, 4, 3), 3)])
def test_image_codecs_read_each_others_files(tmp_path, ext, kw, shape, ncomp):
    data = np.random.default_rng(9).standard_normal(shape).astype(np.float32)
    spacing, origin = (0.5, 1.0, 2.0), (1.0, -2.0, 0.5)
    writers = {".vtk": (jio.write_vtk, tio.write_vtk), ".mha": (jio.write_mha, tio.write_mha)}[ext]
    jw, tw = writers
    jw(jio.Image(data, spacing, origin, ncomp), str(tmp_path / ("jax" + ext)), **kw)
    tw(tio.Image(data, spacing, origin, ncomp), str(tmp_path / ("port" + ext)), **kw)
    assert (tmp_path / ("jax" + ext)).read_bytes() == (tmp_path / ("port" + ext)).read_bytes()
    got = tio.read_image(str(tmp_path / ("jax" + ext)))
    want = jio.read_image(str(tmp_path / ("jax" + ext)))
    np.testing.assert_array_equal(got.data, want.data)
    assert (got.spacing, got.origin, got.ncomponents) == (want.spacing, want.origin, want.ncomponents)
    np.testing.assert_array_equal(got.flatten(), want.flatten())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_csv_bytes_match_jax(tmp_path, dtype):
    M = np.random.default_rng(10).standard_normal((3, 7)).astype(dtype)
    M[0, :5] = [-0.0, np.nan, 1e30, 5e-7, -5e-7]
    jdp.write_csv(str(tmp_path / "jax.csv"), M)
    tdp.write_csv(str(tmp_path / "port.csv"), M)
    assert (tmp_path / "jax.csv").read_bytes() == (tmp_path / "port.csv").read_bytes()
    np.testing.assert_array_equal(tdp.read_csv(str(tmp_path / "port.csv")),
                                  jdp.read_csv(str(tmp_path / "jax.csv")))
