"""The port's learn -> predict apps (gpr_tpu_torch.apps) against gpr_tpu's,
on the CPU in float64 (the ``parity`` policy; ``main(..., device="cpu")``).

Both packages' apps run on the same synthetic datasets, tests/test_apps.py's
(exact and ``sparse_inducing`` modes) and tests/test_ar_pipeline.py's
(``perform_ar``), each into its own prefix and result folder.  The
predicted DVFs (``dfPred*.vtk``) and the credible intervals are held to
JAX's at rtol 1e-8.  The model artifacts are held at rtol 1e-8 up to the
signs PCA leaves free: a feature's sign flips its row of SampleVectors /
LabelVectors (its column of Z, alpha and RegressionVectors) and a column of
U, and leaves CoreMatrix, R, Lmm, the DVFs and the intervals unchanged.  A
model that JAX learned is also predicted by the port's app.
"""

import json
import os

import numpy as np
import pytest
import torch

from gpr_tpu.apps import learn as jlearn
from gpr_tpu.apps import predict as jpredict
from gpr_tpu.pipeline import imageio as jio
from gpr_tpu_torch.apps import learn as tlearn
from gpr_tpu_torch.apps import predict as tpredict
from gpr_tpu_torch.utils import config, matrixio

from test_apps import CONFIG_LEARN, CONFIG_MODEL, CONFIG_PREDICT, synthetic_dataset  # noqa: F401
from test_ar_pipeline import ar_dataset  # noqa: F401
from test_torch_hmc import _one_torch_thread  # noqa: F401

RTOL = 1e-8


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * max(np.abs(b).max(), 1e-300))


def _signs(a, b, axis):
    s = np.sign((np.asarray(a) * np.asarray(b)).sum(axis))
    return np.where(s == 0, 1.0, s)


def _json(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f)
    return str(path)


def _csv_row(path):
    with open(path) as f:
        return np.array([float(v) for v in f.read().split(",") if v.strip()])


def _run_both(tmp_path, cm, cl, cp, learn_dirs, predict_dirs, ref_file):
    """Learn and predict with both packages; returns {package: (prefix, result dir)}."""
    cm, cl, cp = (_json(tmp_path / f"{n}.json", c) for n, c in (("cm", cm), ("cl", cl), ("cp", cp)))
    runs = {}
    for name, learn, predict, kw in (("jax", jlearn, jpredict, {}),
                                     ("port", tlearn, tpredict, {"device": "cpu"})):
        prefix, results = str(tmp_path / name), tmp_path / f"results-{name}"
        results.mkdir()
        assert learn.main([cm, cl, prefix, *learn_dirs], **kw) == 0
        assert predict.main([cm, cp, prefix, *predict_dirs, str(results), ref_file], **kw) == 0
        runs[name] = (prefix, results)
    return runs


def _check_predictions(runs, count):
    (pj, rj), (pt, rt) = runs["jax"], runs["port"]
    names = sorted(os.listdir(rt))
    assert names == sorted(os.listdir(rj)) == [f"dfPred{i:05d}.vtk" for i in range(count)]
    for name in names:
        got, want = jio.read_image(str(rt / name)), jio.read_image(str(rj / name))
        assert got.ncomponents == want.ncomponents == 3
        _close(got.data, want.data)
    _close(_csv_row(pt + "-credibleInterval.csv"), _csv_row(pj + "-credibleInterval.csv"))
    for suffix in ("-latestInferenceTime.txt", "-latestCompTimePCA.txt"):
        times = _csv_row(pt + suffix)
        assert times.shape == _csv_row(pj + suffix).shape and (times > 0).all()


def _check_pca(pt, pj):
    for side in ("-input", "-output"):
        read = {k: [matrixio.read_matrix(p + side + k) for p in (pt, pj)]
                for k in ("Mean.bin", "Sigma.bin", "U.bin")}
        _close(*read["Mean.bin"])
        sig_t, sig_j = read["Sigma.bin"]
        U_t, U_j = read["U.bin"]
        k = int((sig_j[:, 0] > 1e-6 * sig_j[0, 0]).sum())  # the modes above the null value
        _close(sig_t[:k], sig_j[:k])
        _close(U_t[:, :k] * _signs(U_t[:, :k], U_j[:, :k], 0), U_j[:, :k])


def _model_signs(pt, pj):
    # each feature's sign: input features are SampleVectors' rows, output
    # features LabelVectors' rows
    read = {s: [matrixio.read_matrix(p + s) for p in (pt, pj)]
            for s in ("-SampleVectors.txt", "-LabelVectors.txt")}
    return {s: (a, b, _signs(a, b, 1)) for s, (a, b) in read.items()}


def test_exact_mode_matches_jax(synthetic_dataset, tmp_path):  # noqa: F811
    root, paths = synthetic_dataset
    ref = os.path.join(paths["train"][1], sorted(os.listdir(paths["train"][1]))[0])
    with config.policy_scope("parity"):
        runs = _run_both(tmp_path, CONFIG_MODEL, CONFIG_LEARN, CONFIG_PREDICT, paths["train"],
                         paths["test"], ref)
    _check_predictions(runs, 10)
    (pj, _), (pt, _) = runs["jax"], runs["port"]
    _check_pca(pt, pj)
    signs = _model_signs(pt, pj)
    for a, b, s in signs.values():
        _close(a * s[:, None], b)
    alpha_t, alpha_j = (matrixio.read_matrix(p + "-RegressionVectors.txt") for p in (pt, pj))
    _close(alpha_t * signs["-LabelVectors.txt"][2][None, :], alpha_j)
    _close(*(matrixio.read_matrix(p + "-CoreMatrix.txt") for p in (pt, pj)))
    with open(pt + "-ParameterFile.txt") as f, open(pj + "-ParameterFile.txt") as g:
        assert f.read() == g.read()
    for suffix in ("-inputFeatures.csv", "-outputCompactness.csv", "-inputMean.vtk",
                   "-outputBasis003.vtk", "-inputFeatures_prediction.csv",
                   "-outputFeatures_prediction.csv", "-groundtruthFeatures_prediction.csv"):
        assert os.path.exists(pt + suffix), suffix


def test_sparse_mode_matches_jax(synthetic_dataset, tmp_path):  # noqa: F811
    root, paths = synthetic_dataset
    ref = os.path.join(paths["train"][1], sorted(os.listdir(paths["train"][1]))[0])
    with config.policy_scope("parity"):
        runs = _run_both(tmp_path, dict(CONFIG_MODEL, sparse_inducing=12), CONFIG_LEARN, CONFIG_PREDICT,
                         paths["train"], paths["test"], ref)
    _check_predictions(runs, 10)
    (pj, _), (pt, _) = runs["jax"], runs["port"]
    assert not os.path.exists(pt + "-RegressionVectors.txt")
    with np.load(pt + "-sparse.npz") as t, np.load(pj + "-sparse.npz") as j:
        assert str(t["kernel_string"]) == str(j["kernel_string"])
        s_in = _signs(t["X"], j["X"], 0)  # one sign a input feature (a column of X and Z)
        s_out = _signs(t["Y"], j["Y"], 0)
        _close(t["X"] * s_in, j["X"])
        _close(t["Z"] * s_in, j["Z"])
        _close(t["alpha"] * s_out, j["alpha"])
        for key in ("R", "Lmm", "sigma", "jitter"):
            _close(t[key], j[key])


def test_ar_mode_matches_jax(ar_dataset, tmp_path):  # noqa: F811
    root, dirs, cm, cl, cp = ar_dataset
    with config.policy_scope("parity"):
        runs = _run_both(tmp_path, cm, cl, cp,
                         [str(dirs["us_train"]), str(dirs["dvf_train"]), str(root / "ar")],
                         [str(dirs["us_test"]), str(dirs["dvf_test"])],
                         str(dirs["dvf_train"] / "df00000.vtk"))
    _check_predictions(runs, 6)
    (pj, _), (pt, _) = runs["jax"], runs["port"]
    _check_pca(pt, pj)
    theta_t, theta_j = (matrixio.read_matrix(p + "-arModel.bin") for p in (pt, pj))
    _close(theta_t, theta_j)  # per-feature least squares: invariant to the feature's sign


def test_port_predicts_a_model_jax_learned(synthetic_dataset, tmp_path):  # noqa: F811
    root, paths = synthetic_dataset
    ref = os.path.join(paths["train"][1], sorted(os.listdir(paths["train"][1]))[0])
    cm, cl, cp = (_json(tmp_path / f"{n}.json", c)
                  for n, c in (("cm", CONFIG_MODEL), ("cl", CONFIG_LEARN), ("cp", CONFIG_PREDICT)))
    prefix = str(tmp_path / "jax")
    assert jlearn.main([cm, cl, prefix, *paths["train"]]) == 0
    (tmp_path / "rj").mkdir()
    (tmp_path / "rt").mkdir()
    assert jpredict.main([cm, cp, prefix, *paths["test"], str(tmp_path / "rj"), ref]) == 0
    with config.policy_scope("parity"):
        assert tpredict.main([cm, cp, prefix, *paths["test"], str(tmp_path / "rt"), ref],
                             device="cpu") == 0
    for i in range(10):
        got = jio.read_image(str(tmp_path / "rt" / f"dfPred{i:05d}.vtk"))
        want = jio.read_image(str(tmp_path / "rj" / f"dfPred{i:05d}.vtk"))
        _close(got.data, want.data)


def test_apps_keep_the_cli_contract_and_default_to_the_card(tmp_path):
    assert tlearn.main(["only", "two"]) == -1
    assert tpredict.main(["a"] * 6) == -1
    cm = _json(tmp_path / "cm.json", CONFIG_MODEL)
    cl = _json(tmp_path / "cl.json", CONFIG_LEARN)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tlearn.main([cm, cl, str(tmp_path / "p"), str(tmp_path), str(tmp_path)])
    # a missing folder is the app's error, not an exception
    assert tlearn.main([cm, cl, str(tmp_path / "p"), str(tmp_path / "none"), str(tmp_path / "none")],
                       device="cpu") == -1
