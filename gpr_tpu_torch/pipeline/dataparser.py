"""Train/predict data pipeline: directory scanning, PCA features, AR.

Mirrors gpr_tpu/pipeline/dataparser.py:38-463, the reference's
``DataParser<T, TIn, TOut>`` (include/DataParser.h:31-812), with the same
artifact contract, so that the reference's validation scripts, the JAX
package and the port read each other's files:

  {prefix}-input / -output prefixes (SetFilePaths, DataParser.h:694-706)
  {prefix}-input{Mean,Sigma,U}.bin                (PCA basis)
  {prefix}-input Features.csv / Compactness.csv   (feature cache + spectrum)
  {prefix}-inputMean.vtk, -inputBasis%03d.vtk     (mean/basis as images)
  {prefix}-arModel.bin / -arModel.csv             (AR model)
  {prefix}-inputFeatures_prediction.csv           (prediction feature cache)
  {prefix}-groundtruthFeatures_prediction.csv

Flattening conventions match the reference bit-for-bit: scalar images are
divided by 255 (DataParser.h:564), displacement fields are interleaved
(x, y, z per voxel — DataParser.h:595-609), and data matrices are
(features, frames) with frames as columns.

Images and CSV files stay numpy.  The PCA and the AR model run in torch on
the parser's ``device`` (the card unless given ``device="cpu"``,
utils/config.py), in ``config.default_dtype()``: float32 under the ``fast``
policy, as JAX's ``jnp.asarray`` makes the parsed float64 matrices float32
without x64; float64 under ``parity``.  Features come back as numpy arrays
of that dtype.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import config
from ..utils.logutils import write_to_log_file
from . import autoregression as armod
from . import imageio
from . import pca as pcamod


# ---------------------------------------------------------------------------
# CSV in the reference's format
# ---------------------------------------------------------------------------

def write_csv(path: str, matrix: np.ndarray) -> None:
    """Comma-separated, 6 fixed decimals per value — the output of C++
    ``std::to_string`` used by the reference (DataParser.h:709-732)."""
    m = np.atleast_2d(np.asarray(matrix))
    # one C-level format a row: the bytes of gpr_tpu/pipeline/dataparser.py:38-44's
    # per-value f-strings, about twice as fast (a full feature cache holds N x N values)
    line = ",".join(["%.6f"] * m.shape[1]) + "\n"
    with open(path, "w") as f:
        for row in m.tolist():
            f.write(line % tuple(row))


def read_csv(path: str) -> np.ndarray:
    """(reference ReadFromCsvFile, DataParser.h:737-752.  NOTE the reference
    maps the row-major value buffer into a column-major Eigen matrix — a
    transpose-and-reshape quirk that only round-trips for the matrices it
    writes itself.  We read plainly row-major, which matches what
    ``write_csv`` produced.)"""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append([float(v) for v in line.split(",")])
    return np.asarray(rows)


def list_files(path: str) -> List[str]:
    """Sorted directory listing (reference ReadFilenames,
    DataParser.h:525-534)."""
    return sorted(
        os.path.join(path, f)
        for f in os.listdir(path)
        if os.path.isfile(os.path.join(path, f))
    )


# ---------------------------------------------------------------------------
# image <-> matrix
# ---------------------------------------------------------------------------

def _native_load(filenames: Sequence[str], scale: float) -> Optional[np.ndarray]:
    """Threaded C++ loader fast path (native/gpr_native.cpp) for directories
    of binary VTK or local-raw MHA frames; None when unavailable or the
    format variant needs the Python codec (ASCII vtk, compressed mha)."""
    from ..utils import native

    if not native.available():
        return None
    try:
        if all(f.endswith(".vtk") for f in filenames):
            return native.load_vtk_dir(list(filenames), scale=scale)
        if all(f.endswith(".mha") for f in filenames):
            return native.load_mha_dir(list(filenames), scale=scale)
    except (IOError, RuntimeError):
        pass
    return None


def parse_image_files(filenames: Sequence[str]) -> np.ndarray:
    """Stack scalar images into a (n_pixels, n_files) matrix with /255
    normalization (reference ParseImageFiles, DataParser.h:536-572)."""
    fast = _native_load(filenames, 1.0 / 255.0)
    if fast is not None:
        return fast
    cols = [
        imageio.read_image(f).flatten().astype(np.float64) / 255.0
        for f in filenames
    ]
    return np.stack(cols, axis=1)


def parse_displacement_files(filenames: Sequence[str]) -> np.ndarray:
    """Stack DVFs into a (n_voxels * n_components, n_files) matrix with
    interleaved components (reference ParseDisplacementFiles,
    DataParser.h:574-613 — component index varies fastest)."""
    fast = _native_load(filenames, 1.0)
    if fast is not None:
        return fast
    cols = [imageio.read_image(f).flatten().astype(np.float64) for f in filenames]
    return np.stack(cols, axis=1)


# ---------------------------------------------------------------------------
# the parser
# ---------------------------------------------------------------------------

class DataParser:
    """Feature pipeline for training and prediction.

    Training ctor args mirror the reference's learn constructor
    (DataParser.h:53-142); prediction mirrors the predict constructor
    (DataParser.h:145-179).  Use the classmethods :meth:`for_training` /
    :meth:`for_prediction`."""

    def __init__(self):
        raise TypeError("use DataParser.for_training / DataParser.for_prediction")

    # -- constructors -------------------------------------------------------

    @classmethod
    def _base(cls, gpr_prefix: str, config_model: dict, device) -> "DataParser":
        self = object.__new__(cls)
        self.device = config.resolve_device(device)
        self.dtype, self.np_dtype = config.default_dtype(), config.default_numpy_dtype()
        self.perform_ar = bool(config_model["perform_ar"])
        self.n_input_modes = int(config_model["n_inputModes"])
        self.n_output_modes = int(config_model["n_outputModes"])
        self.ar_n = int(config_model["ar_n"])
        self.ar_p = int(config_model["ar_p"])
        self.prefix = gpr_prefix
        self.prefix_input = gpr_prefix + "-input"
        self.prefix_output = gpr_prefix + "-output"
        self.log_file = gpr_prefix + "-log_"
        self.compute_gt_features = False
        self.input_files: List[str] = []
        self.output_files: List[str] = []
        self.ar_files_train: List[str] = []
        self.ar_files_test: List[str] = []
        self.input_features: Optional[np.ndarray] = None
        self.output_features: Optional[np.ndarray] = None
        self._predicted_output: Optional[np.ndarray] = None
        self._predicted_features: Optional[np.ndarray] = None
        return self

    @staticmethod
    def _batches(sizes: Sequence[int], reps: Sequence[int]):
        if len(sizes) != len(reps):
            raise ValueError("AR parameters not correctly defined!")
        if len(sizes) == 0:
            raise ValueError("AR parameters empty!")
        return list(zip(sizes, reps))

    @classmethod
    def for_training(
        cls,
        input_path: str,
        output_path: str,
        ar_path: str,
        gpr_prefix: str,
        config_model: dict,
        config_learn: dict,
        device=None,
    ) -> "DataParser":
        self = cls._base(gpr_prefix, config_model, device)
        self.use_precomputed = bool(config_learn["use_precomputed"])
        if self.perform_ar:
            self.batches_train = cls._batches(
                config_learn["ar_batchSizeTrain"], config_learn["ar_batchRepetitionTrain"]
            )
            self.batches_test = cls._batches(
                config_learn["ar_batchSizeTest"], config_learn["ar_batchRepetitionTest"]
            )
            self.batches = cls._batches(
                config_learn["ar_batchSize"], config_learn["ar_batchRepetition"]
            )
            self.one_pred_per_batch_test = bool(
                config_learn["ar_onePredictionPerBatchTest"]
            )
            self.one_pred_per_batch = bool(config_learn["ar_onePredictionPerBatch"])
        else:
            self.batches = self.batches_train = self.batches_test = []
            self.one_pred_per_batch = self.one_pred_per_batch_test = False

        self.input_files = list_files(input_path)
        self.output_files = list_files(output_path)
        if self.perform_ar:
            self.ar_files_train = list_files(os.path.join(ar_path, "train"))
            self.ar_files_test = list_files(os.path.join(ar_path, "test"))

        # drift-analysis training-window subset (reference DataParser.h:114-141)
        n_train = int(config_learn.get("n_trainImgs", 0))
        start = int(config_learn.get("start_trainInd", 0))
        if n_train != 0:
            end = start + n_train - 1
            write_to_log_file(
                self.log_file,
                f"\tOnly a subset of the training data is considered: "
                f"indStart: {start} indEnd: {end} nImgs: {n_train}",
            )
            if self.perform_ar:
                self.input_files = self.input_files[
                    start * self.ar_p : (end + 1) * self.ar_p
                ]
            else:
                self.input_files = self.input_files[start : end + 1]
            self.output_files = self.output_files[start : end + 1]
        return self

    @classmethod
    def for_prediction(
        cls,
        input_path: str,
        groundtruth_path: str,
        gpr_prefix: str,
        config_model: dict,
        config_predict: dict,
        device=None,
    ) -> "DataParser":
        self = cls._base(gpr_prefix, config_model, device)
        self.use_precomputed = bool(config_predict["use_precomputed"])
        self.compute_gt_features = bool(config_predict["compute_groundtruth_features"])
        if self.perform_ar:
            self.batches = cls._batches(
                config_predict["ar_batchSize"], config_predict["ar_batchRepetition"]
            )
            self.one_pred_per_batch = bool(config_predict["ar_onePredictionPerBatch"])
        else:
            self.batches = []
            self.one_pred_per_batch = False
        self.input_files = list_files(input_path)
        self.output_files = list_files(groundtruth_path)
        return self

    # -- public API (reference DataParser.h:182-209) ------------------------

    def get_training_data(self) -> List[Tuple[np.ndarray, np.ndarray]]:
        """[(x_i, y_i)] feature pairs (reference GetTrainingData)."""
        self._extract_features_for_training()
        write_to_log_file(
            self.log_file,
            f"\tinputFeatures: {self.input_features.shape[0]}x{self.input_features.shape[1]}"
            f"\n\toutputFeatures: {self.output_features.shape[0]}x{self.output_features.shape[1]}",
        )
        n = self.input_features.shape[1]
        return [
            (self.input_features[:, i], self.output_features[:, i]) for i in range(n)
        ]

    def get_test_data(self) -> List[np.ndarray]:
        """Input feature vectors for prediction (reference GetTestData)."""
        self._extract_features_for_prediction()
        return [
            self.input_features[:, i] for i in range(self.input_features.shape[1])
        ]

    def get_results(self, predicted_features: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Inverse-PCA reconstruction of predicted output features
        (reference GetResults -> inversePca, DataParser.h:203-209,471-495)."""
        F = np.stack([np.asarray(v) for v in predicted_features], axis=1)
        write_csv(self.prefix_output + "Features_prediction.csv", F)
        out_pca = self._load_pca(self.prefix_output)
        # kept for the latency re-measurement (the reference stores
        # m_predictedFeatures at DataParser.h:205 and reconstructs from
        # them per frame at :242/:274)
        self._predicted_features = F
        self._predicted_output = _host(
            out_pca.reconstruct(F[: self.n_output_modes], self.n_output_modes)
        )
        return [
            self._predicted_output[:, i]
            for i in range(self._predicted_output.shape[1])
        ]

    def get_computation_time(self) -> List[float]:
        """Per-frame feature-extraction + reconstruction latency
        (reference GetComputationTime, DataParser.h:211-286); each frame's
        results are read back to the host inside its time."""
        import time

        in_pca = self._load_pca(self.prefix_input)
        out_pca = self._load_pca(self.prefix_output)
        times: List[float] = []
        theta = None
        if self.perform_ar:
            theta = self._load_ar()
        group = self.ar_p if self.perform_ar else 1
        n_frames = len(self.input_files) // max(self.ar_p, 1)
        for itr in range(n_frames):
            t0 = time.perf_counter()
            if self.perform_ar:
                files = self.input_files[itr * group : (itr + 1) * group]
            else:
                files = [self.input_files[itr]]
            M = parse_image_files(files)
            feats = _host(in_pca.reduce(M, self.n_input_modes))
            if self.perform_ar:
                self._predict_ar(
                    feats.T, theta, [(self.batches[0][0], 1)], self.one_pred_per_batch
                )
            if (
                self._predicted_features is not None
                and itr < self._predicted_features.shape[1]
            ):
                # reconstruct from the PREDICTED FEATURE vector of this
                # frame (reference DataParser.h:242,274) — not from the
                # already-reconstructed output
                W = self._predicted_features[: self.n_output_modes, itr : itr + 1]
                _host(out_pca.reconstruct(W))
            times.append(time.perf_counter() - t0)
        write_to_log_file(
            self.log_file,
            "\tPCA for inference done in (s):\n"
            + "".join(f"\t{t}\n" for t in times),
        )
        return times

    # -- internals ----------------------------------------------------------

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=self.dtype, device=self.device)

    def _load_pca(self, prefix: str) -> pcamod.PCAModel:
        return pcamod.load_pca(prefix, self.np_dtype, self.device)

    def _load_ar(self) -> torch.Tensor:
        return armod.load_ar(self.prefix + "-arModel.bin", self.np_dtype, self.device)

    def _predict_ar(self, features: np.ndarray, theta, batches, one_per_batch) -> np.ndarray:
        """AR rollout of (frames, modes) features -> (predictions, modes)."""
        return _host(
            armod.predict_ar(self._tensor(features), theta, self.ar_n, batches, one_per_batch)
        )

    def _compute_features_for_training(
        self, matrix: np.ndarray, n_modes: int, prefix: str, reference_file: str
    ) -> np.ndarray:
        """PCA fit + artifact writes (reference ComputeFeaturesForTraining,
        DataParser.h:289-331)."""
        data = self._tensor(matrix)
        model = pcamod.fit_pca(data)
        features = _host(model.reduce(data, n_modes))

        # mean/basis as geometric images for visual QA
        try:
            ref = imageio.read_image(reference_file)
            imageio.write_image(ref.like(_host(model.mean)), prefix + "Mean.vtk")
            basis = _host(model.basis(n_modes))
            for j in range(basis.shape[1]):
                imageio.write_image(
                    ref.like(basis[:, j]), prefix + f"Basis{j:03d}.vtk"
                )
        except (ValueError, OSError):
            pass  # non-image fixtures (unit tests) skip the visual artifacts

        write_csv(prefix + "Compactness.csv", _host(model.explained_variance())[:, None])
        model.save(prefix)
        write_csv(prefix + "Features.csv", _host(model.reduce(data)))
        return features

    def _extract_features_for_training(self) -> None:
        """(reference PcaFeatureExtractionForTraining, DataParser.h:333-412)"""
        if not self.use_precomputed:
            input_matrix = parse_image_files(self.input_files)
            output_matrix = parse_displacement_files(self.output_files)
            if input_matrix.shape[1] % output_matrix.shape[1] != 0:
                raise ValueError("Wrong number of input or output files")

            self.output_features = self._compute_features_for_training(
                output_matrix,
                self.n_output_modes,
                self.prefix_output,
                self.output_files[0],
            )
            if not self.perform_ar:
                self.input_features = self._compute_features_for_training(
                    input_matrix,
                    self.n_input_modes,
                    self.prefix_input,
                    self.input_files[0],
                )
            else:
                ar_train = parse_image_files(self.ar_files_train)
                ar_test = parse_image_files(self.ar_files_test)
                concat = np.concatenate([input_matrix, ar_train, ar_test], axis=1)
                concat_features = self._compute_features_for_training(
                    concat, self.n_input_modes, self.prefix_input, self.input_files[0]
                )
                n_in = input_matrix.shape[1]
                n_tr = ar_train.shape[1]
                in_f = concat_features[:, :n_in].T  # (frames, modes)
                ar_f_train = concat_features[:, n_in : n_in + n_tr].T
                ar_f_test = concat_features[:, n_in + n_tr :].T

                theta = armod.fit_ar(self._tensor(ar_f_train), self.ar_p, self.batches_train)
                armod.save_ar(theta, self.prefix + "-arModel.bin")
                test_pred = self._predict_ar(
                    ar_f_test, theta, self.batches_test, self.one_pred_per_batch_test
                )
                self.input_features = self._predict_ar(
                    in_f, theta, self.batches, self.one_pred_per_batch
                ).T
                write_csv(self.prefix + "-arFeaturesTest.csv", ar_f_test)
                write_csv(self.prefix + "-arFeaturesTestPredict.csv", test_pred)
                write_csv(self.prefix + "-arModel.csv", _host(theta))
        else:
            self.output_features = read_csv(self.prefix_output + "Features.csv")[
                : self.n_output_modes
            ]
            full_in = read_csv(self.prefix_input + "Features.csv")[
                : self.n_input_modes
            ]
            if not self.perform_ar:
                self.input_features = full_in
            else:
                in_f = full_in[:, : len(self.input_files)].T
                self.input_features = self._predict_ar(
                    in_f, self._load_ar(), self.batches, self.one_pred_per_batch
                ).T

    def _extract_features_for_prediction(self) -> None:
        """(reference PcaFeatureExtractionForPrediction, DataParser.h:414-469)"""
        pred_cache = self.prefix_input + "Features_prediction.csv"
        if not self.use_precomputed:
            input_matrix = parse_image_files(self.input_files)
            in_pca = self._load_pca(self.prefix_input)
            full = _host(in_pca.reduce(input_matrix))
            write_csv(pred_cache, full)
            feats = full[: self.n_input_modes]
        else:
            feats = read_csv(pred_cache)[: self.n_input_modes]

        if not self.perform_ar:
            self.input_features = feats
        else:
            self.input_features = self._predict_ar(
                feats.T, self._load_ar(), self.batches, self.one_pred_per_batch
            ).T

        if self.compute_gt_features:
            gt_matrix = parse_displacement_files(self.output_files)
            out_pca = self._load_pca(self.prefix_output)
            full = _host(out_pca.reduce(gt_matrix))
            self.output_features = full[: self.n_output_modes]
            write_csv(self.prefix + "-groundtruthFeatures_prediction.csv", full)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()
