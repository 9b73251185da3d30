"""Inference app: the reference's ``gpPredict`` binary.

Mirrors gpr_tpu/apps/predict.py:24-170, with the same command-line contract
(reference apps/GaussianProcessPredict.cpp:110-113):

    python -m gpr_tpu_torch.apps.predict <config_model.json> <config_predict.json> \\
        gpr_prefix input_folder groundtruth_folder result_folder reference_file

Per-frame GP prediction and credible interval, each frame's wall-clock time
appended to ``{prefix}-latestInferenceTime.txt`` (reference :185-194), the
PCA latency to ``{prefix}-latestCompTimePCA.txt``, the credible intervals to
``{prefix}-credibleInterval.csv`` and the predicted DVFs as
``result_folder/dfPred%05d.vtk`` (reference SavePrediction, :55-94).  A
``{prefix}-sparse.npz`` beside the model makes it the sparse GP.

The model and the features are ``config.default_dtype()`` (float32 under
the ``fast`` policy) on ``device``, the card unless ``main`` is given
``device="cpu"``.  Each frame is one call of :func:`_packed`, which returns
the mean and the credible interval in one vector: one copy of the frame's
features to the device and one read back to the host, no other
synchronization.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch


def save_prediction(vectors, output_dir: str, reference_file: str) -> None:
    """Write each reconstructed DVF as dfPred%05d.vtk with the reference
    volume's geometry (reference SavePrediction,
    apps/GaussianProcessPredict.cpp:55-94)."""
    from ..pipeline import imageio

    ref = imageio.read_image(reference_file)
    # the reference binary is 3-D-only (hardcodes 3 components); follow
    # the master volume instead so 2-D+t tracking fields round-trip
    # (examples/params/matrix/config_tracking_2d.yaml)
    n_comp = ref.ncomponents if ref.ncomponents > 1 else 3
    for i, v in enumerate(vectors):
        npix = np.asarray(v).size // n_comp
        shape = ref.data.shape[: -1] if ref.ncomponents > 1 else ref.data.shape
        img = imageio.Image(
            data=np.asarray(v).reshape(*shape, n_comp)
            if int(np.prod(shape)) == npix
            else np.asarray(v).reshape(-1, n_comp)[None],
            spacing=ref.spacing,
            origin=ref.origin,
            ncomponents=n_comp,
        )
        imageio.write_image(img, os.path.join(output_dir, f"dfPred{i:05d}.vtk"))


def _append_csv_row(path: str, values) -> None:
    """Trailing-comma single-line append (reference WriteVectorToFile,
    apps/GaussianProcessPredict.cpp:96-105)."""
    with open(path, "a") as f:
        for v in values:
            f.write(f"{v},")


def _packed(gp, x: torch.Tensor) -> torch.Tensor:
    """[mean..., credible interval] of one frame (predict.py:121-130)."""
    mean = gp.predict(x)
    ci = gp.credible_interval(x)
    dt = torch.promote_types(mean.dtype, ci.dtype)
    return torch.cat([mean.reshape(-1).to(dt), ci.reshape(1).to(dt)])


def main(argv=None, device=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    print("\nGaussian process prediction app:")
    if len(argv) != 7:
        print(
            "Usage: predict <path/to/config_model.json> <path/to/config_predict.json>"
            " gpr_prefix input_folder groundtruth_folder result_folder reference_file"
        )
        return -1

    with open(argv[0]) as f:
        config_model = json.load(f)
    with open(argv[1]) as f:
        config_predict = json.load(f)
    gpr_prefix, input_folder, gt_folder, result_folder, reference_file = argv[2:7]

    from ..gp import exact
    from ..gp import sparse as sparse_mod
    from ..pipeline.dataparser import DataParser
    from ..utils import config
    from ..utils.logutils import get_current_date_time, write_to_log_file

    device = config.resolve_device(device)
    log = gpr_prefix + "-log_"
    write_to_log_file(log, "\n" + get_current_date_time("now"))
    write_to_log_file(log, "Gaussian process prediction app")

    try:
        dtype, np_dtype = config.default_dtype(), config.default_numpy_dtype()
        t0 = time.perf_counter()
        sparse_path = gpr_prefix + "-sparse.npz"
        if os.path.exists(sparse_path):
            gp = sparse_mod.load_sparse(sparse_path, np_dtype, device)
            print(
                f"Initialize sparse Gaussian process... "
                f"{time.perf_counter()-t0:.3f}s [done]"
            )
        else:
            gp = exact.load(gpr_prefix, np_dtype, device)
            print(
                f"Initialize Gaussian process... {time.perf_counter()-t0:.3f}s [done]"
            )

        t0 = time.perf_counter()
        parser = DataParser.for_prediction(
            input_folder, gt_folder, gpr_prefix, config_model, config_predict, device=device
        )
        test_vectors = parser.get_test_data()
        dt = time.perf_counter() - t0
        print(f"Parse data and extract PCA features... {dt:.3f}s [done]")
        write_to_log_file(log, f"elapsed time: {dt} [PCA successfully completed]")

        def frame(v) -> np.ndarray:
            x = torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
            return _packed(gp, x).cpu().numpy()

        # one warm-up frame outside the timed loop (none when the input
        # folder held no frames: the loop below then writes the empty
        # artifact set, like the reference)
        if test_vectors:
            frame(test_vectors[0])

        predicted, confidence, times = [], [], []
        print("GP prediction done in (s):")
        for v in test_vectors:
            t0 = time.perf_counter()
            out = frame(v)
            dt = time.perf_counter() - t0
            predicted.append(out[:-1])
            confidence.append(float(out[-1]))
            times.append(dt)
            print(dt)
        _append_csv_row(gpr_prefix + "-latestInferenceTime.txt", times)

        t0 = time.perf_counter()
        output_vectors = parser.get_results(predicted)
        print(
            "Reconstruct output from principal components... "
            f"{time.perf_counter()-t0:.3f}s [done]"
        )

        comp_time = parser.get_computation_time()
        _append_csv_row(gpr_prefix + "-latestCompTimePCA.txt", comp_time)

        t0 = time.perf_counter()
        save_prediction(output_vectors, result_folder, reference_file)
        print(f"Save results... {time.perf_counter()-t0:.3f}s [done]")
        _append_csv_row(gpr_prefix + "-credibleInterval.csv", confidence)
        return 0
    except (ValueError, OSError, KeyError) as e:
        print(f"Error: {e}")
        return -1


if __name__ == "__main__":
    sys.exit(main())
