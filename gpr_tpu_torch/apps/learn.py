"""Training app: the reference's ``gpLearn`` binary.

Mirrors gpr_tpu/apps/learn.py:24-122, with the same command-line contract
(reference apps/GaussianProcessLearn.cpp:70-73):

    python -m gpr_tpu_torch.apps.learn <config_model.json> <config_learn.json> \\
        gpr_prefix input_folder output_folder [ar_folder]

Reads the kernel string and the data noise from config_model, extracts
PCA(+AR) features by the DataParser, trains the exact GP in one fit (or,
with config_model's ``sparse_inducing`` m, a sparse GP on m evenly spaced
training inputs), and writes the 5-file model (or ``{prefix}-sparse.npz``)
and the per-stage times to the log file.

The features reach the GP in ``config.default_dtype()`` (float32 under the
``fast`` policy) on ``device``, the card unless ``main`` is given
``device="cpu"``.  The app calls ``fit`` as JAX's app does; on the card in
float32 ``fit``'s default takes ``fused-gram`` (K2-K4 with pad masking at
any n, gp/exact.py), elsewhere (float64, the CPU) JAX's plain ladder.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch


def _sync(device: torch.device) -> None:
    # the stage times end when the card is done, as JAX's block_until_ready
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, device=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    print("\nGaussian process training app:")
    if len(argv) not in (5, 6):
        print(
            "Usage: learn <path/to/config_model.json> <path/to/config_learn.json>"
            " gpr_prefix input_folder output_folder [ar_folder]"
        )
        return -1

    with open(argv[0]) as f:
        config_model = json.load(f)
    with open(argv[1]) as f:
        config_learn = json.load(f)
    gpr_prefix, input_folder, output_folder = argv[2:5]
    if config_model["perform_ar"]:
        if len(argv) < 6:
            print("Error: perform_ar is set but no ar_folder argument given")
            return -1
        ar_folder = argv[5]
    else:
        ar_folder = ""

    kernel_string = config_model["kernel_string"]
    data_noise = float(config_model["data_noise"])

    from ..gp import exact
    from ..gp import sparse as sparse_mod
    from ..kernels.dsl import parse_kernel
    from ..pipeline.dataparser import DataParser
    from ..utils import config
    from ..utils.logutils import get_current_date_time, write_to_log_file

    device = config.resolve_device(device)
    log = gpr_prefix + "-log_"
    write_to_log_file(log, "\n" + get_current_date_time("now"))
    write_to_log_file(log, "Gaussian process training app:")
    write_to_log_file(log, f" - kernel string: {kernel_string}")
    write_to_log_file(log, f" - data noise: {data_noise}")

    try:
        t0 = time.perf_counter()
        kernel = parse_kernel(kernel_string)
        print(f"Initialize Gaussian process... {time.perf_counter()-t0:.3f}s [done]")

        t0 = time.perf_counter()
        parser = DataParser.for_training(
            input_folder, output_folder, ar_folder, gpr_prefix,
            config_model, config_learn, device=device,
        )
        pairs = parser.get_training_data()
        dt = time.perf_counter() - t0
        print(f"Parse data and perform PCA... {dt:.3f}s [done]")
        write_to_log_file(log, f"elapsed time: {dt} [PCA successfully completed]")

        t0 = time.perf_counter()
        dtype = config.default_dtype()
        X = torch.as_tensor(np.stack([p[0] for p in pairs]), dtype=dtype, device=device)
        Y = torch.as_tensor(np.stack([p[1] for p in pairs]), dtype=dtype, device=device)

        # optional sparse mode (a config extension beyond the reference):
        # "sparse_inducing": m trains an inducing-point GP for large n
        m_inducing = int(config_model.get("sparse_inducing", 0))
        if 0 < m_inducing < X.shape[0]:
            idx = np.linspace(0, X.shape[0] - 1, m_inducing).astype(int)
            sgp = sparse_mod.fit_sparse(kernel, X[idx], X, Y, sigma=data_noise, jitter=1e-8)
            _sync(device)
            dt = time.perf_counter() - t0
            print(f"Perform training (sparse, m={m_inducing}, route {sgp.route})... {dt:.3f}s [done]")
            write_to_log_file(
                log,
                f"Perform training (sparse)...  elapsed time: {dt} "
                "[successfully completed]",
            )
            t0 = time.perf_counter()
            sparse_mod.save_sparse(sgp, gpr_prefix + "-sparse.npz")
            print(f"Saving sparse GP... {time.perf_counter()-t0:.3f}s [done]")
            return 0

        gp = exact.fit(kernel, X, Y, sigma=data_noise)
        _sync(device)
        dt = time.perf_counter() - t0
        print(f"Perform training (route {gp.route})... {dt:.3f}s [done]")
        write_to_log_file(
            log, f"Perform training...  elapsed time: {dt} [successfully completed]"
        )

        t0 = time.perf_counter()
        gp.save(gpr_prefix)
        print(f"Saving Gaussian process... {time.perf_counter()-t0:.3f}s [done]")
        return 0
    except (ValueError, OSError, KeyError) as e:
        print(f"\nError: {e}")
        return -1


if __name__ == "__main__":
    sys.exit(main())
