"""Validation metrics: DVF accuracy percentiles + per-frame latency.

Mirrors gpr_tpu/apps/validate.py:1-120, a copy that takes ``diff_image`` from the port's
``pipeline/warp.py``; numpy only.

Re-design of the reference's analysis layer (reference
scripts/validation_dvf.py:60-120 and scripts/validation_compTime.py:15-46),
ITK/matplotlib-free.  Usable as a library or CLI:

    python -m gpr_tpu_torch.apps.validate dvf <gt_dir> <pred_dir> [--mask mask.mha]
    python -m gpr_tpu_torch.apps.validate comptime <prefix>
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional

import numpy as np

from ..pipeline import imageio


def dvf_error(
    gt_dir: str,
    pred_dir: str,
    mask_path: Optional[str] = None,
    percentiles: List[int] = (50, 75, 90, 95, 99),
    diff_dir: Optional[str] = None,
) -> Dict:
    """Per-voxel L2 displacement error over all frames + percentile stats
    (reference validation_dvf.py:60-105: zero-error voxel rows eliminated
    before the statistics)."""
    gt_files = sorted(
        os.path.join(gt_dir, f) for f in os.listdir(gt_dir)
    )
    pred_files = sorted(
        os.path.join(pred_dir, f) for f in os.listdir(pred_dir)
    )
    if len(gt_files) != len(pred_files):
        raise ValueError(
            f"validate: {len(gt_files)} ground-truth vs {len(pred_files)} "
            "predicted frames"
        )
    mask = None
    if mask_path:
        mask = imageio.read_image(mask_path).data > 0

    if diff_dir:
        os.makedirs(diff_dir, exist_ok=True)
    cols = []
    for i, (gt_f, pr_f) in enumerate(zip(gt_files, pred_files)):
        gt_img = imageio.read_image(gt_f)
        gt = gt_img.data
        pred = imageio.read_image(pr_f).data
        if diff_dir:
            # per-frame difference field (reference validation_dvf.py:85-92
            # --save / main.py evaluation diff images)
            from ..pipeline.warp import diff_image

            pr_img = imageio.read_image(pr_f)
            imageio.write_image(
                diff_image(gt_img, pr_img),
                os.path.join(diff_dir, f"diff_{i:03d}.mha"),
            )
        diff = np.linalg.norm(gt - pred, axis=-1)
        if mask is not None:
            diff = diff[mask]
        cols.append(diff.ravel())
    err = np.stack(cols, axis=1)  # (n_vox, n_img)
    err = err[~(err == 0).all(axis=1)]  # eliminate zero rows (:96)

    pvals = np.percentile(err.ravel(), list(percentiles))
    return {
        "percentiles": dict(zip(percentiles, pvals.tolist())),
        "max_per_frame": np.max(err, axis=0),
        "min_per_frame": np.min(err, axis=0),
        "mean_per_frame": np.mean(err, axis=0),
        "median_per_frame": np.median(err, axis=0),
        "errbars": np.percentile(err, [1, 99, 5, 95, 25, 75, 50], axis=0),
    }


def comp_time(prefix: str) -> Dict:
    """Aggregate per-frame inference + PCA latency (reference
    validation_compTime.py:22-44: the two CSVs are summed per frame)."""
    inference = np.genfromtxt(prefix + "-latestInferenceTime.txt", delimiter=",")
    pca = np.genfromtxt(prefix + "-latestCompTimePCA.txt", delimiter=",")
    inference = np.atleast_1d(inference)[~np.isnan(np.atleast_1d(inference))]
    pca = np.atleast_1d(pca)[~np.isnan(np.atleast_1d(pca))]
    n = min(len(inference), len(pca))
    total = inference[:n] + pca[:n]
    return {
        "mean": float(np.mean(total)),
        "std": float(np.std(total)),
        "min": float(np.min(total)),
        "max": float(np.max(total)),
        "per_frame": total,
    }


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("Usage: validate dvf <gt_dir> <pred_dir> [mask] | validate comptime <prefix>")
        return -1
    if argv[0] == "dvf":
        stats = dvf_error(argv[1], argv[2], argv[3] if len(argv) > 3 else None)
        for p, v in stats["percentiles"].items():
            print(f"{p}% percentile:\t{v:0.4f}")
        return 0
    if argv[0] == "comptime":
        stats = comp_time(argv[1])
        for k in ("mean", "std", "min", "max"):
            print(f"{k}: {stats[k]:04f}")
        return 0
    print(f"validate: unknown mode {argv[0]!r}")
    return -1


if __name__ == "__main__":
    sys.exit(main())
