"""Offline analysis tools: PCA compactness, format conversion, plots.

Mirrors gpr_tpu/apps/analysis.py:1-138, a copy; numpy only, and matplotlib where it is
installed (without it the plots are skipped, analysis.py:60-63, 91-94).

Re-design of the reference's analysis scripts (reference
scripts/model_analysis.py:17-40, scripts/vtk_mha_converter.py,
scripts/plot_parameters.py, scripts/plot_dvf.py) against the rebuilt
artifact contract.  Plotting degrades gracefully when matplotlib is
unavailable (stats still print).

    python -m gpr_tpu_torch.apps.analysis modes <gpr_dir> [--thresh 0.5]
    python -m gpr_tpu_torch.apps.analysis convert <src_dir> <dst_dir>
    python -m gpr_tpu_torch.apps.analysis features <features.csv> [out.png]
    python -m gpr_tpu_torch.apps.analysis dvf-mean <dvf_dir> [out.png]
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Tuple

import numpy as np

from ..pipeline import imageio


def mode_counts(gpr_dir: str, thresh: float = 0.5) -> Tuple[int, int]:
    """Smallest input/output mode counts whose cumulative explained
    variance exceeds ``thresh`` (reference model_analysis.py:27-29)."""
    inp = np.genfromtxt(os.path.join(gpr_dir, "gpr-inputCompactness.csv"))
    out = np.genfromtxt(os.path.join(gpr_dir, "gpr-outputCompactness.csv"))
    n_in = next(i for i, v in enumerate(inp) if v > thresh)
    n_out = next(i for i, v in enumerate(out) if v > thresh)
    return n_in, n_out


def convert_vtk_dir(src: str, dest: str) -> int:
    """Batch VTK -> MHA conversion (reference vtk_mha_converter.py:6-14),
    ITK-free via the builtin codecs."""
    os.makedirs(dest, exist_ok=True)
    files = sorted(f for f in os.listdir(src) if f.endswith("vtk"))
    for f in files:
        img = imageio.read_image(os.path.join(src, f))
        imageio.write_image(img, os.path.join(dest, f[:-3] + "mha"))
    return len(files)


def feature_trajectories(features_csv: str, out_png: str | None = None) -> Dict:
    """Per-mode feature statistics over frames + optional trajectory plot
    (reference plot_parameters.py semantics on the Features.csv artifact)."""
    F = np.genfromtxt(features_csv, delimiter=",")  # (modes, frames)
    F = np.atleast_2d(F)
    stats = {
        "n_modes": int(F.shape[0]),
        "n_frames": int(F.shape[1]),
        "mode_std": F.std(axis=1).tolist(),
        "mode_range": (F.max(axis=1) - F.min(axis=1)).tolist(),
    }
    if out_png:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            fig, ax = plt.subplots(figsize=(8, 4))
            for i in range(min(6, F.shape[0])):
                ax.plot(F[i], label=f"mode {i}")
            ax.set_xlabel("frame")
            ax.set_ylabel("feature value")
            ax.legend(loc="upper right", fontsize=7)
            fig.tight_layout()
            fig.savefig(out_png, dpi=100)
            plt.close(fig)
        except ImportError:
            pass
    return stats


def dvf_mean_magnitude(dvf_dir: str, out_png: str | None = None) -> np.ndarray:
    """Mean displacement magnitude per frame (reference plot_dvf.py)."""
    files = sorted(
        os.path.join(dvf_dir, f) for f in os.listdir(dvf_dir) if f.endswith(".vtk")
    )
    mags = []
    for f in files:
        d = imageio.read_image(f).data
        mags.append(float(np.linalg.norm(d, axis=-1).mean()))
    mags = np.asarray(mags)
    if out_png:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            fig, ax = plt.subplots(figsize=(8, 3))
            ax.plot(mags)
            ax.set_xlabel("frame")
            ax.set_ylabel("mean |displacement|")
            fig.tight_layout()
            fig.savefig(out_png, dpi=100)
            plt.close(fig)
        except ImportError:
            pass
    return mags


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__)
        return -1
    cmd = argv[0]
    if cmd == "modes":
        thresh = 0.5
        if "--thresh" in argv:
            thresh = float(argv[argv.index("--thresh") + 1])
        n_in, n_out = mode_counts(argv[1], thresh)
        print(n_in, n_out)
        return 0
    if cmd == "convert":
        n = convert_vtk_dir(argv[1], argv[2])
        print(f"converted {n} files")
        return 0
    if cmd == "features":
        stats = feature_trajectories(argv[1], argv[2] if len(argv) > 2 else None)
        print(stats)
        return 0
    if cmd == "dvf-mean":
        mags = dvf_mean_magnitude(argv[1], argv[2] if len(argv) > 2 else None)
        print(f"frames: {len(mags)} mean |d|: {mags.mean():.4f}")
        return 0
    print(f"analysis: unknown command {cmd!r}")
    return -1


if __name__ == "__main__":
    sys.exit(main())
