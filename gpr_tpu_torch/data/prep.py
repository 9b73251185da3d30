"""Dataset preparation: pair splitting, DVF ROI cropping, US smoothing.

Mirrors gpr_tpu/data/prep.py:1-296, a copy with one fault of that module
mended: its ``create_pairs`` raises at prep.py:106 before the AR grouping
factor p, the modulo check and the AR png moves (prep.py:107-123), so with
``ar=True`` every CT file moves and the AR folders stay empty.  Here they
run in the AR branch: only every p-th CT file moves and the AR pngs fill
``AR/train`` and ``AR/test``.

Re-design of the reference's ``scripts/data/`` layer, ITK-free:

  * :func:`create_pairs` — split US/CT (surrogate/DVF) pairs into
    train/validation/test(/AR/offset) folders driven by a ``pairs.csv``
    index (reference scripts/data/create_pairs.py:28-125, including the
    move-back-to-parent reset and the AR-order grouping factor p);
  * :func:`crop_dvf_roi` — bounding-box-of-nonzero-displacement cropping
    across a DVF series (reference scripts/data/preprocess_dvf.py:16-82);
  * :func:`blur_us` — Gaussian smoothing of US frames into a
    ``{src}_blurred`` sibling folder (reference
    scripts/data/preprocess_us.py:13-24);
  * :func:`check_synchro` — US/DVF frame-count synchrony check (reference
    scripts/data/check_synchro.py semantics);
  * DICOM loading is gated on pydicom, which this image does not ship —
    :func:`load_dicom_series` raises with guidance (reference
    scripts/data/dicom_loader.py needs pydicom).
"""

from __future__ import annotations

import csv
import os
import shutil
from typing import Dict, Optional, Sequence

import numpy as np

from ..pipeline import imageio


def _empty_dir(path: str) -> None:
    """Move any existing files back to the parent (reference
    create_pairs.py:8-15) so re-splitting is idempotent.  Only for
    create_pairs, whose splits MOVE source files; splitting stages that
    COPY must use :func:`_clear_dir` (reference main.py:240-250 removes)
    or stale numbered copies pollute the source directory."""
    if os.path.exists(path):
        for f in os.listdir(path):
            shutil.move(os.path.join(path, f), os.path.dirname(path))
    else:
        os.makedirs(path)


def _clear_dir(path: str) -> None:
    """Delete the directory's files (reference main.py:240-250)."""
    if os.path.isdir(path):
        for f in os.listdir(path):
            os.remove(os.path.join(path, f))
    else:
        os.makedirs(path, exist_ok=True)


def create_pairs(
    root: str,
    split: Sequence[int],
    split_factor: int = 1,
    offset: int = 0,
    mode: int = 1,
    ar: bool = False,
    ct_filename: str = "deformationfield_{:03d}.mha",
    us_filename: str = "us_{:05d}.png",
) -> None:
    """Distribute US/CT pairs into split folders per ``pairs/pairs.csv``.

    Semantics follow the reference exactly (create_pairs.py:28-125):
    csv columns [ct_ind, us_ind, _, dataset_ind]; with ``ar`` the first two
    split entries are AR train/test counts; p = rows / (sum(split)+offset)
    is the AR grouping factor; only every p-th CT file moves (one DVF per
    US sweep); the test split gets no CT; ``offset`` rows land in
    US/offset."""
    if len(split) not in (3, 5):
        raise ValueError(f"{root}: split indices not correctly defined")
    split = [s * split_factor for s in split]
    offset *= split_factor

    pairs_dir = os.path.join(root, "pairs")
    ct_dir = os.path.join(pairs_dir, "CT")
    us_dir = os.path.join(pairs_dir, "US")
    ar_dir = os.path.join(pairs_dir, "AR")

    ct_dirs = [os.path.join(ct_dir, s) for s in ("train", "validation", "test")]
    us_dirs = [os.path.join(us_dir, s) for s in ("train", "validation", "test")]
    us_offset_dir = os.path.join(us_dir, "offset")
    for d in ct_dirs + us_dirs + [us_offset_dir]:
        _empty_dir(d)
    if ar and mode == 1:
        ar_dirs = [os.path.join(ar_dir, s) for s in ("train", "test")]
        for d in ar_dirs:
            _empty_dir(d)

    with open(os.path.join(pairs_dir, "pairs.csv")) as f:
        rows = list(csv.reader(f))
    pairs_ind = np.array(rows[1:])  # drop header

    p = 1
    if ar:
        if len(split) != 5:
            raise ValueError("split indices not correctly defined for AR")
        split_ar, split = split[:2], split[2:]
        # the AR grouping factor, its fit check and the AR png moves belong
        # to the AR case; gpr_tpu/data/prep.py:107-123 has them after the
        # raise below, where they never run
        if pairs_ind.shape[0] % (sum(split) + offset) != 0:
            raise ValueError(
                f"split indices ({sum(split)+offset}) do not fit dataset "
                f"({pairs_ind.shape[0]})"
            )
        p = pairs_ind.shape[0] // (sum(split) + offset)
        if mode == 1:
            files = sorted(
                os.path.join(ar_dir, f)
                for f in os.listdir(ar_dir)
                if f.endswith(".png")
            )
            for i, f in enumerate(files):
                if i < split_ar[0]:
                    shutil.move(f, ar_dirs[0])
                elif i < split_ar[0] + split_ar[1]:
                    shutil.move(f, ar_dirs[1])
    elif len(split) != 3:
        # the reference asserts len(split) == 3 before any file moves
        # (create_pairs.py:105); a 5-entry split without ar would index
        # past the three destination dirs mid-move
        raise ValueError(f"{root}: split indices not correctly defined")

    def us_name(row_idx: int) -> str:
        us_ind = int(pairs_ind[row_idx, 1])
        if mode == 1:
            return us_filename.format(int(pairs_ind[row_idx, 3]), us_ind)
        return us_filename.format(us_ind)

    start = offset
    for set_idx, count in enumerate(split):
        for i in range(count * p):
            if set_idx < 2:  # no CT for the test set
                if i % p == 0:
                    ct_ind = int(pairs_ind[start + i, 0])
                    shutil.move(
                        os.path.join(ct_dir, ct_filename.format(ct_ind)),
                        ct_dirs[set_idx],
                    )
            shutil.move(
                os.path.join(us_dir, us_name(start + i)), us_dirs[set_idx]
            )
        start += count * p

    for i in range(offset * p):
        shutil.move(os.path.join(us_dir, us_name(i)), us_offset_dir)


def dvf_roi(files: Sequence[str]) -> Dict[str, int]:
    """Bounding box of nonzero displacement across a DVF series (reference
    preprocess_dvf.py:25-71; the all-zero master frame is skipped)."""
    lo = np.array([np.iinfo(np.int64).max] * 3)
    hi = np.array([np.iinfo(np.int64).min] * 3)
    for f in files:
        # SIGNED component sum with strictly-positive tests, exactly like
        # the reference (preprocess_dvf.py:36 'np.sum(arr, axis=3)' and
        # the '> 0' slice checks at :43-69) — an abs-sum would include
        # slices the reference excludes and change the crop dimensions
        mag = imageio.read_image(f).data.sum(axis=-1)  # (z, y, x)
        if mag.max() == 0:
            continue  # master
        nz = np.nonzero(mag > 0)
        if nz[0].size == 0:
            continue
        for ax in range(3):
            lo[ax] = min(lo[ax], nz[ax].min())
            hi[ax] = max(hi[ax], nz[ax].max())
    return {
        "z_min": int(lo[0]), "z_max": int(hi[0]),
        "y_min": int(lo[1]), "y_max": int(hi[1]),
        "x_min": int(lo[2]), "x_max": int(hi[2]),
    }


def crop_dvf_roi(
    src: str, dest: str, fmt: str = "mha", max_roi_files: Optional[int] = None
) -> Dict[str, int]:
    """Crop every DVF in ``src`` to the series' common nonzero ROI
    (reference preprocess_dvf.py:74-82 — note the reference's slice
    convention drops the max index; preserved).  ``max_roi_files`` caps how
    many files define the ROI (reference create_CT_datasets.py:26-27:
    ``tresh``) — all files are still cropped."""
    files = sorted(
        os.path.join(src, f) for f in os.listdir(src) if f.endswith(fmt)
    )
    if not files:
        raise FileNotFoundError(f"No such file or directory: {src}")
    os.makedirs(dest, exist_ok=True)
    roi = dvf_roi(files if max_roi_files is None else files[:max_roi_files])
    for f in files:
        img = imageio.read_image(f)
        cropped = img.data[
            roi["z_min"] : roi["z_max"],
            roi["y_min"] : roi["y_max"],
            roi["x_min"] : roi["x_max"],
        ]
        out = imageio.Image(
            cropped, img.spacing, img.origin, ncomponents=img.ncomponents
        )
        imageio.write_image(out, os.path.join(dest, os.path.basename(f)))
    np.save(os.path.join(src, "indices_VOI"), roi)  # reference artifact name
    return roi


def blur_us(src: str, sigma: float = 2.0) -> str:
    """Gaussian-blur US frames into ``{src}_blurred`` (reference
    preprocess_us.py:13-24)."""
    from scipy.ndimage import gaussian_filter

    dest = f"{src}_blurred"
    os.makedirs(dest, exist_ok=True)
    for f in sorted(os.listdir(src)):
        path = os.path.join(src, f)
        img = imageio.read_image(path)
        blurred = gaussian_filter(np.asarray(img.data, np.float64), sigma)
        out = imageio.Image(
            blurred.astype(img.data.dtype)
            if np.issubdtype(img.data.dtype, np.integer)
            else blurred,
            img.spacing,
            img.origin,
            ncomponents=img.ncomponents,
        )
        imageio.write_image(out, os.path.join(dest, f))
    return dest


def check_synchro(us_dir: str, dvf_dir: str, factor: int = 1) -> bool:
    """US/DVF cardinality synchrony: len(us) == factor * len(dvf)
    (reference check_synchro.py semantics)."""
    n_us = len(os.listdir(us_dir))
    n_dvf = len(os.listdir(dvf_dir))
    return n_us == factor * n_dvf


def split_train_test(
    dirs: "dict[str, str]",
    n_training_imgs: int,
    formats: "dict[str, str]",
) -> "dict[str, tuple[int, int]]":
    """Sweep-count train/test split of the experiment data dirs (reference
    scripts/main.py:217-263, the ``splitting_data`` stage): for each named
    directory, files with its format extension are sorted, the first
    ``n_training_imgs`` copied to ``<dir>/train/%05d.<fmt>`` and the rest
    to ``<dir>/test/%05d.<fmt>`` (both emptied first).  Returns
    {name: (n_train, n_test)}."""
    counts = {}
    for name, current_dir in dirs.items():
        fmt = formats[name]
        files = sorted(
            os.path.join(current_dir, f)
            for f in os.listdir(current_dir)
            if f.endswith(fmt) and os.path.isfile(os.path.join(current_dir, f))
        )
        train_dir = os.path.join(current_dir, "train")
        test_dir = os.path.join(current_dir, "test")
        for d in (train_dir, test_dir):
            _clear_dir(d)
        for itr, f in enumerate(files[:n_training_imgs]):
            shutil.copyfile(f, os.path.join(train_dir, ("%05d." % itr) + fmt))
        for itr, f in enumerate(files[n_training_imgs:]):
            shutil.copyfile(f, os.path.join(test_dir, ("%05d." % itr) + fmt))
        counts[name] = (
            len(os.listdir(train_dir)),
            len(os.listdir(test_dir)),
        )
    return counts


def load_dicom_series(
    input_dir: str, output_dir: str, n_slices: int = 0, is_navi: bool = False
):
    """DICOM ingestion (reference scripts/data/dicom_loader.py:17-60):
    rename by InstanceNumber, fix navigator slice spacing, sort data
    slices into per-position sweep folders.  Uses pydicom when installed,
    else the built-in explicit-VR reader — see :mod:`gpr_tpu_torch.data.dicom`."""
    from .dicom import preprocess_dicom_dir

    return preprocess_dicom_dir(
        input_dir, output_dir, n_slices=n_slices, is_navi=is_navi
    )


def read_us_video(path: str, dest_dir: str):
    """US video frame extraction (reference scripts/read_us_video.py) —
    requires OpenCV, which this image does not ship.  Convert the video to
    per-frame PNGs externally, or install cv2."""
    try:
        import cv2  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "read_us_video needs OpenCV (cv2); extract frames with ffmpeg "
            "(`ffmpeg -i video.avi us_%05d.png`) as an alternative."
        ) from e
    raise NotImplementedError  # pragma: no cover
