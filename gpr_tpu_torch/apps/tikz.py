"""TikZ/pgfplots export of the validation figures.

Mirrors gpr_tpu/apps/tikz.py:1-142, a copy; numpy only.

Re-designs the reference's matplotlib2tikz path (reference
scripts/validation_dvf.py:110-198: fig5 — percentile error bands + median
over time on the left axis, the GP credible interval on a right axis,
saved as ``credible_interval_<subdir>_<suffix>.tex``).  Instead of
rendering a matplotlib figure and converting it, the .tex is generated
DIRECTLY from the data: no display, no matplotlib dependency, identical
pgfplots semantics (``\\addplot`` pairs + ``\\closedcycle`` fills for the
bands, ``axis y line*=right`` for the confidence axis).

Also writes the reference's companion artifacts ``errbars<suffix>.npy`` /
``errbars_mean<suffix>.npy`` (validation_dvf.py:131-137).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

# band edges in dvf_error's errbars row order [1, 99, 5, 95, 25, 75, 50]
_BANDS = (
    (0, 1, "band199", "01/99 percentiles"),
    (2, 3, "band595", "05/95 percentiles"),
    (4, 5, "band2575", "25/75 percentiles"),
)
_BAND_COLORS = {
    "band199": (0.91, 0.95, 1.0),
    "band595": (0.80, 0.90, 1.0),
    "band2575": (0.60, 0.80, 1.0),
}


def _coords(x: np.ndarray, y: np.ndarray) -> str:
    return " ".join(f"({xi:.6g},{yi:.6g})" for xi, yi in zip(x, y))


def credible_interval_tikz(
    errbars: np.ndarray,
    median_err: np.ndarray,
    credible_interval: Optional[np.ndarray] = None,
    sampling_rate_hz: float = 1.25,
    xlabel: str = "time [s]",
    ylabel: str = "prediction error [mm]",
) -> str:
    """Return the pgfplots .tex source for the reference's fig5.

    ``errbars``: (7, T) percentile rows in dvf_error's order
    ``[1, 99, 5, 95, 25, 75, 50]``; ``median_err``: (T,);
    ``credible_interval``: per-frame confidence values for the right axis
    (reference gpr-credibleInterval.csv), or None to omit that axis.
    The time axis is ``frame / sampling_rate_hz`` (the reference hardcodes
    f = 1.25 Hz, validation_dvf.py:170)."""
    errbars = np.asarray(errbars)
    median_err = np.asarray(median_err)
    t = np.arange(errbars.shape[1]) / float(sampling_rate_hz)

    lines = []
    for name, rgb in _BAND_COLORS.items():
        lines.append(
            "\\definecolor{%s}{rgb}{%.2f,%.2f,%.2f}" % ((name,) + rgb)
        )
    lines += [
        "\\begin{tikzpicture}",
        "\\begin{axis}[",
        "  xlabel={%s}," % xlabel,
        "  ylabel={%s}," % ylabel,
        "  axis y line*=left," if credible_interval is not None else "",
        "  grid=both,",
        "  legend pos=north west,",
        "]",
    ]
    for lo, hi, color, label in _BANDS:
        # a closed fill: lower edge forward, upper edge backward
        xs = np.concatenate([t, t[::-1]])
        ys = np.concatenate([errbars[lo], errbars[hi][::-1]])
        lines.append(
            "\\addplot[draw=%s, fill=%s, forget plot] coordinates {%s} "
            "\\closedcycle;" % (color, color, _coords(xs, ys))
        )
        lines.append("\\addlegendimage{area legend, fill=%s}" % color)
        lines.append("\\addlegendentry{%s}" % label)
    lines.append(
        "\\addplot[blue, thick] coordinates {%s};" % _coords(t, median_err)
    )
    lines.append("\\addlegendentry{median}")
    lines.append("\\end{axis}")

    if credible_interval is not None:
        ci = np.asarray(credible_interval)
        ci = ci[np.isfinite(ci)]
        tc = np.arange(len(ci)) / float(sampling_rate_hz)
        lines += [
            "\\begin{axis}[",
            "  axis y line*=right,",
            "  axis x line=none,",
            "  ylabel={confidence value},",
            "]",
            "\\addplot[red] coordinates {%s};" % _coords(tc, ci),
            "\\addlegendentry{confidence value}",
            "\\end{axis}",
        ]
    lines.append("\\end{tikzpicture}")
    return "\n".join(l for l in lines if l) + "\n"


def export_validation_tikz(
    root: str,
    result: dict,
    subdir: str = "test",
    suffix: str = "",
    credible_csv: Optional[str] = None,
    sampling_rate_hz: float = 1.25,
    mask: bool = False,
) -> str:
    """Write the reference's plot artifacts from a ``validate.dvf_error``
    result dict: ``errbars<suffix>.npy``, ``errbars_mean<suffix>.npy`` and
    ``credible_interval_<subdir>_<suffix>.tex`` (``..._VOI.tex`` when a
    mask was used — reference validation_dvf.py:131-137,196-198).  Returns
    the .tex path."""
    out_dir = os.path.join(root, "VOI") if mask else root
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, f"errbars{suffix}.npy"), result["errbars"])
    np.save(
        os.path.join(out_dir, f"errbars_mean{suffix}.npy"),
        result["mean_per_frame"],
    )

    ci = None
    if credible_csv and os.path.exists(credible_csv):
        ci = np.genfromtxt(credible_csv, delimiter=",")
    tex = credible_interval_tikz(
        result["errbars"], result["median_per_frame"], ci,
        sampling_rate_hz=sampling_rate_hz,
    )
    stem = f"credible_interval_{subdir}_{suffix}" + ("_VOI" if mask else "")
    tex_path = os.path.join(root, stem + ".tex")
    with open(tex_path, "w") as f:
        f.write(tex)
    return tex_path
