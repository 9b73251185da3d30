"""Date-stamped append-only logging (reference include/logUtils.h:11-31).

Copied from gpr_tpu/utils/logutils.py:1-21 (standard library only): importing
it from ``gpr_tpu`` would run gpr_tpu/__init__.py, which imports JAX.
"""

from __future__ import annotations

import datetime


def get_current_date_time(kind: str = "now") -> str:
    """'date' -> YYYY-MM-DD, 'now' -> YYYY-MM-DD.HH:mm:ss
    (reference logUtils.h:11-22)."""
    t = datetime.datetime.now()
    if kind == "date":
        return t.strftime("%Y-%m-%d")
    return t.strftime("%Y-%m-%d.%X")


def write_to_log_file(prefix: str, message: str) -> None:
    """Append to {prefix}{YYYY-MM-DD}.txt (reference logUtils.h:24-31)."""
    path = prefix + get_current_date_time("date") + ".txt"
    with open(path, "a") as f:
        f.write(message + "\n")
