#!/usr/bin/env python3
"""chip_smoke.py's phase 29 alone, on one CUDA card: warp and filters at
image width, serve's per-frame CUDA graph on phase 28 (d)'s exact model,
drift over three 1024-frame windows and experiments on a small study.

    python3 chip_tools/phase28.py && python3 chip_tools/phase29.py

Phase 29 serves the model that phase 28 (d) learns under
chip_smoke_out/phase28, so phase 28 runs first, in the same checkout; without
its model this script stops.  Builds the kernels as chip_smoke.py does, then
runs ``chip_smoke.phase_29`` and prints each kernel's launches on its paths.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    import torch

    import chip_smoke
    from gpr_tpu_torch.ops import _cuda

    if not torch.cuda.is_available():
        print("phase29: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)} | {smi} | torch {torch.__version__}")
    if not os.path.exists(chip_smoke.P28_ROOT + "/exact-fast-ParameterFile.txt"):
        print(f"phase29: no phase 28 (d) model under {chip_smoke.P28_ROOT}; run chip_tools/phase28.py first",
              file=sys.stderr)
        return 1
    _cuda.build()
    _cuda.library()

    def t32(a):
        return torch.tensor(np.ascontiguousarray(a), dtype=torch.float32, device=dev)

    counts = {}
    for c in chip_smoke.phase_29(dev, smi, t32):
        for name, v in c.items():
            counts[name] = counts.get(name, 0) + v
    print("launches on phase 29's paths:", {k: v for k, v in counts.items() if v})
    return 0


if __name__ == "__main__":
    sys.exit(main())
