#!/usr/bin/env python3
"""chip_smoke.py's phase 28 alone, on one CUDA card: the sparse GP at
bench_sparse's shape, its log posterior, the learn -> predict apps and the
PCA at full image width.

    python3 chip_tools/phase28.py

Builds the kernels as chip_smoke.py does, then runs ``chip_smoke.phase_28``
and prints each kernel's launches on its paths.
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    import subprocess

    import torch

    import chip_smoke
    from gpr_tpu_torch.ops import _cuda

    if not torch.cuda.is_available():
        print("phase28: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)} | {smi} | torch {torch.__version__}")
    _cuda.build()
    _cuda.library()

    def t32(a):
        return torch.tensor(np.ascontiguousarray(a), dtype=torch.float32, device=dev)

    counts = {}
    for c in chip_smoke.phase_28(dev, smi, t32):
        for name, v in c.items():
            counts[name] = counts.get(name, 0) + v
    print("launches on phase 28's paths:", {k: v for k, v in counts.items() if v})
    return 0


if __name__ == "__main__":
    sys.exit(main())
