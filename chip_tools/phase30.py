#!/usr/bin/env python3
"""chip_smoke.py's phase 30 alone, on one CUDA card: the multi-rank layer on
a world of one NCCL rank (the sharded fit at n=16384, the sharded fleet,
predictive and chunked sampler against their one-process calls, the dry
run), two gloo ranks on the one card (the sharded fit at n=8192, the fleet),
fit_sharded's time beside fit and the library's, and cho_solve_blocked
against two triangular solves.

    python3 chip_tools/phase30.py

Builds the kernels as chip_smoke.py does, then runs ``chip_smoke.phase_30``
and prints each kernel's launches on its paths.
"""

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
        print("phase30: no CUDA device", file=sys.stderr)
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
    for c in chip_smoke.phase_30(dev, smi, t32):
        for name, v in c.items():
            counts[name] = counts.get(name, 0) + v
    print("launches on phase 30's paths:", {k: v for k, v in counts.items() if v})
    return 0


if __name__ == "__main__":
    sys.exit(main())
