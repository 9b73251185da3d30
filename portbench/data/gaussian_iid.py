"""Data recipe ``gaussian_iid``: X (n, d) and Y (n, q) of independent N(0, 1)
entries, as bench.py:121-125 draws them, made on the device from the seed."""

from __future__ import annotations

import torch


def make(cfg: dict, seed: int, count: int, device) -> list:
    """``count`` datasets (X, Y) of the configuration's n, d, q and dtype;
    the same seed gives the same datasets."""
    n, d, q = cfg["n"], cfg["d"], cfg["q"]
    dtype = getattr(torch, cfg["dtype"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = []
    for _ in range(count):
        X = torch.randn((n, d), generator=gen, device=device, dtype=dtype)
        Y = torch.randn((n, q), generator=gen, device=device, dtype=dtype)
        out.append((X, Y))
    return out
