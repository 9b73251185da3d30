"""Data recipe ``breathing_trace``: a synthetic respiratory trace, delay
embedded as benchmarks/bench_serve.py:66-72 embeds the reference's
breathing1D.mat (which the repository does not hold).

The trace has n samples and follows the cos^(2k) breathing model of Lujan
et al. (Med. Phys. 1999), -depth cos(pi t / T)^(2 shape), one cycle after
another: each cycle lasts ``period`` samples times 1 + ``period_jitter``
tanh(N(0, 1)), and its depth is 1 + ``amplitude_jitter`` N(0, 1).  A slow
baseline ``drift`` (one sine over the trace, random phase) and white
``noise`` are added.
The trace is normalised to mean 0 and standard deviation 1, then
X[:, k] = roll(s, k) for k < d and Y[:, k] = roll(s, -k - 1) for k < q.
Every number is made on the device from the seed, in float32, and the
datasets are cast to the configuration's dtype.
"""

from __future__ import annotations

import math

import torch


def trace(cfg: dict, gen: torch.Generator, device) -> torch.Tensor:
    """One normalised trace of n samples."""
    n, rec = cfg["n"], cfg["data"]
    cycles = n // int(rec["period"]) + 2
    u = torch.randn((3, cycles), generator=gen, device=device, dtype=torch.float32)
    lengths = rec["period"] * (1.0 + rec["period_jitter"] * torch.tanh(u[0]))
    depth = 1.0 + rec["amplitude_jitter"] * u[1]
    # phase advances by 2 pi over each cycle's length
    t = torch.arange(n, device=device, dtype=torch.float32)
    ends = torch.cumsum(lengths, 0)
    starts = ends - lengths
    idx = torch.searchsorted(ends, t, right=True).clamp_(max=cycles - 1)
    phase = math.pi * (t - starts[idx]) / lengths[idx]
    s = -depth[idx] * torch.cos(phase) ** (2 * int(rec["shape"]))
    s = s + rec["drift"] * torch.sin(2.0 * math.pi * (t / n + u[2, 0]))
    s = s + rec["noise"] * torch.randn((n,), generator=gen, device=device, dtype=torch.float32)
    return (s - s.mean()) / s.std()


def make(cfg: dict, seed: int, count: int, device) -> list:
    """``count`` delay-embedded datasets (X (n, d), Y (n, q))."""
    d, q = cfg["d"], cfg["q"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = []
    for _ in range(count):
        s = trace(cfg, gen, device)
        X = torch.stack([torch.roll(s, k) for k in range(d)], dim=1).contiguous()
        Y = torch.stack([torch.roll(s, -k - 1) for k in range(q)], dim=1).contiguous()
        dtype = getattr(torch, cfg["dtype"])
        out.append((X.to(dtype), Y.to(dtype)))
    return out
