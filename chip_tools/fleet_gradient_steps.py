#!/usr/bin/env python3
"""Which step of the fleet's float32 MLL gradient adds its error, on one CUDA
card.

    python3 chip_tools/fleet_gradient_steps.py [--device cuda|cpu]

The fleet (B=4, n=256, d=3, q=2, per-member Gaussian hyperparameters; the
data of chip_tools/fused_backward_accuracy.py) takes mll_batched's gradient
on both fleet routes, fleet-crout (panel 128: K7 + a triangular solve for W,
batched GEMMs) and fleet-fused (panel 64: K9 forward; W re-derived by K8 on
D D^T in the backward).  Each route is run as it is, and then with one step
replaced by its float64 value rounded to float32:

    factor    L = chol(K) in float64
    alpha     alpha = K^-1 Y in float64 from the route's L
    W         the diagonal-block inverses the pullback uses, inv(D) in float64
    pullback  ops/batched.py::_fleet_pullback (the fleet solve of abar and the
              Murray pullback) in float64 from the float32 L, W and alpha

It prints each gradient's relative error against the float64 plain MLL, with
the plain float32 route's (torch.linalg.cholesky) beside it, and the error
of each route's L, alpha and W against float64.  On the card it then builds
a copy of the Crout sweep (csrc/crout.cuh, shared by K7, K8 and K9) whose
pivot scale is rsqrtf(pivot) (2 ulp) in place of the correctly rounded
1.0f / sqrtf(pivot), into a temporary library, and runs both routes on it as
they are: the sweep's pivot scale against the gradient's error.
"""

import argparse
import os
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    import torch

    import gpr_tpu_torch as tg
    from gpr_tpu_torch.gp import batched as fleet
    from gpr_tpu_torch.ops import batched as fops
    from gpr_tpu_torch.ops import crout

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = torch.device(ap.parse_args().device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1

    def rel(a, b):
        return float((a.double() - b.double()).abs().max() / b.double().abs().max())

    def blocks(L, p):
        nb = L.shape[-1] // p
        return torch.stack([L[:, i * p:(i + 1) * p, i * p:(i + 1) * p] for i in range(nb)], 1)

    swap = set()
    route = {"name": "crout"}

    class Steps(torch.autograd.Function):
        @staticmethod
        def forward(ctx, K, Y, panel):
            if route["name"] == "crout":
                L, W = fops.cholesky_batched(K, panel=panel, return_winv=True)
                alpha = fops.cho_solve_batched(L, Y, panel=panel, winv=W)
            else:
                L, alpha = fops.factor_solve_fused(K, Y, panel)
                W = None  # JAX's fused backward re-derives W from L
            Kf = torch.tril(K.double()) + torch.tril(K.double(), -1).mT
            if "factor" in swap:
                L = torch.linalg.cholesky(Kf).float()
                W = fops._tri_inverse(blocks(L, panel)) if W is not None else None
                alpha = fops.cho_solve_batched(L, Y, panel=panel, winv=W)
            if "alpha" in swap:
                alpha = torch.cholesky_solve(Y.double(), L.double()).float()
            if "W" in swap:
                W = torch.linalg.inv(blocks(L, panel).double()).tril().float()
            if "pullback" in swap and W is None:
                W = fops._tri_inverse(blocks(L, panel))
            ctx.save_for_backward(L, alpha, *(() if W is None else (W,)))
            ctx.panel = panel
            return L, alpha

        @staticmethod
        def backward(ctx, Lbar, abar):
            L, alpha, *W = ctx.saved_tensors
            W = W[0] if W else None
            if "pullback" in swap:
                Kbar, Ybar = fops._fleet_pullback(L.double(), W.double(), alpha.double(),
                                                  Lbar.double(), abar.double(), ctx.panel)
                return Kbar.float(), Ybar.float(), None
            return (*fops._fleet_pullback(L, W, alpha, Lbar, abar, ctx.panel), None)

    r1 = np.random.default_rng(22)
    X = r1.standard_normal((4, 256, 3))
    Y = np.sin(X.sum(-1, keepdims=True)) + 0.1 * r1.standard_normal((4, 256, 2))
    P0 = torch.tensor([[1.2, 0.9], [1.5, 1.0], [2.0, 1.1], [1.1, 1.2]], dtype=torch.float64,
                      device=dev)
    X32 = torch.tensor(X, dtype=torch.float32, device=dev)
    Y32 = torch.tensor(Y, dtype=torch.float32, device=dev)

    def grad(Xa, Ya, **kw):
        p = P0.to(Xa.device).requires_grad_()
        v = fleet.mll_batched(tg.Gaussian(p[:, 0], p[:, 1]), Xa, Ya, 0.1, batched_kernel=True, **kw)
        return torch.autograd.grad(v.sum(), p)[0]

    g64 = grad(X32.double(), Y32.double(), use_crout=False)
    g_plain = rel(grad(X32, Y32, use_crout=False), g64)
    g_cpu = rel(grad(X32.cpu(), Y32.cpu(), use_crout=False), g64.cpu())
    print(f"device {dev}: plain f32 route {g_plain:.3g}; plain f32 on the CPU {g_cpu:.3g}; "
          f"gate 3x CPU + 1e-6 = {3 * g_cpu + 1e-6:.3g}")
    orig = (fops.factor_solve_batched_diff, fops.factor_solve_fused_diff)
    fops.factor_solve_batched_diff = lambda K, Y_, panel=fops.PANEL: Steps.apply(K, Y_, panel)
    fops.factor_solve_fused_diff = lambda K, Y_, panel=fops.FUSED_PANEL: Steps.apply(K, Y_, panel)
    try:
        for name, max_n in (("crout", 0), ("fused", 1024)):
            route["name"] = name
            fops._FLEET_FUSED_MAX_N = max_n
            out = {}
            for s in ((), ("factor",), ("alpha",), ("W",), ("pullback",), ("alpha", "W", "pullback"),
                      ("factor", "alpha", "W", "pullback")):
                swap.clear()
                swap.update(s)
                out["+".join(s) or "as is"] = rel(grad(X32, Y32, use_crout=True), g64)
            if name == "crout":
                swap.clear()
                os.environ["GPR_FLEET_DIAG"] = "xla"
                out["GPR_FLEET_DIAG=xla (cholesky_ex for K7)"] = rel(grad(X32, Y32, use_crout=True), g64)
                del os.environ["GPR_FLEET_DIAG"]
                orig_k7 = fops.crout_chol
                fops.crout_chol = lambda D, out: out.copy_(crout.crout_chol_reference(D))
                try:
                    out["K7's plain version for K7"] = rel(grad(X32, Y32, use_crout=True), g64)
                finally:
                    fops.crout_chol = orig_k7
            print(f"fleet-{name}: gradient rel err vs f64, float64 step swapped in: "
                  + "; ".join(f"{k} {v:.3g}" for k, v in out.items()))
    finally:
        fops.factor_solve_batched_diff, fops.factor_solve_fused_diff = orig
        fops._FLEET_FUSED_MAX_N = 0
    if dev.type == "cuda":
        import ctypes
        import shutil
        import subprocess
        import tempfile

        from gpr_tpu_torch.ops import _cuda

        _cuda.library()
        with tempfile.TemporaryDirectory() as tmp:
            for src in _cuda.CSRC.glob("*.cu*"):
                shutil.copy(src, tmp)
            cuh = Path(tmp) / "crout.cuh"
            text = cuh.read_text()
            assert "1.0f / sqrtf(S[k * ld + k])" in text
            cuh.write_text(text.replace("1.0f / sqrtf(S[k * ld + k])", "rsqrtf(S[k * ld + k])"))
            lib = Path(tmp) / "lib.so"
            subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o", str(lib),
                            *[str(Path(tmp) / f) for f in ("gram.cu", "crout.cu", "fleet.cu", "fullchol.cu",
                                                            "syrk.cu", "solve.cu")]],
                           check=True, capture_output=True)
            saved_lib = _cuda._lib
            _cuda._lib = ctypes.CDLL(str(lib))
            _cuda._lib.gpr_error_string.argtypes = [ctypes.c_int]
            _cuda._lib.gpr_error_string.restype = ctypes.c_char_p
            try:
                out = {}
                for name, max_n in (("fleet-crout", 0), ("fleet-fused", 1024)):
                    fops._FLEET_FUSED_MAX_N = max_n
                    out[name] = rel(grad(X32, Y32, use_crout=True), g64)
                print("sweep pivot rsqrtf in place of 1.0f / sqrtf: gradient rel err vs f64: "
                      + "; ".join(f"{k} {v:.3g}" for k, v in out.items()))
            finally:
                _cuda._lib = saved_lib
                fops._FLEET_FUSED_MAX_N = 0

    # forward errors of each route's pieces against float64
    with torch.no_grad():
        K = fleet._fleet_gram(tg.Gaussian(P0[:, 0], P0[:, 1]), X32,
                              torch.full((4,), 0.01, device=dev), True)
        K64 = fleet._fleet_gram(tg.Gaussian(P0[:, 0], P0[:, 1]), X32.double(),
                                torch.full((4,), 0.01, device=dev, dtype=torch.float64), True)
        L64 = torch.linalg.cholesky(K64)
        a64 = torch.cholesky_solve(Y32.double(), L64)
        Lc, Wc = fops.cholesky_batched(K, return_winv=True)
        ac = fops.cho_solve_batched(Lc, Y32, winv=Wc)
        Lf, af, Wf = fops.factor_solve_fused(K, Y32, fops.FUSED_PANEL, return_winv=True)
        Lp = torch.linalg.cholesky(K)
        ap_ = torch.cholesky_solve(Y32, Lp)
        print(f"forward rel err vs f64: L crout {rel(Lc, L64):.3g}, fused {rel(Lf, L64):.3g}, "
              f"plain {rel(Lp, L64):.3g}; alpha crout {rel(ac, a64):.3g}, fused {rel(af, a64):.3g}, "
              f"plain {rel(ap_, a64):.3g}; W crout vs inv(own D) "
              f"{rel(Wc, torch.linalg.inv(blocks(Lc, fops.PANEL).double())):.3g}, fused "
              f"{rel(Wf, torch.linalg.inv(blocks(Lf, fops.FUSED_PANEL).double())):.3g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
