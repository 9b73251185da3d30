#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (gpr_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

It builds the hand-written kernels from gpr_tpu_torch/csrc with nvcc (one
process per source, in parallel), then:

  1. holds each kernel (K1 gram_tile, K2 panel_update, K3 diag_factor_inv,
     K4 panel_solve, K5 syrk_update, K6 gram_batched, K7 crout_chol, K8
     crout_chol_wi, K9 fleet_fused; K10-K14 in phases 14 and 18, K15-K18 in
     21, K19-K20 in 25) against its plain torch version on the card: small
     ragged shapes (K1 also on its tensor-core path at d = 64 and 128, n =
     200 x 150 and a lower triangle of 383 with nothing written above the
     diagonal), the contracts of the fused factorization, each kernel at
     the shapes the n=16384 fit gives it, K5 (lower triangle, in place on
     views of row stride 16383) at a ragged shape and at the top-level
     trailing updates of n=3773 and n=16383, K6 on all 7 forms with per-member parameters at B=3, n=200,
     d=37 and at the fleet's full widths (B=128, n=512 and B=256, n=1024,
     exactly symmetric), K7 and K8 at b = 32, 64, 33 and 128
     with NaN above the diagonal and one member that is not positive definite
     (K8 strided, in place), on the fleet's first diagonal block, and K8 on
     the fused backward's D D^T tiles; K9 at B=3, n = 128, 256, 384, q = 1
     and 4 with a failed member, and at the fleet's full width;
  2. fits the bench model, Gaussian(8, 1) with sigma 0.1 at n=16384, d=128,
     q=8 (route "fused-gram"), and predicts mean and credible interval at
     1024 points;
  3. fits the model of __graft_entry__.entry(), Sum(Gaussian(1.5, 1), White(0.1)), at
     n=4096, d=8, q=4 (route "fused-matrix") and predicts at 64 points;
  4. fits at unaligned n: 3773 (Gram mode with pad masking) and 384 (route
     "gram-kernel");
  5. runs the reference's sinus gate;
  6. trains at the breathing shape (n=3773, d=5, q=3, float32): 5 fit_mle
     and 3 fit_map steps (LogGaussian prior) from Gaussian(2, 1), sigma 0.1,
     on route "blocked-syrk" (K5 in every factorization), then fit +
     predict with the learned kernel;
  7. runs one marginal-likelihood value + gradient at full width, n=16384,
     d=128, q=8 (route "fused-matrix": K2-K4 under the Murray backward),
     and one at n=16383 (route "blocked-syrk": K5 at full width);
  8. fits fleets (route "fleet-crout": K6, then K7 once per panel step):
     Gaussian(2, 1), sigma 0.1, B=128, n=512, d=8, q=4 (the data of
     benchmarks/bench_batched.py) with predict and variance at 64 points per
     member; B=256, n=1024; per-member sigma; an 8-member lengthscale grid
     (batched kernel) with its marginal likelihoods; and n=500, which takes
     "torch-cholesky" and launches no K7;
  9. runs the fleet's value + gradient (mll_batched with per-member
     hyperparameters) at B=128, n=512 and 5 steps of fit_mle_batched;
 10. times the n=16384 fit against the plain torch fit, each fused kernel's
     total per fit against its plain version's, value + gradient at the
     three training shapes against the plain float32 route, K5's total per
     n=16383 factorization against its plain version and torch.addmm, and
     the blocked-syrk factorization against torch.linalg.cholesky; the
     fused-gram factorization whole (its lookahead overlaps K3 and K4 with
     the next panel's products, which per-launch events cannot time), and a
     torch.profiler trace of one bench fit: device time by kernel, the
     card's idle share, the factorization's and cho_solve_panels' spans and
     busy time, and how much of each K3 launch ran under the products;
 11. times the fleet fit at both sizes and the fleet value + gradient
     against the plain float32 route, K6 per fit (and at B=256, n=1024)
     queued behind a device sleep against its plain version and the torch
     composition (batched torch.cdist, square, scale, exp, diagonal), K7 per
     fit against its plain
     versions (K7 also against torch.linalg.cholesky_ex on the same tiles),
     the fleet fit at panels 32, 64 and 128 (B=128, n=512) and 64 and 128
     (B=256, n=1024), and traces 5 fleet fits with torch.profiler (device
     time by kernel and idle share);
 12. with the fused fleet on (ops.batched._FLEET_FUSED_MAX_N = 1024 for the
     phase), fits at B=128, n=512 and B=256, n=1024 (route "fleet-fused":
     K6, then one K9 launch), runs phase 9's value + gradient (one K8 launch
     in the backward) and 5 fit_mle_batched steps; then a fleet fit under
     GPR_FLEET_DIAG=crout (one K8 launch per panel step, no K7);
 13. times the fused fit against the panel-stepped fit and the plain route
     at both sizes, K9 alone at panels 64 and 128, the fused value + gradient
     against the panel-stepped one, K9 per fit against its plain version and
     cholesky_ex + cholesky_solve, K8 per fit under GPR_FLEET_DIAG=crout
     against K7 + the triangular solve, its plain version and cholesky_ex +
     solve_triangular, K8 on the D D^T tiles, and traces 5 fused fits;
 14. holds K10 narrow_subst and K11 diag_tri_inv (csrc/solve.cu) against
     their plain versions: the sweeps at n=16384 (q = 1, 8, 128 at bs 512; 8
     at bs 1024, K11 by pairs) and n=4096 (q = 3), K11 at bs 256 and 512,
     junk above the diagonal, NaN in L;
 15. under GPR_SOLVE_SCHEDULE=narrow and GPR_SOLVE_DIAGINV=pallas fits the
     bench model at n=16384 (route "fused-matrix", alpha by the narrow solve),
     takes the credible interval at 128 points (a narrow solve with q = 128)
     and one MLL value + gradient (a narrow solve forward and one in its
     backward), each with exact K10 / K11 launch counts;
 16. drives the sliding window under the same switches: fit at n=4096 (d=5,
     q=3), extend by the newest 512, shrink by the oldest 512, predict and
     credible interval at 64 points, loo_cv; each held against a fresh float64
     fit of its window; then times shrink by 64 at n=3773 against a refit;
 17. times K10 per solve at n=16384 (q=8) against its bound, its plain
     version, torch.cholesky_solve and the port's cho_solve_panels, K11
     against its plain version and the batched triangular solve (beside its
     first design's time), and the narrow fit and MLL against the default
     triangular solves;
 18. prints how many of K12's thread-block clusters (n / 64 CTAs, 16 at
     n = 1024) the card places at once, then holds K12 leaf_chol, K13
     leaf_chol_wi and K14 tri_inv_leaf (csrc/leaf.cu) against their plain
     versions at n = 256, 512, 768 and 1024, each on a strided view with NaN
     above the diagonal (K12 bit-identical to its factor of the lower
     triangle alone; K13's factor bit-identical to K12's, whose cluster
     kernel it launches before K14's persistent inverse, and its W to K14's
     of that factor; K12 and K13 in
     place), and a leaf that is not positive definite;
 19. under GPR_CHOL_LEAF_INV=1 trains at the breathing shape (phase 6's
     steps, route "blocked-syrk-leaf": two K13 launches per factorization),
     fits and predicts with the learned kernel; then, with
     GPR_CHOL_SCHEDULE=recursive as well, fits the bench model (route
     "gram-kernel", 16 K13 launches) with a 128-point credible interval and
     runs the MLL value + gradient at n=16384 and 16383 (16 and 15 launches);
 20. times K12 at n = 256, 512 and 1024 (each call queued behind a device
     sleep, then with the host's enqueue), K13 and K14 per 1024-leaf the
     same way, against
     their plain versions and torch.linalg.cholesky_ex (+ solve_triangular
     against I), the n=16384
     blocked factorization with and without the switch against
     torch.linalg.cholesky, and the bench fit and MLL with and without it;
 21. holds K15 panel_factor and K17 panel_inplace (csrc/panel.cu: K17 runs
     K15's cluster diagonal kernel on the lower triangle and its rows kernel,
     in place), K16 rank_update_tiles and K18 zero_upper (csrc/inplace.cu)
     against their plain versions: K16 on JAX's tile lists and on the schedule's narrow and wide
     lists at n=4096, K17 at tile columns 0 and 8 with NaN above its diagonal
     tile, K18 bit-exact against torch.tril at n = 2048, 4096, 4608 and
     16384, K15 at (1024, 256) and (8192, 256) (NaN below its diagonal tile
     bit-identical, two calls bit-equal); the whole
     in-place schedule at n = 1024, 2048, 4096 with NaN and 1234.0 above the
     diagonal (bit-identical factors), a failed pivot, the jitter escalation;
 22. under GPR_CHOL_SCHEDULE=inplace fits the bench model (route
     "gram-kernel" -> "inplace": 64 K17, 63 K16, 1 K18 launches) with a
     128-point credible interval, runs the MLL value + gradient at n=16384
     ("inplace") and 16383 ("blocked-syrk"), trains at the window's shape
     (n=4096, d=5, q=3: 5 fit_mle + 3 fit_map steps, 16 / 15 / 1 launches a
     factorization), fits and predicts with the learned kernel, then extend
     by 512, shrink by 512 and a refit of the 4608 window (18 / 17 / 1);
 23. factors the bench K at n=8192 by cholesky_panels and
     cholesky_left_panels (32 K15 launches each) against float64;
 24. times K16-K18 per n=16384 factorization (K16's and K17's calls queued
     behind a device sleep; K17 split into its diagonal-tile and rows
     kernels by torch.profiler) and K15 per left-looking n=8192
     factorization (queued behind a device sleep and with the host's
     enqueue; split the same way) against their plain versions and library calls, the
     n=16384 factorization on "inplace" against "blocked-syrk",
     "fused-matrix" and torch.linalg.cholesky, and the bench fit and MLL on
     "inplace" against the default routes, and the ten slowest of K16's 63
     calls with their grids;
 25. holds K19 tile_chol and K20 tile_chol_strips (csrc/chol.cu) against
     their plain versions at n = 1, 32, 64, 128, 200 (K19 only), 256 and 512,
     K20 at sw 8 and 16: NaN below the diagonal (bit-identical factors), an
     exact-zero upper, ||L L^T - A|| / ||A||, a failed pivot, n % sw; then the
     leaf dispatcher leaf_cholesky (one K19 launch at n=512 float32, none at
     513, on float64 or on the CPU);
 26. times K19 and K20 (sw 8 and 16) at n=256 and 512 in turns with their
     plain versions and torch.linalg.cholesky_ex, beside their bounds: each
     call queued behind a device sleep, and each with the host's enqueue;
 27. runs the samplers on bench_hmc's posterior (Gaussian(1, 1), sigma 0.1,
     n=512, d=1, q=1, X = linspace(0, 10), Y = sin + 0.1 N(0, 1), float32),
     the chains one fleet of GPs on route "fleet-crout": (a) the log
     posterior's value + gradient at 16 chains over [-1, 1]^2 (one K7 launch
     per 128-panel) against float64, and a chain forced singular (sigma 0)
     that the safe fleet factor retries alone with jitter; (b) sample_hmc,
     16 chains, L=16, warmup 128, 64 draws, its posterior mean held to a
     use_crout=False run within 4 Monte Carlo standard errors, and the
     sampling stage timed by resume_hmc from its checkpoint (samples/s,
     leapfrog evaluations/s); (c) sample_nuts, 8 chains at n=256, warmup
     128, 32 draws, max_depth 6, then draws/s at max_depth 4, 6 and 8; (d)
     predictive_from_hmc on 32 of (b)'s draws at 1024 points (K6 once, K7 per
     panel), mean and variance against float64, and its latency; (e)
     fit_advi, 200 steps of 8 samples, its mean within 3 posterior sd of
     (b)'s; (f) with the fused fleet on (route "fleet-fused"), (a)'s value +
     gradient (K9 forward, K8 backward) and (d) (K6, K9); then traces one HMC
     and one NUTS transition with torch.profiler for the card's idle share;
 28. runs the sparse GP, its log posterior, the learn -> predict apps and
     the PCA at full width (``phase_28``, sizes in ``P28``;
     chip_tools/phase28.py runs it alone): (a) at bench_sparse's shape
     (benchmarks/bench_sparse.py:45-58: Gaussian(2, 1), sigma 0.3, jitter
     1e-4, n=16384, d=8, q=4, Z = X[::n // m][:m]) fit_sparse at m=512
     (route torch-cholesky) and 1024 (fused-matrix: K2-K4), the mean at 1024
     points, the credible interval at 64, the likelihood's value + gradient,
     the inducing gradient and the Titsias bound, each against the plain
     sparse GP in float64 and float32 (torch Gram, cholesky_ex with
     safe_cholesky's jitter schedule, cholesky_solve), the jitter each took,
     and CUDA-event times of the fit and of the value + gradient beside the
     exact fit at the same n; (b) optimize_inducing and fit_svgp at n=4096,
     m=256, 20 Adam steps each (the trace finite and ending above its
     start); (c) the sparse log posterior of 16 chains on a 4 x 4 grid of z
     over [-1, 1]^2, n=16384, m=512 (route fleet-crout: K7 once a panel of
     each factorization of the 32-member fleet) against the plain one a
     chain at a time; (d) learn -> predict through main(argv) on a synthetic
     breathing dataset written under chip_smoke_out/phase28 (3773 training
     and 64 test frames, tests/test_apps.py's recipe with 64 x 64 US frames
     and 3 x 16^3 DVFs, cut from full image size so that ~7.7k files write
     and parse within the phase): the exact mode (route fused-gram: K2-K4 in
     learn), sparse_inducing 512 and tests/test_ar_pipeline.py's perform_ar
     configuration, each in float32 and under the parity policy (float64)
     on the card; the predicted DVFs of each float32 run held to the float64
     run's beside the plain float32 chain (the port's PCA, then the plain
     GP), and the per-frame predict latency (the median of
     -latestInferenceTime.txt); (e) fit_pca's Gram trick at d = 3 * 64^3,
     N = 1024 in float32 against float64 (64 modes 100 * 0.95^k over noise
     1e-3; fit_pca runs no kernel of the port, so its plain float32 route is
     itself: the bounds are stated, max |d sigma| <= 8 sqrt(eps32) sigma_1
     for every mode, the null one included, and the rank-64 reconstruction
     within 1e-3), timed;
 29. runs the image pipeline, the serving loop and the study apps
     (``phase_29``, sizes in ``P29``; chip_tools/phase29.py runs it alone):
     (a) warp_array of a 64^3 float32 volume by a smooth field of up to 3
     voxels at order 3 (mirror) and at orders 0-1 in all five modes, each
     against scipy.ndimage.map_coordinates in float64 where scipy's mode is
     the same function and against the port's float64 CPU run elsewhere,
     within 3x the error of the port's float32 CPU run (or 2 eps), timed;
     (b) on phase 28's 3773 x 64 x 64 US series gaussian_smoothing
     slice-wise at variance 4, image_pyramid_series at 3 scales and
     histogram_matching of one frame onto another, the same gate against the
     port's float64 CPU run, and median_filter r=1 on a 64^3 volume equal to
     scipy's median_filter(mode='nearest'), timed; (c) serve: phase 28 (d)'s
     exact float32 model (n=3773, d=5, q=3) serves its 64 test frames through
     watch(), one CUDA-graph replay and one host read a frame (replays
     counted; torch.profiler sees a frame as one cudaGraphLaunch, no kernel
     launch, one copy in, one device-to-host copy out and one
     cudaStreamSynchronize), the graph's packed output equal to the same Server's eager
     program bit for bit (or within 2 float32 ulp), its DVFs within 3x phase
     28 (d)'s float32 error of predict's DVFs for the same frames, and the
     per-frame latency with the graph, eagerly and on predict's _packed path;
     (d) run_drift_config over three 1024-frame windows of phase 28's data
     (route fused-gram: K2-K4 in each window's learn) and run_experiment_config
     on a small study it writes (8 MiniDicom files for the preprocessing
     stage, then the split, regression and evaluation), each on the card in
     float32 and on the CPU in float64, each window's and the study's DVFs
     held to the CPU's within 3x the plain float32 chain's error on the same
     training frames (plain_app, or 2 eps), the percentiles printed beside,
     with each stage's wall time;
 30. runs the multi-rank layer (``phase_30``, sizes in ``P30``;
     chip_tools/phase30.py runs it alone): (a) on a world of one NCCL rank
     (parallel.sharded_gram.default_mesh) fit_sharded of the bench model at
     n=16384 (K5 in each diagonal block's cholesky_blocked, its launches
     counted and its wrapper's calls timed by CUDA events in a warm fit, its
     peak device memory beside its block row), alpha and logdet against
     float64 within 3x the plain float32 route's error (or 2 eps);
     fit_batched_sharded at B=128, n=512 (K6, K7) and
     predictive_sharded with 32 draws at n=512 and 1024 points (K6, K7), each
     bit for bit its one-process call (or within 3x); 16 chains of
     sample_hmc_sharded_chunked on bench_hmc's posterior (K7) draw for draw
     sample_hmc_chunked's; dryrun_multichip(1); (b) two gloo ranks on the one
     card (gloo takes CUDA tensors for the collectives the port uses; NCCL
     refuses two ranks on one card), this script started twice with
     --phase30-rank: fit_sharded at n=8192 (block rows of 4096, K5) within 3x
     the plain float32 error, with each rank's peak device memory, the fleet
     of (a) at 64 members a rank against (a)'s one-process fleet, and (a)'s
     16 chains of sample_hmc_sharded_chunked at 8 a rank draw for draw (a)'s
     sample_hmc_chunked whose log posterior takes 8 chains a call (cuBLAS's
     batched products round with the batch's size, which (a) prints); (c)
     fit_sharded's time beside fit and torch Gram + linalg.cholesky +
     cholesky_solve at n=16384; (d) ops.blocked.cho_solve_blocked against two
     torch.linalg.solve_triangular on a row-major factor at n=16384, q = 8,
     128 and 16384 (the data of linalg.cho_solve's dispatch).

Phase 4's fit and phase 6's training steps are the standing check at the
breathing-fixture shape: their gates go to chip_smoke_out/breathing_check.json
(gitignored), summed up on one line.

Phases 2-4, 6, 8, 12, 19, 22, 27 and 28 hold the port's mean and credible interval against a
float64 torch reference and pass when the port's error is at most 3x that
of the plain float32 torch route (torch Gram, torch.linalg.cholesky,
cholesky_solve; for fleets also variance and alpha; for phase 27's mixture
predictive its mean and variance).  Phases 6, 7, 9, 12, 22 and 27
hold each value and gradient of the marginal likelihood (at each training
step's parameters; phase 15 too; in 27 the log posterior) against a float64
plain torch MLL (torch.linalg.cholesky
+ autograd) with the same 3x gate against the plain float32 MLL.  The launch
counters are reset before each path (phases 2-5, 6, 7, 8-9, each of
phase 12's four, 15's two, 16, 19's four, 22's seven, 23's two, 25's
dispatcher, 27's seven, 28's seven, 29's one, 30's five and two in each
rank of 30 (b)) and read after it: each kernel of the path must have been
launched there.  Any failure raises.  The last lines are the kernels' JSON, the card's name and power
limit, then one JSON object with the device.  Exits non-zero, printing no result, where there is no CUDA device.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np


LDBL_LOG_MAX = 11356.523406294143  # log of the largest 80-bit long double
BREATHING_JSON = "chip_smoke_out/breathing_check.json"  # gitignored


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {msg}")


def relerr(a, b):
    a, b = a.double().to(b.device), b.double()
    return float((a - b).abs().max() / b.abs().max())


def gate(port, plain, ref):
    """The accuracy protocol: the port's float32 result and the plain float32
    route's, each as its max relative error against the float64 reference;
    the port passes within 3x the plain route's error (ADVICE.md:5)."""
    e, p = relerr(port, ref), relerr(plain, ref)
    return {"err": e, "plain_f32_err": p, "limit": 3 * p, "ok": e <= 3 * p}


def gate32(port, plain, ref):
    """:func:`gate` with a floor at float32's resolution: a result is not
    held closer to float64 than two float32 ulps of its largest entry
    (2 eps relative), where the plain route's error is below one by the luck
    of its rounding (a sum of 16384 terms near 1e5 is exact to ~1 ulp)."""
    g = gate(port, plain, ref)
    g["limit"] = max(g["limit"], 2 * float(np.finfo(np.float32).eps))
    g["ok"] = g["err"] <= g["limit"]
    return g


def gaussian64(A, B, sigma, scale):
    """Gaussian Gram matrix k(A, B) in the dtype of A."""
    d2 = (A * A).sum(1)[:, None] + (B * B).sum(1)[None, :] - 2.0 * (A @ B.T)
    return scale * scale * (-0.5 * d2.clamp(min=0.0) / (sigma * sigma)).exp()


def plain_mixture(X, Y, Xs, theta, sigma):
    """The mixture predictive's mean and variance by the straightforward
    GP per draw in the dtype of X (predictive.py:67-90's formulas)."""
    import torch

    means, vars_ = [], []
    for l_, s_ in theta.to(X.dtype):
        K = gaussian64(X, X, l_, s_) + sigma * sigma * torch.eye(X.shape[0], dtype=X.dtype,
                                                                  device=X.device)
        L = torch.linalg.cholesky(K)
        Ks = gaussian64(Xs, X, l_, s_)
        means.append(Ks @ torch.cholesky_solve(Y, L))
        v = s_ * s_ - (Ks * torch.cholesky_solve(Ks.T, L).T).sum(1) + sigma * sigma
        vars_.append(v.clamp(min=0.0))
    means, vars_ = torch.stack(means), torch.stack(vars_)
    mix = means.mean(0)
    q_ = means.shape[-1]
    spread = ((means ** 2).sum(-1) / q_).mean(0) - (mix ** 2).sum(-1) / q_
    return mix, vars_.mean(0) + spread.clamp(min=0.0)


def plain_gp(X, Y, Xs, kfun, kss, sigma):
    """Mean, credible interval, alpha and K + sigma^2 I of the straightforward
    exact GP in the dtype of X: torch Gram, torch.linalg.cholesky,
    cholesky_solve."""
    import torch

    K = kfun(X, X)
    K.diagonal().add_(sigma * sigma)
    L = torch.linalg.cholesky(K)
    alpha = torch.cholesky_solve(Y, L)
    Ks = kfun(Xs, X)
    var = kss - (Ks * torch.cholesky_solve(Ks.T, L).T).sum(1)
    return Ks @ alpha, 2.0 * torch.sqrt(var.clamp(min=0.0)), alpha, K


def fit_gates(gp, X, Y, Xs, kfun, kss, sigma):
    """The protocol on a fitted port GP: its mean, credible interval and alpha
    at Xs against the plain GP in float64, beside the plain GP in float32."""
    m64, c64, a64, _ = plain_gp(X.double(), Y.double(), Xs.double(), kfun, kss, sigma)
    m32, c32, a32, _ = plain_gp(X, Y, Xs, kfun, kss, sigma)
    return {"mean": gate(gp.predict(Xs), m32, m64),
            "credible_interval": gate(gp.credible_interval(Xs), c32, c64),
            "alpha": gate(gp.alpha, a32, a64)}


# ---------------------------------------------------------------------------
# phase 28: the sparse GP, its log posterior, the learn -> predict apps, PCA
# ---------------------------------------------------------------------------

def events_ms(fn, reps):
    """Median of CUDA events around fn over ``reps`` calls, after one warm-up."""
    import torch

    fn()
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return float(np.median(out))


def plain_chol(A):
    """(L, jitter): torch.linalg.cholesky_ex, retried on failure with
    safe_cholesky's schedule (eps * max(mean |diag|, 1), then 10x a try)."""
    import torch

    L, info = torch.linalg.cholesky_ex(A)
    if int(info) == 0:
        return L, 0.0
    jit = torch.finfo(A.dtype).eps * max(float(A.detach().diagonal()[:1024].abs().mean()), 1.0)
    eye = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    for _ in range(6):
        L, info = torch.linalg.cholesky_ex(A + jit * eye)
        if int(info) == 0:
            return L, jit
        jit *= 10.0
    raise RuntimeError("chip_smoke: FAILED: a plain factorization failed at every jitter")


def plain_sparse(Z, X, Y, ls, sc, sigma, jitter, Xs=None, Xc=None):
    """The straightforward sparse GP of gp/sparse.py's algebra with a Gaussian
    kernel (lengthscale ls, scale sc) in the dtype of X: torch Gram,
    plain_chol, cholesky_solve; differentiable where ls, sc or Z carry a
    graph.  Returns the likelihood's value (q,) and scalar, the Titsias
    bound, the mean at Xs, the credible interval at Xc and the jitters."""
    import torch

    n, m = X.shape[0], Z.shape[0]
    s2 = sigma * sigma
    Kmm = gaussian64(Z, Z, ls, sc) + jitter * torch.eye(m, dtype=X.dtype, device=X.device)
    Knm = gaussian64(X, Z, ls, sc)
    Lmm, j_mm = plain_chol(Kmm)
    Li, j_in = plain_chol(Kmm + Knm.T @ Knm / s2)
    t = Knm.T @ Y
    CinvY = (Y - Knm @ torch.cholesky_solve(t / s2, Li)) / s2
    df = -0.5 * (Y * CinvY).sum(0)
    cp = -0.5 * (n * math.log(s2) + 2 * torch.log(Li.diagonal()).sum() - 2 * torch.log(Lmm.diagonal()).sum())
    ct = -n / 2.0 * math.log(2 * math.pi)
    scalar = df.sum() + cp + ct
    V = torch.linalg.solve_triangular(Lmm, Knm.T, upper=False)
    out = {"value": df + cp + ct, "scalar": scalar, "jitter": (j_mm, j_in),
           "elbo": scalar - (n * sc * sc - (V * V).sum()) / (2 * s2)}
    if Xs is not None:
        out["mean"] = gaussian64(Xs, Z, ls, sc) @ (torch.cholesky_solve(t, Li) / s2)
    if Xc is not None:
        Kc = gaussian64(Xc, Z, ls, sc)
        var = (sc * sc - (Kc * torch.cholesky_solve(Kc.T, Lmm).T).sum(1)
               + (Kc * torch.cholesky_solve(Kc.T, Li).T).sum(1))
        out["ci"] = 2.0 * torch.sqrt(var.clamp(min=0.0))
    return out


def residual_gate(L, Lp, A64):
    """The backward error ||F F^T - A||_F / ||A||_F of the port's factor L
    beside the plain factor Lp's, for one matrix or a fleet (the fleet's
    largest), A in float64; passes within 3x the plain error."""
    import torch

    def resid(F):
        F = F.double()
        return float((torch.linalg.matrix_norm(F @ F.mT - A64) / torch.linalg.matrix_norm(A64)).max())

    r, rp = resid(L), resid(Lp)
    return {"err": r, "plain_f32_err": rp, "limit": 3 * rp, "ok": r <= 3 * rp}


def launches_since(c0):
    from gpr_tpu_torch.ops import _cuda

    return {k: v - c0[k] for k, v in _cuda.launch_counts().items() if v != c0[k]}


def factor_gates(A, jm, port, plain):
    """A factorization route's kernels against the route's plain torch
    version on the identical float32 matrix (or fleet) A + jm I, on the card:
    ``port(Aj)`` -> (L, jitter), ``plain(Aj)`` -> L.  jm is 10x the largest
    jitter the route or torch's Cholesky needed on A (0 where none did), so
    both factor at the first attempt.  Returns the port's launches and the
    gates, each within 3x the plain version's error: the backward error of
    L L^T, and L against float64's factor; with torch's ``cholesky_ex``
    beside them."""
    import torch

    from gpr_tpu_torch.ops import _cuda
    from gpr_tpu_torch.ops import linalg as tlin

    Aj = tlin.add_diagonal(A, jm)
    c0 = _cuda.launch_counts()
    L, j = port(Aj)
    torch.cuda.synchronize()
    launches = launches_since(c0)
    Lr = plain(Aj)
    Lc, info = torch.linalg.cholesky_ex(Aj)
    check(bool((j == 0).all()) and bool(torch.isfinite(Lr[..., -1, -1]).all()) and bool((info == 0).all()),
          f"factor check at jitter {jm}: the port retried {int((j != 0).sum())}, the plain version failed "
          f"{int((~torch.isfinite(Lr[..., -1, -1])).sum())}, cholesky_ex {int((info != 0).sum())}")
    A64 = Aj.double()
    L64 = torch.linalg.cholesky(A64)
    return launches, {"LL^T": residual_gate(L, Lr, A64), "L": gate(L, Lr, L64),
                      "cholesky_ex LL^T": residual_gate(Lc, Lr, A64), "cholesky_ex L": gate(Lc, Lr, L64)}


def factor_check(A):
    """``safe_cholesky`` (K2-K4 on ``fused-matrix``) on a float32 matrix
    against ``fused_cholesky_reference``, the plain version of its steps
    (see :func:`factor_gates`); returns jm, the launches and the gates."""
    from gpr_tpu_torch.ops import fullchol
    from gpr_tpu_torch.ops import linalg as tlin

    jm = 10.0 * max(float(tlin.safe_cholesky(A)[1]), plain_chol(A)[1])
    return (jm, *factor_gates(A, jm, tlin.safe_cholesky, lambda Aj: fullchol.fused_cholesky_reference(Aj)[0]))


def fleet_factor_check(K, panel):
    """The sparse log posterior's fleet factor (``factor_solve_safe`` on
    ``fleet-crout``: K7 on the diagonal blocks) on a fleet K (B, m, m)
    against the same panel sweep with K7's plain version (see
    :func:`factor_gates`), each member at its own jitter."""
    import torch

    from gpr_tpu_torch.ops import batched as fbatched
    from gpr_tpu_torch.ops import crout as fcrout

    Y = torch.zeros(K.shape[0], K.shape[-1], 1, dtype=K.dtype, device=K.device)
    jm = 10.0 * torch.maximum(fbatched.factor_solve_safe(K, Y, "fleet-crout", panel)[2],
                              fbatched.factor_solve_safe(K, Y, "torch-cholesky")[2])

    def plain_diag(D, out):
        L = out.copy_(fcrout.crout_chol_reference(D))
        return L, fbatched._tri_inverse(L)

    def port(Kj):
        L, _, j = fbatched.factor_solve_safe(Kj, Y, "fleet-crout", panel)
        return L, j

    return (jm, *factor_gates(K, jm, port, lambda Kj: fbatched.cholesky_batched(Kj, panel=panel,
                                                                                diag=plain_diag)))


def write_breathing_dataset(root, n_train, n_test, hw, dvf_shape, seed=0):
    """tests/test_apps.py's synthetic_dataset at other sizes, written with the
    port's imageio as float32 VTK: hw x hw 'US' frames whose intensity
    pattern moves with a phase of 12 frames a breath, and 3-component DVFs
    (sin, 0.5 cos, 0.25 sin 2 of the phase, noise 0.005) that follow it."""
    from gpr_tpu_torch.pipeline import imageio as tio

    rng = np.random.default_rng(seed)
    yy = np.mgrid[0:hw, 0:hw][0]
    paths = {}
    for split, count, start in (("train", n_train, 0), ("test", n_test, n_train)):
        us_dir, dvf_dir = os.path.join(root, split, "us"), os.path.join(root, split, "dvf")
        os.makedirs(us_dir)
        os.makedirs(dvf_dir)
        for i, ph in enumerate(2 * np.pi * np.arange(start, start + count) / 12.0):
            us = np.clip(127 + 100 * np.sin(2 * np.pi * yy / hw + ph) + rng.normal(0, 1.0, (hw, hw)), 0, 255)
            base = np.stack([np.full(dvf_shape, np.sin(ph)), np.full(dvf_shape, 0.5 * np.cos(ph)),
                             np.full(dvf_shape, 0.25 * np.sin(2 * ph))], axis=-1)
            dvf = base + rng.normal(0, 0.005, base.shape)
            tio.write_image(tio.Image(us.astype(np.float32), (1, 1), (0, 0)), f"{us_dir}/us{i:05d}.vtk")
            tio.write_image(tio.Image(dvf.astype(np.float32), (1, 1, 1), (0, 0, 0), ncomponents=3),
                            f"{dvf_dir}/df{i:05d}.vtk")
        paths[split] = (us_dir, dvf_dir)
    return paths


AR_P = 2  # tests/test_ar_pipeline.py's configuration: AR order = frames a sweep
AR_CONFIG_MODEL = {"perform_ar": True, "n_inputModes": 4, "n_outputModes": 3, "ar_n": 1, "ar_p": AR_P,
                   "kernel_string": "GaussianKernel(2, 1,)", "data_noise": 0.01}
AR_CONFIG_LEARN = {"use_precomputed": False, "n_trainImgs": 0, "start_trainInd": 0,
                   "ar_batchSizeTrain": [AR_P], "ar_batchRepetitionTrain": [10],
                   "ar_batchSizeTest": [AR_P], "ar_batchRepetitionTest": [4],
                   "ar_onePredictionPerBatchTest": True, "ar_batchSize": [AR_P],
                   "ar_batchRepetition": [16], "ar_onePredictionPerBatch": True}
AR_CONFIG_PREDICT = {"use_precomputed": False, "compute_groundtruth_features": False,
                     "ar_batchSize": [AR_P], "ar_batchRepetition": [6], "ar_onePredictionPerBatch": True}


def write_ar_dataset(root, seed=0):
    """tests/test_ar_pipeline.py's ar_dataset: sweeps of 2 frames (10 x 10),
    one DVF (2 x 3 x 4) a sweep at the phase one frame past its end; 16
    training and 6 test sweeps, 10 and 4 AR sweeps."""
    from gpr_tpu_torch.pipeline import imageio as tio

    rng = np.random.default_rng(seed)
    dphi = 2 * np.pi / 10
    yy = np.mgrid[0:10, 0:10][0]
    dirs = {}
    for name in ("us_train", "us_test", "dvf_train", "dvf_test", "ar/train", "ar/test"):
        dirs[name] = os.path.join(root, name)
        os.makedirs(dirs[name])

    def dvf_frame(ph):
        return np.stack([np.full((2, 3, 4), np.sin(ph)), np.full((2, 3, 4), 0.6 * np.cos(ph)),
                         np.full((2, 3, 4), 0.3 * np.sin(ph))], axis=-1)

    def sweeps(us_dir, dvf_dir, count, phase0):
        for s in range(count):
            base = phase0 + s * AR_P * dphi
            for f in range(AR_P):
                us = np.clip(127 + 100 * np.sin(2 * np.pi * yy / 10 + base + f * dphi)
                             + rng.normal(0, 0.5, (10, 10)), 0, 255)
                tio.write_image(tio.Image(us, (1, 1), (0, 0)), f"{us_dir}/us{s * AR_P + f:05d}.vtk")
            if dvf_dir is not None:
                dvf = dvf_frame(base + AR_P * dphi) + rng.normal(0, 0.003, (2, 3, 4, 3))
                tio.write_image(tio.Image(dvf, (1, 1, 1), (0, 0, 0), ncomponents=3), f"{dvf_dir}/df{s:05d}.vtk")

    sweeps(dirs["us_train"], dirs["dvf_train"], 16, 0.0)
    sweeps(dirs["us_test"], dirs["dvf_test"], 6, 1.234)
    sweeps(dirs["ar/train"], None, 10, 0.321)
    sweeps(dirs["ar/test"], None, 4, 2.1)
    return dirs


def plain_app(learn_dirs, test_us, cm, dev, ar=None, window=None):
    """The learn -> predict chain computed straightforwardly in float32 on
    the card: the port's PCA (plain torch; no kernel of the port), then the
    plain GP (torch Gram, plain_chol, cholesky_solve) or plain_sparse, and
    for AR a per-feature pinv least squares with one prediction a batch.
    ``window`` (start, n) trains on frames start .. start + n - 1 only, as
    learn's ``start_trainInd`` / ``n_trainImgs`` do without AR.  Returns the
    predicted DVFs (features, frames)."""
    import torch

    from gpr_tpu_torch.pipeline import dataparser as tdp
    from gpr_tpu_torch.pipeline import pca as tpca

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    sel = slice(None) if window is None else slice(window[0], window[0] + window[1])
    us = tdp.parse_image_files(tdp.list_files(learn_dirs[0])[sel])
    dvf = t(tdp.parse_displacement_files(tdp.list_files(learn_dirs[1])[sel]))
    te = tdp.parse_image_files(tdp.list_files(test_us))
    n_in, n_out = cm["n_inputModes"], cm["n_outputModes"]
    out_pca = tpca.fit_pca(dvf)
    Ytr = out_pca.reduce(dvf, n_out).T
    if ar is None:
        in_pca = tpca.fit_pca(t(us))
        Xtr, Xte = in_pca.reduce(t(us), n_in).T, in_pca.reduce(t(te), n_in).T
    else:
        ar_tr = tdp.parse_image_files(tdp.list_files(ar + "/train"))
        ar_te = tdp.parse_image_files(tdp.list_files(ar + "/test"))
        concat = t(np.concatenate([us, ar_tr, ar_te], axis=1))
        in_pca = tpca.fit_pca(concat)
        F = in_pca.reduce(concat, n_in)
        f_in, f_ar = F[:, :us.shape[1]].T, F[:, us.shape[1]:us.shape[1] + ar_tr.shape[1]].T

        def design(series):
            # batches of AR_P frames: per batch one row [x_t, x_{t-1}, ...], zero-padded
            rows = []
            for b in range(series.shape[0] // AR_P):
                xb = series[b * AR_P:(b + 1) * AR_P]
                for r in range(AR_P - 1):
                    rows.append(torch.stack([xb[r - k] if r >= k else torch.zeros_like(xb[0])
                                             for k in range(AR_P)]))
            return torch.stack(rows), series.reshape(-1, AR_P, series.shape[1])[:, 1:].reshape(-1, series.shape[1])

        D, Yar = design(f_ar)  # (K, p, F), (K, F)
        theta = torch.stack([torch.linalg.pinv(D[:, :, f]) @ Yar[:, f] for f in range(D.shape[2])], 1)

        def rollout(series):
            Dp, _ = design(series)
            return torch.einsum("kpf,pf->kf", Dp, theta)  # one step ahead; one row a batch at p = 2

        Xtr, Xte = rollout(f_in), rollout(in_pca.reduce(t(te), n_in).T)
    ls, sc = 2.0, 1.0
    noise = float(cm["data_noise"])
    if cm.get("sparse_inducing"):
        idx = np.linspace(0, Xtr.shape[0] - 1, cm["sparse_inducing"]).astype(int)
        mean = plain_sparse(Xtr[idx], Xtr, Ytr, ls, sc, noise, 1e-8, Xs=Xte)["mean"]
    else:
        K = gaussian64(Xtr, Xtr, ls, sc)
        K.diagonal().add_(noise * noise)
        L, _ = plain_chol(K)
        mean = gaussian64(Xte, Xtr, ls, sc) @ torch.cholesky_solve(Ytr, L)
    return out_pca.reconstruct(mean.T, n_out)


def read_dvfs(result_dir):
    from gpr_tpu_torch.pipeline import imageio as tio

    names = sorted(os.listdir(result_dir))
    return np.stack([tio.read_image(os.path.join(result_dir, f)).flatten() for f in names], axis=1)


# phase 28's sizes: (a) bench_sparse's n and m and the lengthscale of the
# well-conditioned case, (b) the Adam runs, (c) the chains, (d) the apps'
# dataset (the breathing shape's 3773 frames, images cut), (e) the PCA at
# full image width
P28 = {"n": 16384, "ms": (512, 1024), "ls_wc": 0.8, "nb": 4096, "mb": 256, "chains": 16, "mc": 512,
       "n_train": 3773, "n_test": 64, "hw": 64, "dvf": (16, 16, 16), "m_app": 512,
       "dP": 3 * 64 ** 3, "NP": 1024, "r": 64}


def phase_28(dev, smi, t32):
    """Phase 28 at the sizes of ``P28``; returns the launch counts of its paths."""
    import contextlib
    import io
    import shutil

    import torch

    import gpr_tpu_torch as tg
    from gpr_tpu_torch.apps import learn as tlearn
    from gpr_tpu_torch.apps import predict as tpredict
    from gpr_tpu_torch.gp import batched as fleet
    from gpr_tpu_torch.gp import sparse as tsp
    from gpr_tpu_torch.inference import hmc as thmc
    from gpr_tpu_torch.ops import _cuda
    from gpr_tpu_torch.ops import batched as fbatched
    from gpr_tpu_torch.ops import linalg as tlin
    from gpr_tpu_torch.pipeline import pca as tpca
    from gpr_tpu_torch.utils import config as tconfig

    t28 = time.perf_counter()
    path_counts = []
    fused = ("panel_update", "diag_factor_inv", "panel_solve")

    def show(gates):
        return "; ".join(f"{k} {r['err']:.3g} (plain f32 {r['plain_f32_err']:.3g})" for k, r in gates.items())

    # (a) benchmarks/bench_sparse.py:45-58: Gaussian(2, 1), sigma 0.3, jitter
    # 1e-4, X and Y standard normal from default_rng(0), Z = X[::n // m][:m];
    # then m=1024 at lengthscale 0.8, where the inner matrix's cond is ~7e3
    # and float32 resolves it, so that the 3x gates separate a right kernel
    # from a wrong one (at lengthscale 2 its cond is 1.4e10, and every
    # float32 route misses float64 by 40-90 %)
    n, d, q, sig, jit = P28["n"], 8, 4, 0.3, 1e-4
    rng = np.random.default_rng(0)
    X64 = torch.tensor(rng.standard_normal((n, d)), device=dev)
    Y64 = torch.tensor(rng.standard_normal((n, q)), device=dev)
    Xs64 = torch.tensor(np.random.default_rng(1).standard_normal((1024, d)), device=dev)
    X, Y, Xs = X64.float(), Y64.float(), Xs64.float()
    print(f"phase 28 the sparse GP at bench_sparse's shape: Gaussian(2, 1), sigma {sig}, jitter {jit}, n={n} "
          f"d={d} q={q}, float32; the learn -> predict apps; PCA")
    times_a = {}
    for m, ls in [(m_, 2.0) for m_ in P28["ms"]] + [(1024, P28["ls_wc"])]:
        k = tg.Gaussian(ls, 1.0)
        bench = ls == 2.0
        Z64 = X64[:: n // m][:m].contiguous()
        Z = Z64.float()
        want = "fused-matrix" if m >= 1024 else "torch-cholesky"
        _cuda.reset_launch_counts()
        sg = tsp.fit_sparse(k, Z, X, Y, sig, jit)
        port = {"mean": sg.predict(Xs), "credible_interval": torch.stack([sg.credible_interval(x)
                                                                          for x in Xs[:64]])}
        port["value"], port["gradient"] = tsp.sparse_mll_value_and_grad(k, Z, X, Y, sig, jit)
        port["inducing_gradient"] = tsp.sparse_mll_and_grad_inducing(k, Z, X, Y, sig, jit)[1]
        port["elbo"] = tsp.titsias_elbo(k, Z, X, Y, sig, jit)
        torch.cuda.synchronize()
        c = _cuda.launch_counts()
        path_counts.append(c)
        check(sg.route == want, f"sparse fit at m={m} took route {sg.route}, not {want}")
        if want == "fused-matrix":
            check(all(c[f] > 0 for f in fused) and c["syrk_update"] == 0, f"sparse m={m} launches {c}")
        else:
            check(sum(c.values()) == 0, f"sparse m={m} launched {c} on torch-cholesky")
        # the port's two m x m matrices (fit_sparse's), the jitter its
        # factorizations took, and their condition numbers in float64
        Kmm = tlin.add_diagonal(tg.gram(k, Z), jit)
        Knm = tg.gram(k, X, Z)
        mats = {"Kmm": Kmm, "inner": Kmm + Knm.T @ Knm / sig ** 2}
        j_port = [float(tlin.safe_cholesky(A)[1]) for A in mats.values()]
        Kmm64 = gaussian64(Z64, Z64, ls, 1.0) + jit * torch.eye(m, dtype=torch.float64, device=dev)
        Knm64 = gaussian64(X64, Z64, ls, 1.0)
        conds = [float(e[-1] / e[0]) for e in (torch.linalg.eigvalsh(A) for A in
                                               (Kmm64, Kmm64 + Knm64.T @ Knm64 / sig ** 2))]
        del Knm, Kmm64, Knm64
        if not bench:
            check(conds[1] <= 1e5, f"m={m} lengthscale {ls}: cond(inner) {conds[1]:.3g}, not well conditioned")
        # each factorization on its kernels (K2-K4 at m=1024) against the
        # plain version of its steps on the identical float32 matrix: the
        # backward error gates in every case, the factor's forward error
        # where float32 resolves it
        if want == "fused-matrix":
            for name, A in mats.items():
                jm, fl, fg = factor_check(A)
                print(f"  (a) m={m} lengthscale {ls}: {name} + {jm:.3g} I on {want} (launches {fl}) against "
                      f"its plain version on the same matrix: {show(fg)}")
                check(all(fl.get(f, 0) > 0 for f in fused), f"m={m} {name}: the compared factor launched {fl}")
                check(fg["LL^T"]["ok"] and (bench or fg["L"]["ok"]),
                      f"m={m} lengthscale {ls} {name}: factor above 3x its plain version's error")
        del mats, Kmm
        ref = {}
        for name, (Zp, Xp, Yp, Xsp) in (("f64", (Z64, X64, Y64, Xs64)), ("f32", (Z, X, Y, Xs))):
            ls_, sc_ = (torch.tensor(v, dtype=Xp.dtype, device=dev, requires_grad=True) for v in (ls, 1.0))
            Zr = Zp.clone().requires_grad_()
            with torch.enable_grad():
                r = plain_sparse(Zr, Xp, Yp, ls_, sc_, sig, jit, Xsp, Xsp[:64])
                gl, gs, gz = torch.autograd.grad(r["scalar"], (ls_, sc_, Zr))
            ref[name] = {"mean": r["mean"].detach(), "credible_interval": r["ci"].detach(),
                         "value": r["value"].detach(), "gradient": torch.stack([gl, gs]),
                         "inducing_gradient": gz, "elbo": r["elbo"].detach(), "jitter": r["jitter"]}
        gates = {key: (gate if bench else gate32)(v, ref["f32"][key], ref["f64"][key]) for key, v in port.items()}
        print(f"  (a) m={m} lengthscale {ls}: route {sg.route}; float64 cond (Kmm, inner) {conds[0]:.3g}, "
              f"{conds[1]:.3g}; jitter (Kmm, inner): port {j_port}, plain f32 {list(ref['f32']['jitter'])}, "
              f"f64 {list(ref['f64']['jitter'])}; rel err vs f64: {show(gates)}; launches {c}")
        check(all(r["ok"] for r in gates.values()),
              f"sparse m={m} lengthscale {ls}: error above 3x the plain f32 route's")
        if bench:
            times_a[m] = (events_ms(lambda: tsp.fit_sparse(k, Z, X, Y, sig, jit), 5),
                          events_ms(lambda: tsp.sparse_mll_value_and_grad(k, Z, X, Y, sig, jit), 5))
        del sg, port, ref
    k = tg.Gaussian(2.0, 1.0)
    t_exact = events_ms(lambda: tg.fit(k, X, Y, sigma=sig, use_pallas_gram=True), 3)
    torch.cuda.empty_cache()
    print(f"  (a) CUDA-event medians of 5 ({smi}): " + "; ".join(
        f"m={m} fit {f:.3f} ms, value + gradient {v:.3f} ms" for m, (f, v) in times_a.items())
        + f"; the exact fit at n={n} (route fused-gram, median of 3) {t_exact:.3f} ms")

    # (b) optimize_inducing and fit_svgp, n=4096, m=256, 20 Adam steps each
    nb, mb = P28["nb"], P28["mb"]
    Xb, Yb = X[:nb], Y[:nb]
    Zb = Xb[:: nb // mb][:mb]
    _cuda.reset_launch_counts()
    t_b = time.perf_counter()
    _, tr_o = tsp.optimize_inducing(k, Zb, Xb, Yb, sig, jit, iterations=20)
    torch.cuda.synchronize()
    t_o, t_b = time.perf_counter() - t_b, time.perf_counter()
    svgp, tr_s = tsp.fit_svgp(k, Zb, Xb, Yb, sig, jit, iterations=20)
    torch.cuda.synchronize()
    t_s = time.perf_counter() - t_b
    path_counts.append(_cuda.launch_counts())
    for name, tr, t_ in (("optimize_inducing", tr_o, t_o), ("fit_svgp", tr_s, t_s)):
        print(f"  (b) {name} n={nb} m={mb}, 20 steps: {t_:.3f} s, objective {float(tr[0]):.3f} -> "
              f"{float(tr[-1]):.3f}")
        check(bool(torch.isfinite(tr).all()) and float(tr[-1]) > float(tr[0]), f"{name}: trace {tr.tolist()}")
    print(f"  (b) fit_svgp's kernel: {tg.kernel_to_string(svgp.kernel)}")

    # (c) the sparse log posterior: 16 chains on a 4 x 4 grid of z over
    # [-1, 1]^2, then 16 chains at lengthscales 0.6-0.85 and scales
    # 0.61-1.28, where every chain's inner matrix has cond <= ~1e4 and the
    # 3x gates separate a right fleet factor from a wrong one
    mc = P28["mc"]
    Zc64 = X64[:: n // mc][:mc].contiguous()
    Zc = Zc64.float()
    side = int(round(math.sqrt(P28["chains"])))
    grids = {"bench": (np.linspace(-1, 1, side), np.linspace(-1, 1, side)),
             "well-conditioned": (np.linspace(math.log(0.6), math.log(0.85), side),
                                  np.linspace(-0.5, 0.25, side))}
    lp = thmc.make_sparse_gp_log_posterior(k, Zc, X, Y, sig, jitter=jit)
    check(lp.route == "fleet-crout", f"the sparse log posterior took route {lp.route}")
    per = mc // fbatched.PANEL

    def plain_logp(z, Zp, Xp, Yp):
        vals, grads = [], []
        for zc_ in z.to(Xp.dtype):
            zz = zc_.detach().clone().requires_grad_()
            with torch.enable_grad():
                th_ = torch.exp(zz)
                val = plain_sparse(Zp, Xp, Yp, th_[0], th_[1], sig, jit)["scalar"] + zz.sum()
                (gg,) = torch.autograd.grad(val, zz)
            vals.append(val.detach())
            grads.append(gg)
        return torch.stack(vals), torch.stack(grads)

    def chain_fleet(z, Zp, Xp):
        # every chain's Kmm + jitter I, then every chain's inner matrix, as
        # the log posterior stacks them; with the inner matrices' cond
        kmm, inner = [], []
        for ls_, sc_ in torch.exp(z.double()).tolist():
            Kmm_ = gaussian64(Zp, Zp, ls_, sc_) + jit * torch.eye(mc, dtype=Zp.dtype, device=dev)
            Knm_ = gaussian64(Xp, Zp, ls_, sc_)
            kmm.append(Kmm_)
            inner.append(Kmm_ + Knm_.T @ Knm_ / sig ** 2)
        return torch.stack(kmm + inner)

    t_c = None
    for gname, (za, zb) in grids.items():
        ga, gb = np.meshgrid(za, zb, indexing="ij")
        zc = t32(np.stack([ga.ravel(), gb.ravel()], 1))

        def value_grad():
            zz = zc.clone().requires_grad_()
            with torch.enable_grad():
                v_ = lp(zz)
                (g_,) = torch.autograd.grad(v_.sum(), zz)
            return v_.detach(), g_

        _cuda.reset_launch_counts()
        v_c, g_c = value_grad()
        torch.cuda.synchronize()
        c = _cuda.launch_counts()
        path_counts.append(c)
        check(c["crout_chol"] >= per and c["crout_chol"] % per == 0 and c["gram_batched"] == 0,
              f"sparse log posterior launches {c}: K7 once a panel a factorization")
        v64, g64 = plain_logp(zc.double(), Zc64, X64, Y64)
        v32, g32 = plain_logp(zc, Zc, X, Y)
        gfun = gate if gname == "bench" else gate32
        gates_c = {"value": gfun(v_c, v32, v64), "gradient": gfun(g_c, g32, g64)}
        # the fleet's factor (K7) against torch's batched Cholesky of the
        # identical float32 fleet; cond of every inner matrix in float64
        conds_c = torch.linalg.eigvalsh(chain_fleet(zc, Zc64, X64)[side * side:])
        cond_c = float((conds_c[:, -1] / conds_c[:, 0]).max())
        jm, fl, fg = fleet_factor_check(chain_fleet(zc, Zc, X), fleet._panel(mc, fbatched.PANEL))
        if gname == "bench":
            t_c = events_ms(value_grad, 3)
        else:
            check(cond_c <= 1e5, f"(c) {gname}: largest cond(inner) {cond_c:.3g}")
        print(f"  (c) sparse log posterior, {gname} grid, {side * side} chains, n={n} m={mc}, route {lp.route}: "
              f"largest float64 cond(inner) {cond_c:.3g}; rel err vs f64: {show(gates_c)}; K7 launches "
              f"{c['crout_chol']} ({c['crout_chol'] // per - 1} retry rounds)")
        print(f"      the fleet's factor at jitter {float(jm.min()):.3g}-{float(jm.max()):.3g} on fleet-crout "
              f"(launches {fl}) against its plain version on the same fleet: {show(fg)}")
        check(fl.get("crout_chol", 0) > 0, f"(c) the compared fleet factor launched {fl}")
        check(all(r["ok"] for r in gates_c.values()),
              f"sparse log posterior, {gname} grid: error above 3x the plain f32 route's")
        check(fg["LL^T"]["ok"] and (gname == "bench" or fg["L"]["ok"]),
              f"(c) {gname}: the fleet's factor above 3x its plain version's error")
    print(f"  (c) value + gradient of the bench grid {t_c:.3f} ms (CUDA events, median of 3, {smi})")
    del X64, Y64, Xs64, X, Y, Xs, lp
    torch.cuda.empty_cache()

    # (d) learn -> predict through main(argv), in process, at the breathing
    # shape (n=3773, d=5, q=3) with the image sizes cut (US 64 x 64, DVFs
    # 3 x 16^3) so that ~7.7k files write and parse within the phase
    root = "chip_smoke_out/phase28"
    shutil.rmtree(root, ignore_errors=True)
    t_w = time.perf_counter()
    paths = write_breathing_dataset(root + "/breathing", P28["n_train"], P28["n_test"], P28["hw"], P28["dvf"])
    ar_dirs = write_ar_dataset(root + "/ar")
    t_w = time.perf_counter() - t_w
    cm = {"perform_ar": False, "n_inputModes": 5, "n_outputModes": 3, "ar_n": 1, "ar_p": 2,
          "kernel_string": "GaussianKernel(2, 1,)", "data_noise": 0.01}
    cl = {"use_precomputed": False, "n_trainImgs": 0, "start_trainInd": 0}
    cp = {"use_precomputed": False, "compute_groundtruth_features": True}
    ref_file = os.path.join(paths["train"][1], "df00000.vtk")
    modes = {
        "exact": (cm, cl, cp, list(paths["train"]), list(paths["test"]), ref_file, None),
        "sparse": (dict(cm, sparse_inducing=P28["m_app"]), cl, cp, list(paths["train"]), list(paths["test"]),
                   ref_file, None),
        "ar": (AR_CONFIG_MODEL, AR_CONFIG_LEARN, AR_CONFIG_PREDICT,
               [ar_dirs["us_train"], ar_dirs["dvf_train"], root + "/ar/ar"],
               [ar_dirs["us_test"], ar_dirs["dvf_test"]], os.path.join(ar_dirs["dvf_train"], "df00000.vtk"),
               root + "/ar/ar"),
    }
    apps = {}
    for mode, (cm_, cl_, cp_, learn_dirs, test_dirs, ref_, ar) in modes.items():
        cfg = []
        for name, c_ in (("cm", cm_), ("cl", cl_), ("cp", cp_)):
            cfg.append(f"{root}/{mode}-{name}.json")
            with open(cfg[-1], "w") as f:
                json.dump(c_, f)
        for policy in ("fast", "parity"):
            prefix, results = f"{root}/{mode}-{policy}", f"{root}/{mode}-{policy}-results"
            os.makedirs(results)
            out = io.StringIO()
            with tconfig.policy_scope(policy), contextlib.redirect_stdout(out):
                _cuda.reset_launch_counts()
                t_l = time.perf_counter()
                rc_l = tlearn.main([cfg[0], cfg[1], prefix, *learn_dirs])
                torch.cuda.synchronize()
                t_l = time.perf_counter() - t_l
                c_l = _cuda.launch_counts()
                t_p = time.perf_counter()
                rc_p = tpredict.main([cfg[0], cfg[2], prefix, *test_dirs, results, ref_])
                t_p = time.perf_counter() - t_p
                c_p = _cuda.launch_counts()
            text = out.getvalue()
            check(rc_l == 0 and rc_p == 0, f"{mode} {policy}: learn {rc_l}, predict {rc_p}:\n{text[-2000:]}")
            route = re.search(r"route ([\w-]+)", text)
            with open(prefix + "-latestInferenceTime.txt") as f:
                frame_s = [float(v) for v in f.read().split(",") if v.strip()]
            stages = "; ".join(f"{name.strip()} {float(sec):.2f} s" for name, sec in
                               re.findall(r"^([^\n]*?)\.\.\. ([\d.]+)s \[done\]", text, re.M))
            apps[(mode, policy)] = {"route": route.group(1) if route else "?", "learn_s": t_l, "stages": stages,
                                    "predict_s": t_p, "frame_ms": 1e3 * float(np.median(frame_s)),
                                    "frames": len(frame_s), "dvf": read_dvfs(results)}
            if policy == "fast":
                path_counts.append(c_p)  # learn's and predict's launches
                apps[(mode, policy)]["learn_launches"] = {k_: v for k_, v in c_l.items() if v}
        a32, a64 = apps[(mode, "fast")], apps[(mode, "parity")]
        plain = plain_app(learn_dirs, test_dirs[0], cm_, dev, ar).detach().cpu().double()
        g_ = gate(torch.tensor(a32["dvf"]), plain, torch.tensor(a64["dvf"]))
        print(f"  (d) {mode}: learn route {a32['route']} (float64 run {a64['route']}); learn {a32['learn_s']:.2f} s, "
              f"predict {a32['predict_s']:.2f} s (float64 {a64['learn_s']:.2f} / {a64['predict_s']:.2f} s); "
              f"per-frame predict, median of {a32['frames']}: {a32['frame_ms']:.4f} ms (float64 "
              f"{a64['frame_ms']:.4f} ms); DVFs rel err vs the float64 run {g_['err']:.3g} (plain f32 "
              f"{g_['plain_f32_err']:.3g}); learn launches {a32['learn_launches']}")
        print(f"      stages (float32): {a32['stages']}")
        check(g_["ok"], f"{mode}: predicted DVFs above 3x the plain f32 route's error")
    # the learn app's parsing + PCA stage taken apart: the parse of the
    # training frames (host clock) and the two PCAs on the card (CUDA events)
    # at the app's shapes: US d=64^2 <= 4096, the thin SVD; DVFs d=3 * 16^3
    # > N, the Gram trick; the rest of the stage writes the feature caches
    from gpr_tpu_torch.pipeline import dataparser as tdp

    t_parse = time.perf_counter()
    us_tr = tdp.parse_image_files(tdp.list_files(paths["train"][0]))
    dvf_tr = tdp.parse_displacement_files(tdp.list_files(paths["train"][1]))
    t_parse = time.perf_counter() - t_parse
    us_tr, dvf_tr = t32(us_tr), t32(dvf_tr)
    t_svd = events_ms(lambda: tpca.fit_pca(us_tr), 3)
    t_gram = events_ms(lambda: tpca.fit_pca(dvf_tr), 3)
    print(f"  (d) the parsing + PCA stage apart ({smi}): parse of the {2 * P28['n_train']} training files "
          f"{t_parse:.2f} s (host clock); fit_pca of the US frames ({tuple(us_tr.shape)}, thin SVD) {t_svd:.2f} ms, "
          f"of the DVFs ({tuple(dvf_tr.shape)}, Gram trick) {t_gram:.2f} ms (CUDA events, medians of 3)")
    del us_tr, dvf_tr
    print(f"  (d) dataset written in {t_w:.1f} s; predict latency per frame (apps/predict.py, exact model, "
          f"n={P28['n_train']}, d=5, q=3, float32): {apps[('exact', 'fast')]['frame_ms']:.4f} ms ({smi})")
    exact32 = apps[("exact", "fast")]
    check(exact32["route"] == "fused-gram" and all(exact32["learn_launches"].get(f, 0) > 0 for f in fused)
          and "syrk_update" not in exact32["learn_launches"],
          f"learn took route {exact32['route']} with launches {exact32['learn_launches']}")

    # (e) fit_pca's Gram-trick branch at full image width: d = 3 * 64^3, N = 1024
    dP, NP, r = P28["dP"], P28["NP"], P28["r"]
    gen = torch.Generator(dev).manual_seed(28)
    U0, _ = torch.linalg.qr(torch.randn((dP, r), generator=gen, device=dev, dtype=torch.float64))
    V0, _ = torch.linalg.qr(torch.randn((NP, r), generator=gen, device=dev, dtype=torch.float64))
    s0 = 100.0 * 0.95 ** torch.arange(r, device=dev, dtype=torch.float64)
    XP64 = (U0 * s0) @ V0.T
    del U0, V0
    XP64 += torch.randn((dP, 1), generator=gen, device=dev, dtype=torch.float64)
    XP64 += 1e-3 * torch.randn((dP, NP), generator=gen, device=dev, dtype=torch.float64)
    XP = XP64.float()
    t_p32 = events_ms(lambda: tpca.fit_pca(XP), 3)
    m32 = tpca.fit_pca(XP)
    m64 = tpca.fit_pca(XP64)
    t_p64 = events_ms(lambda: tpca.fit_pca(XP64), 1)
    sig_err = float((m32.sigma.double() - m64.sigma).abs().max() / m64.sigma[0])
    rec_err = relerr(m32.reconstruct(m32.reduce(XP, r), r), m64.reconstruct(m64.reduce(XP64, r), r))
    eps32 = float(torch.finfo(torch.float32).eps)
    print(f"  (e) fit_pca Gram trick, d={dP} N={NP} ({r} modes 100 * 0.95^k over noise 1e-3): float32 "
          f"{t_p32:.2f} ms (median of 3), float64 {t_p64:.2f} ms ({smi}); singular values: max |err| / sigma_1 "
          f"{sig_err:.3g} <= {8 * math.sqrt(eps32):.3g}; rank-{r} reconstruction rel err {rec_err:.3g} <= 1e-3")
    check(sig_err <= 8 * math.sqrt(eps32) and rec_err <= 1e-3, "fit_pca float32 beyond its bounds")
    del XP, XP64, m32, m64
    torch.cuda.empty_cache()
    print(f"  phase 28 wall time {time.perf_counter() - t28:.1f} s")
    return path_counts


# ---------------------------------------------------------------------------
# phase 29: the image pipeline, the serving loop's CUDA graph, drift, experiments
# ---------------------------------------------------------------------------

# phase 29's sizes: (a) the warped volume and the field's amplitude in voxels,
# (b) the slice-wise variance and the pyramid's scales, (c) the served
# frames, (d) the drift windows and the synthetic study's frames
P29 = {"vol": 64, "amp": 3.0, "var": 4.0, "scales": 3, "frames": 64, "window": 1024, "starts": (0, 1024, 2048),
       "study_train": 32, "study_test": 8}
P28_ROOT = "chip_smoke_out/phase28"  # phase 28 (d)'s dataset and models
# JAX's 'wrap' and 'constant' at order 1 are scipy's 'grid-wrap' and 'grid-constant'
SCIPY_SAME = {(0, "nearest"): "nearest", (0, "mirror"): "mirror", (0, "reflect"): "reflect",
              (1, "nearest"): "nearest", (1, "mirror"): "mirror", (1, "reflect"): "reflect",
              (1, "wrap"): "grid-wrap", (1, "constant"): "grid-constant", (3, None): "mirror"}


def gate_f32(port, plain, ref):
    """The port's float32 result on the card and its own float32 run on the
    CPU, each against the float64 reference: the card within 3x the CPU
    run's error, or 2 float32 eps where that is smaller."""
    import torch

    e, p = relerr(port, ref), relerr(plain, ref)
    lim = max(3 * p, 2 * float(torch.finfo(torch.float32).eps))
    return {"err": e, "plain_f32_err": p, "limit": lim, "ok": e <= lim}


def percentile_diff(stats32, stats64):
    """The largest gap between two runs' error percentiles (a printout: it
    moves by at most the largest per-voxel change of the field, whatever
    that change is, so it is no gate)."""
    return max(abs(float(stats32[k]) - float(stats64[k])) for k in stats64)


def read_vtk_dir(path, suffix=".vtk"):
    from gpr_tpu_torch.pipeline import imageio as tio

    names = sorted(f for f in os.listdir(path) if f.endswith(suffix))
    return np.stack([tio.read_image(os.path.join(path, f)).flatten() for f in names], axis=1)


def write_study(root, n_train, n_test, seed=29):
    """A small study for apps/experiments.py: 8 MiniDicom files (2 slice
    positions) for the preprocessing stage, and 10 x 10 'US' frames and
    3 x 4 x 5 DVFs (tests/test_experiments.py's recipe) that the split stage
    divides into n_train / n_test."""
    from gpr_tpu_torch.data import dicom as tdicom
    from gpr_tpu_torch.pipeline import imageio as tio

    rng = np.random.default_rng(seed)
    for sub in ("data", "us", "reg3d"):
        os.makedirs(os.path.join(root, sub))
    for i in range(1, 9):
        tdicom.write_minimal_dicom(os.path.join(root, "data", f"raw{i:03d}.ima"), instance_number=i)
    yy = np.mgrid[0:10, 0:10][0]
    for i in range(n_train + n_test):
        ph = 2 * np.pi * i / 10.0
        frame = np.clip(127 + 100 * np.sin(2 * np.pi * yy / 10 + ph) + rng.normal(0, 1, (10, 10)), 0, 255)
        tio.write_image(tio.Image(frame, (1, 1), (0, 0)), os.path.join(root, "us", f"us{i:05d}.vtk"))
        df = np.stack([np.full((3, 4, 5), np.sin(ph)), np.full((3, 4, 5), 0.5 * np.cos(ph)),
                       np.full((3, 4, 5), 0.2 * np.sin(ph))], axis=-1) + rng.normal(0, 0.003, (3, 4, 5, 3))
        tio.write_image(tio.Image(df, (1, 1, 1), (0, 0, 0), ncomponents=3),
                        os.path.join(root, "reg3d", f"df{i:05d}.vtk"))
    return {
        "options": {"preprocessing": True, "splitting_data": True, "regression": True, "evaluation": True},
        "general": {"root_dir": root, "n_slices": 2, "surrogate_type": 1,
                    "n_training_sweeps": n_train // 2, "surrogate_dir": "us", "registration_dir": "reg3d",
                    "input_format": "vtk", "output_format": "vtk", "master_volume": "reg3d/train/00000.vtk"},
        "gpr_model": {"perform_ar": False, "n_inputModes": 4, "n_outputModes": 3, "ar_n": 1, "ar_p": 2,
                      "kernel_string": "GaussianKernel(2, 1,)", "data_noise": 0.01, "subdir": "test"},
        "gpr_learn": {"use_precomputed": False, "n_trainImgs": 0, "start_trainInd": 0},
        "gpr_predict": {"use_precomputed": False, "compute_groundtruth_features": False},
    }


def phase_29(dev, smi, t32):
    """Phase 29 at the sizes of ``P29`` on phase 28 (d)'s dataset and exact
    float32 model; returns the launch counts of its paths."""
    import contextlib
    import glob
    import io
    import shutil

    import scipy.ndimage as ndi
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from gpr_tpu_torch.apps import drift as tdrift
    from gpr_tpu_torch.apps import experiments as texp
    from gpr_tpu_torch.apps import predict as tpredict
    from gpr_tpu_torch.apps import serve as tserve
    from gpr_tpu_torch.gp import exact as texact
    from gpr_tpu_torch.ops import _cuda
    from gpr_tpu_torch.pipeline import dataparser as tdp
    from gpr_tpu_torch.pipeline import filters as tflt
    from gpr_tpu_torch.pipeline import imageio as tio
    from gpr_tpu_torch.pipeline import warp as twarp
    from gpr_tpu_torch.utils import config as tconfig
    from gpr_tpu_torch.utils import profiling as tprof

    t29 = time.perf_counter()
    path_counts = []
    root = "chip_smoke_out/phase29"
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    check(os.path.exists(P28_ROOT + "/exact-fast-ParameterFile.txt"), "phase 29 needs phase 28 (d)'s exact model")
    print(f"phase 29 the image pipeline (warp, filters), serve's per-frame CUDA graph, drift and experiments "
          f"on phase 28 (d)'s data")

    def show(gates):
        return "; ".join(f"{k} {r['err']:.3g} (CPU f32 {r['plain_f32_err']:.3g})" for k, r in gates.items())

    # (a) a 64^3 float32 volume warped by a smooth field of up to +-3 voxels
    n = P29["vol"]
    rng = np.random.default_rng(29)
    zz, yy, xx = np.meshgrid(*(np.arange(n, dtype=np.float64),) * 3, indexing="ij")
    vol = (np.sin(6 * np.pi * xx / n) * np.cos(4 * np.pi * yy / n) + 0.5 * np.sin(2 * np.pi * zz / n)
           + 0.1 * rng.standard_normal((n, n, n))).astype(np.float32)
    # (the phases keep 3 sin off its exact halves, where scipy's order-0
    # rounding and JAX's differ)
    field = np.stack([P29["amp"] * np.sin(2 * np.pi * (c + 1) * (xx + yy + zz) / (3 * n) + c + 0.3)
                      for c in range(3)], axis=-1).astype(np.float32)
    vol_d, field_d = t32(vol), t32(field)
    vol_c, field_c = torch.from_numpy(vol), torch.from_numpy(field)
    # the card's coordinates in float64 arithmetic on the same float32 inputs
    coords64 = [(zz, yy, xx)[ax] + field[..., 2 - ax].astype(np.float64) for ax in range(3)]
    cases = [(3, None)] + [(o, m) for o in (0, 1) for m in ("nearest", "mirror", "reflect", "wrap", "constant")]
    gates_a, times_a = {}, {}
    for order, mode in cases:
        out = twarp.warp_array(vol_d, field_d, order=order, mode=mode)
        check(out.device.type == "cuda" and out.dtype == torch.float32, f"warp order {order}: {out.device}")
        plain = twarp.warp_array(vol_c, field_c, order=order, mode=mode)
        if (order, mode) in SCIPY_SAME:
            ref = torch.from_numpy(ndi.map_coordinates(vol.astype(np.float64), coords64, order=order,
                                                       mode=SCIPY_SAME[(order, mode)]))
            src = "scipy"
        else:
            ref = twarp.warp_array(vol_c.double(), field_c.double(), order=order, mode=mode)
            src = "port f64"
        key = f"order {order} {mode or 'mirror'} ({src})"
        gates_a[key] = gate_f32(out, plain, ref)
        gates_a[key]["card_vs_cpu_f32"] = float((out.cpu() - plain).abs().max())
        if mode in (None, "nearest"):
            times_a[order] = events_ms(lambda: twarp.warp_array(vol_d, field_d, order=order, mode=mode), 5)
    print(f"  (a) warp of a {n}^3 float32 volume by a smooth field of up to {P29['amp']} voxels, rel err against "
          f"float64: {show(gates_a)}")
    print(f"      max |card - CPU f32|: " + "; ".join(f"{k.split(' (')[0]} {r['card_vs_cpu_f32']:.3g}"
                                                    for k, r in gates_a.items()))
    print(f"      CUDA-event medians of 5 ({smi}): " + "; ".join(f"order {o} {t:.3f} ms" for o, t in times_a.items()))
    check(all(r["ok"] for r in gates_a.values()), "warp on the card above 3x its CPU float32 run's error")
    del vol_d, field_d, coords64

    # (b) the filters on phase 28's US series: 3773 x 64 x 64
    us = tdp.parse_image_files(tdp.list_files(P28_ROOT + "/breathing/train/us"))  # (4096, 3773), /255
    hw = int(round(math.sqrt(us.shape[0])))
    series64 = torch.from_numpy(np.ascontiguousarray(us.T.reshape(-1, hw, hw)))
    series_c = series64.float()
    series_d = series_c.to(dev)
    vol_s = series_c[:n].contiguous()  # the first 64 frames as a 64^3 volume
    runs = {
        "gaussian_smoothing var 4 slice-wise": lambda s: tflt.gaussian_smoothing(s, P29["var"], axes=(1, 2)),
        f"image_pyramid_series {P29['scales']} scales": lambda s: torch.cat(
            [lv.reshape(-1) for lv in tflt.image_pyramid_series(s, P29["scales"])]),
        "histogram_matching frame 0 onto 1": lambda s: tflt.histogram_matching(s[0], s[1]),
    }
    gates_b, times_b = {}, {}
    for name, fn in runs.items():
        out = fn(series_d)
        check(out.device.type == "cuda", f"{name} ran on {out.device}")
        gates_b[name] = gate_f32(out, fn(series_c), fn(series64))
        times_b[name] = events_ms(lambda: fn(series_d), 3)
    med = tflt.median_filter(vol_s.to(dev), 1)
    med_ref = ndi.median_filter(vol_s.numpy(), size=3, mode="nearest")
    med_ok = bool(np.array_equal(med.cpu().numpy(), med_ref))
    times_b["median_filter r=1 64^3"] = events_ms(lambda: tflt.median_filter(vol_s.to(dev), 1), 3)
    print(f"  (b) filters on the US series {tuple(series_d.shape)} float32, rel err against float64: "
          f"{show(gates_b)}; median_filter r=1 on {tuple(vol_s.shape)} equals scipy's median_filter(mode='nearest'): "
          f"{med_ok}")
    print(f"      CUDA-event medians of 3 ({smi}): " + "; ".join(f"{k} {t:.3f} ms" for k, t in times_b.items()))
    check(all(r["ok"] for r in gates_b.values()) and med_ok, "a filter on the card above its gate")
    del series_d, series64, series_c, vol_s, med
    torch.cuda.empty_cache()

    # (c) serve phase 28 (d)'s exact float32 model (n=3773, d=5, q=3, US 64^2,
    # DVF 3 x 16^3) from a copy of its files, 64 test frames through watch
    prefix = root + "/serve/gpr"
    os.makedirs(root + "/serve")
    for path in glob.glob(P28_ROOT + "/exact-fast-*"):
        if path.endswith((".txt", ".bin")) and "latest" not in path and "credible" not in path:
            shutil.copy(path, prefix + path[len(P28_ROOT + "/exact-fast"):])
    with open(P28_ROOT + "/exact-cm.json") as f:
        cm = json.load(f)
    watch_dir = root + "/watch"
    os.makedirs(watch_dir)
    test_us = tdp.list_files(P28_ROOT + "/breathing/test/us")[:P29["frames"]]
    for path in test_us:
        shutil.copy(path, watch_dir)
    server = tserve.Server(cm, prefix, root + "/served")
    check(server.device.type == "cuda" and server.dtype == torch.float32, f"Server on {server.device}")
    served = tserve.watch(server, watch_dir, poll=0.01, max_frames=P29["frames"], idle_timeout=5.0)
    check(served == P29["frames"], f"watch served {served} of {P29['frames']} frames")
    replays = server.replays / served
    check(replays == 1 and len(server._graphs) == 1,
          f"serve: {replays} replays a frame, {len(server._graphs)} graphs")
    with open(prefix + "-latestInferenceTime.txt") as f:
        watch_s = [float(v) for v in f.read().split(",") if v.strip()]
    frames = [np.asarray(tio.read_image(p).data) for p in test_us]
    # the graph against the same Server's eager program, frame by frame
    ulps = 0.0
    for fr in frames:
        g_, e_ = server.run(fr), server.run_eager(fr)
        if not np.array_equal(g_, e_):
            ulps = max(ulps, float(np.max(np.abs(g_.astype(np.float64) - e_) / np.spacing(np.abs(e_)))))
    print(f"  (c) serve: graph against eager program over {len(frames)} frames: "
          + ("bit for bit" if ulps == 0 else f"max {ulps:.1f} float32 ulp"))
    check(ulps <= 2, f"serve's graph differs from its eager program by {ulps} ulp")
    # what the card's runtime saw a frame: one graph launch, no kernel launch,
    # one copy in and one copy out (the host read), one synchronisation; the
    # profiler's warm-up frames start its device tracing before the 8 counted
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=2, active=8, repeat=1)) as prof:
        for fr in frames[:10]:
            server.run(fr)
            prof.step()
    names = [e.name for e in prof.events()]
    rt = {k: sum(nm == k for nm in names) / 8 for k in ("cudaGraphLaunch", "cudaLaunchKernel", "cudaMemcpyAsync",
                                                         "cudaStreamSynchronize")}
    rt.update({f"Memcpy {k}": sum(nm.startswith(f"Memcpy {k}") for nm in names) / 8 for k in ("HtoD", "DtoH")})
    reads = rt["Memcpy DtoH"]
    print(f"      torch.profiler over 8 frames, runtime calls and copies a frame: {rt}")
    check(rt == {"cudaGraphLaunch": 1, "cudaLaunchKernel": 0, "cudaMemcpyAsync": 2, "cudaStreamSynchronize": 1,
                 "Memcpy HtoD": 1, "Memcpy DtoH": 1}, f"serve's runtime calls and copies a frame {rt}")
    # serve's DVFs against predict's (phase 28 (d)) for the same frames, within
    # 3x the float32 error phase 28 (d) measured against its float64 run
    p32 = read_vtk_dir(P28_ROOT + "/exact-fast-results")[:, :served]
    p64 = read_vtk_dir(P28_ROOT + "/exact-parity-results")[:, :served]
    s32 = np.stack([np.load(os.path.join(root + "/served", f"dvf{i:05d}.npy")) for i in range(served)], axis=1)
    err28 = relerr(torch.from_numpy(p32), torch.from_numpy(p64))
    err_sp = relerr(torch.from_numpy(s32), torch.from_numpy(p32))
    print(f"      serve's DVFs against predict's: rel err {err_sp:.3g} <= 3 x {err28:.3g} (predict float32 against "
          f"float64, phase 28 (d))")
    check(err_sp <= 3 * err28, "serve's DVFs beyond 3x predict's float32 error")

    def host_ms(fn, args):
        out = []
        for a in args:
            t0 = time.perf_counter()
            fn(a)
            out.append(1e3 * (time.perf_counter() - t0))
        return float(np.median(out))

    gp = texact.load(prefix, np.float32, dev)
    feats = server.in_pca.reduce(t32(np.stack([server._frame_col(fr)[:, 0] for fr in frames], 1)),
                                 server.n_input_modes).T.cpu().numpy()
    lat = {"watch (graph + np.save)": 1e3 * float(np.median(watch_s)),
           "graph": host_ms(server.run, frames),
           "eager": host_ms(server.run_eager, frames),
           "predict's _packed (GP only)": host_ms(
               lambda v: tpredict._packed(gp, torch.as_tensor(v, dtype=torch.float32, device=dev)).cpu().numpy(),
               feats)}
    print(f"      per-frame latency, medians of {served} frames, host clock ({smi}): "
          + "; ".join(f"{k} {v:.4f} ms" for k, v in lat.items())
          + f"; CUDA-graph replays a frame {replays:g}, host reads (device-to-host copies) a frame {reads:g}")
    del server, gp

    # (d) drift: three 1024-frame windows of phase 28's training frames (route
    # fused-gram, K2-K4, in each learn), on the card in float32 and on the CPU
    # in float64; then experiments on a small study with DICOM preprocessing
    def drift_tree(where):
        r = os.path.abspath(f"{root}/drift-{where}")
        for sub, src in (("us/train", "train/us"), ("us/test", "test/us"), ("reg3d/train", "train/dvf"),
                         ("reg3d/test", "test/dvf")):
            os.makedirs(os.path.dirname(os.path.join(r, sub)), exist_ok=True)
            os.symlink(os.path.abspath(f"{P28_ROOT}/breathing/{src}"), os.path.join(r, sub))
        return r

    dcfg = {"general": {"surrogate_dir": "us", "registration_dir": "reg3d",
                        "master_volume": "reg3d/train/df00000.vtk"},
            "gpr_model": dict(cm, subdir="test"),
            "gpr_learn": {"use_precomputed": False},
            "gpr_predict": {"use_precomputed": False, "compute_groundtruth_features": False}}
    drift, dtimes, dlogs = {}, {}, {}
    for where, policy, device in (("card", "fast", None), ("cpu", "parity", "cpu")):
        r = drift_tree(where)
        timer = tprof.StageTimer()
        out = io.StringIO()
        with tconfig.policy_scope(policy), contextlib.redirect_stdout(out):
            _cuda.reset_launch_counts()
            t0 = time.perf_counter()
            drift[where] = tdrift.run_drift_config(dcfg, r, P29["window"], P29["starts"], device=device, timer=timer)
            torch.cuda.synchronize()
            dtimes[where] = (time.perf_counter() - t0, timer.totals())
            c = _cuda.launch_counts()
        dlogs[where] = out.getvalue()
        if where == "card":
            path_counts.append(c)
            routes = re.findall(r"route ([\w-]+)", dlogs[where])
            check(routes == ["fused-gram"] * len(P29["starts"]) and
                  all(c[f] > 0 for f in ("panel_update", "diag_factor_inv", "panel_solve")),
                  f"drift's learns took routes {routes} with launches {c}")
        else:
            check(sum(c.values()) == 0, f"drift on the CPU launched {c}")
    # each window's DVFs (card float32 against CPU float64) within 3x the
    # plain float32 route's error on the same window (plain_app), as 28 (d)
    breathing = [f"{P28_ROOT}/breathing/train/us", f"{P28_ROOT}/breathing/train/dvf"]
    for tag in drift["card"]:
        rc_, r64 = drift["card"][tag], drift["cpu"][tag]
        d32 = read_vtk_dir(f"{root}/drift-card/reg3d/test_pred_{tag}")
        d64 = read_vtk_dir(f"{root}/drift-cpu/reg3d/test_pred_{tag}")
        plain = plain_app(breathing, f"{P28_ROOT}/breathing/test/us", cm, dev,
                          window=(rc_["start"], P29["window"])).detach().cpu().double()
        g_ = gate32(torch.from_numpy(d32), plain, torch.from_numpy(d64))
        st = "; ".join(f"{k.split()[1]} {v:.2f} s" for k, v in dtimes["card"][1].items() if k.startswith(tag))
        print(f"  (d) drift {tag} ({P29['window']} frames from {rc_['start']}): DVFs rel err vs the CPU float64 run "
              f"{g_['err']:.3g} <= {g_['limit']:.3g} (plain f32 {g_['plain_f32_err']:.3g}); percentiles (card f32) "
              + ", ".join(f"{k}% {float(v):.5f}" for k, v in rc_["percentiles"].items())
              + f", max |card f32 - CPU f64| {percentile_diff(rc_['percentiles'], r64['percentiles']):.3g}; "
              f"stages (card) {st}")
        check(g_["ok"], f"drift {tag}: DVFs above 3x the plain f32 route's error")
    print(f"      drift wall time: card {dtimes['card'][0]:.1f} s, CPU float64 {dtimes['cpu'][0]:.1f} s; launches on "
          f"the card {({k: v for k, v in path_counts[-1].items() if v})}")

    evals = {}
    for where, policy, device in (("card", "fast", None), ("cpu", "parity", "cpu")):
        r = os.path.abspath(f"{root}/study-{where}")
        cfg = write_study(r, P29["study_train"], P29["study_test"])
        timer = tprof.StageTimer()
        out = io.StringIO()
        with tconfig.policy_scope(policy), contextlib.redirect_stdout(out):
            rc = texp.run_experiment_config(cfg, r, device=device, timer=timer)
        check(rc == 0, f"experiments on the {where}: rc {rc}\n{out.getvalue()[-2000:]}")
        with open(os.path.join(r, "evaluation.json")) as f:
            evals[where] = (json.load(f), read_vtk_dir(os.path.join(r, "reg3d", "test_pred")), timer.totals())
        check(os.path.exists(os.path.join(r, "credible_interval_test_.tex"))
              and sorted(os.listdir(os.path.join(r, "data_mod", "sorted"))) == ["slice01", "slice02"]
              and len(os.listdir(os.path.join(r, "us", "train"))) == P29["study_train"],
              f"experiments on the {where}: artifacts missing")
    # the study's DVFs the same way: the plain float32 route on the card's split
    r = os.path.abspath(f"{root}/study-card")
    plain = plain_app([f"{r}/us/train", f"{r}/reg3d/train"], f"{r}/us/test", cfg["gpr_model"],
                      dev).detach().cpu().double()
    g_ = gate32(torch.from_numpy(evals["card"][1]), plain, torch.from_numpy(evals["cpu"][1]))
    print(f"  (d) experiments ({P29['study_train']} + {P29['study_test']} frames, 8 DICOM files): DVFs rel err vs "
          f"the CPU float64 run {g_['err']:.3g} <= {g_['limit']:.3g} (plain f32 {g_['plain_f32_err']:.3g}); "
          "evaluation " + ", ".join(f"{k}% {v:.5f}" for k, v in evals["card"][0].items())
          + f", max |card f32 - CPU f64| {percentile_diff(evals['card'][0], evals['cpu'][0]):.3g}; stages (card) "
          + "; ".join(f"{k} {v:.3f} s" for k, v in evals["card"][2].items()))
    check(g_["ok"], "experiments: DVFs above 3x the plain f32 route's error")
    print(f"  phase 29 wall time {time.perf_counter() - t29:.1f} s")
    return path_counts


# ---------------------------------------------------------------------------
# phase 30: the multi-rank layer (gpr_tpu_torch.parallel), the sharded fleet
# and predictive, and ops/blocked.py's solves
# ---------------------------------------------------------------------------

P30 = {"n": 16384, "d": 128, "q": 8, "n2": 8192, "B": 128, "nf": 512, "draws": 32, "points": 1024,
       "chains": 16, "warmup": 20, "samples": 10, "leapfrog": 8, "reps": 3, "solve_q": (8, 128, 16384)}


def bench_data(n, d, q, device):
    """bench.py:121-125's X (n, d) and Y (n, q), float32, seed 0."""
    import torch

    rng = np.random.default_rng(0)
    X = torch.tensor(rng.standard_normal((n, d)), dtype=torch.float32, device=device)
    return X, torch.tensor(rng.standard_normal((n, q)), dtype=torch.float32, device=device)


def fleet_data(B, n, device):
    """benchmarks/bench_batched.py:31-34's fleet (d=8, q=4), float32, seed 0."""
    import torch

    rf = np.random.default_rng(0)
    X = torch.tensor(rf.standard_normal((B, n, 8)), dtype=torch.float32, device=device)
    return X, torch.tensor(rf.standard_normal((B, n, 4)), dtype=torch.float32, device=device)


def hmc_data(device):
    """bench_hmc's posterior data at n = P30["nf"] (also the predictive's),
    float32, and the 16 chains' config and z0 of phase 30's samplers."""
    import torch

    from gpr_tpu_torch.inference import hmc as thmc

    def f32(a):
        return torch.tensor(np.ascontiguousarray(a), dtype=torch.float32, device=device)

    nh = P30["nf"]
    rh = np.random.default_rng(0)
    xh = np.linspace(0, 10, nh)
    Xh, Yh = f32(xh[:, None]), f32((np.sin(xh) + 0.1 * rh.standard_normal(nh))[:, None])
    cfg = thmc.HMCConfig(num_warmup=P30["warmup"], num_samples=P30["samples"], num_leapfrog=P30["leapfrog"])
    return Xh, Yh, cfg, f32(np.random.default_rng(31).normal(0.0, 0.3, (P30["chains"], 2)))


def peak_bytes(fn):
    """(fn's result, the device bytes it held at its peak above what was
    allocated when it started)."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def phase_30_rank(rank, world, run_dir):
    """One rank of phase 30 (b): a gloo group on card 0 through a FileStore
    in ``run_dir``; the sharded fit at n = P30["n2"], the fleet and the
    chunked sampler's chains split over the ranks; writes its results and
    launch counts to ``run_dir``."""
    import torch
    import torch.distributed as dist

    import gpr_tpu_torch as tg
    from gpr_tpu_torch.gp import batched as fleet
    from gpr_tpu_torch.inference import hmc as thmc
    from gpr_tpu_torch.ops import _cuda
    from gpr_tpu_torch.parallel import sharded_gram as sg, sharded_hmc as sh

    torch.cuda.set_device(0)
    _cuda.library()
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(run_dir, "store"), world), rank=rank,
                            world_size=world)
    try:
        dev = torch.device("cuda", 0)
        X, Y = bench_data(P30["n2"], P30["d"], P30["q"], dev)
        Xf, Yf = fleet_data(P30["B"], P30["nf"], dev)
        mesh = sg.default_mesh(world, device="cuda")
        fmesh = sg.default_mesh(world, "fleet", device="cuda")
        k = tg.Gaussian(8.0, 1.0)
        sg.fit_sharded(k, X, Y, 0.1, mesh)  # warm-up
        torch.cuda.synchronize()
        dist.barrier()
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        (alpha, logdet, _), peak = peak_bytes(lambda: sg.fit_sharded(k, X, Y, 0.1, mesh))
        fit_s = time.perf_counter() - t0
        counts = dict(_cuda.launch_counts())
        _cuda.reset_launch_counts()
        gp = fleet.fit_batched_sharded(tg.Gaussian(2.0, 1.0), Xf, Yf, 0.1, mesh=fmesh)
        Xh, Yh, cfg, z0 = hmc_data(dev)
        lp = thmc.make_gp_log_posterior(tg.Gaussian(1.0, 1.0), Xh, Yh, 0.1)
        rs = sh.sample_hmc_sharded_chunked(lp, z0, torch.Generator(dev).manual_seed(5), cfg, chunk_size=4,
                                           mesh=sh.default_mesh(world, device="cuda"))
        torch.cuda.synchronize()
        for name, v in _cuda.launch_counts().items():
            counts[name] = counts.get(name, 0) + v
        np.savez(os.path.join(run_dir, f"rank{rank}.npz"), alpha=alpha.cpu().numpy(),
                 logdet=logdet.cpu().numpy(), fleet_alpha=gp.alpha.cpu().numpy(), route=np.array(gp.route),
                 fit_s=np.array(fit_s), peak=np.array(peak),
                 **{f"hmc_{f}": getattr(rs, f).cpu().numpy() for f in rs._fields})
        with open(os.path.join(run_dir, f"rank{rank}.json"), "w") as f:
            json.dump(counts, f)
    finally:
        dist.destroy_process_group()
    return 0


def phase_30(dev, smi, t32):
    """Phase 30 at the sizes of ``P30``: (a) the sharded paths on a world of
    one NCCL rank, (b) two gloo ranks on the one card, (c) fit_sharded's time
    beside fit and the library's, (d) the blocked solve against two
    triangular solves.  Returns the launch counts of its paths."""
    import tempfile

    import torch
    import torch.distributed as dist

    import gpr_tpu_torch as tg
    from gpr_tpu_torch.gp import batched as fleet
    from gpr_tpu_torch.inference import hmc as thmc
    from gpr_tpu_torch.inference import predictive as tpred
    from gpr_tpu_torch.ops import _cuda, blocked
    from gpr_tpu_torch.parallel import dryrun, sharded_gram as sg, sharded_hmc as sh

    t30 = time.perf_counter()
    counts_out = []
    n, d, q = P30["n"], P30["d"], P30["q"]
    print(f"phase 30 the multi-rank layer: torch {torch.__version__}, {smi}")

    # (a) a world of one NCCL rank, the bench model at full width
    mesh = sg.default_mesh()
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1, "phase 30 (a): not a world of one NCCL rank")
    X, Y = bench_data(n, d, q, dev)
    k = tg.Gaussian(8.0, 1.0)
    k5_ms = []
    orig_syrk = blocked.syrk_update

    def timed_syrk(*a, **kw):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = orig_syrk(*a, **kw)
        e1.record()
        k5_ms.append((e0, e1))
        return out

    _cuda.reset_launch_counts()
    (alpha, logdet, L), peak = peak_bytes(lambda: sg.fit_sharded(k, X, Y, 0.1, mesh))
    c = _cuda.launch_counts()
    counts_out.append(c)
    blocked.syrk_update = timed_syrk  # K5's wrapper calls in a second, warm fit
    try:
        sg.fit_sharded(k, X, Y, 0.1, mesh)
        torch.cuda.synchronize()
    finally:
        blocked.syrk_update = orig_syrk
    k5_total = sum(a.elapsed_time(b) for a, b in k5_ms)
    check(c["syrk_update"] == len(k5_ms) and c["syrk_update"] > 0, f"fit_sharded: K5 launches {c}")
    K64 = gaussian64(X.double(), X.double(), 8.0, 1.0)
    K64.diagonal().add_(0.01)
    L64 = torch.linalg.cholesky(K64)
    a64 = torch.cholesky_solve(Y.double(), L64)
    ld64 = 2.0 * torch.log(L64.diagonal()).sum()
    del K64, L64
    K32 = gaussian64(X, X, 8.0, 1.0)
    K32.diagonal().add_(float(np.float32(0.1) ** 2))
    L32 = torch.linalg.cholesky(K32)
    a32 = torch.cholesky_solve(Y, L32)
    ld32 = 2.0 * torch.log(L32.diagonal()).sum()
    del K32, L32
    g_a = gate32(alpha, a32, a64)
    g_l = gate32(logdet.reshape(1), ld32.reshape(1), ld64.reshape(1))
    print(f"  (a) fit_sharded n={n} d={d} q={q}, 1 NCCL rank: alpha rel err {g_a['err']:.3g} (plain f32 "
          f"{g_a['plain_f32_err']:.3g}), logdet {g_l['err']:.3g} (plain f32 {g_l['plain_f32_err']:.3g}); "
          f"K5 {c['syrk_update']} launches, {k5_total:.3f} ms by CUDA events around its wrapper's calls in a warm "
          f"fit (its operand copies included); peak device memory {peak / 2**30:.3f} GiB = "
          f"{peak / (n * n * 4):.3f} block rows of {n * n * 4 / 2**30:.3f} GiB; launches {c}")
    check(g_a["ok"] and g_l["ok"], "fit_sharded: alpha or logdet above 3x the plain f32 route's error")
    check(L.shape == (n, n) and bool(torch.isfinite(alpha).all()), "fit_sharded: shapes or non-finite")
    del L
    torch.cuda.empty_cache()

    # the fleet split over the world of one, held to the one-process fleet
    Xf, Yf = fleet_data(P30["B"], P30["nf"], dev)
    kf = tg.Gaussian(2.0, 1.0)
    gp1 = fleet.fit_batched(kf, Xf, Yf, 0.1)
    _cuda.reset_launch_counts()
    gps = fleet.fit_batched_sharded(kf, Xf, Yf, 0.1, mesh=sg.default_mesh(axis="fleet"))
    torch.cuda.synchronize()
    c = _cuda.launch_counts()
    counts_out.append(c)
    check(gps.route == "fleet-crout" and c["gram_batched"] == 1 and c["crout_chol"] == P30["nf"] // 128,
          f"fit_batched_sharded: route {gps.route}, launches {c}")
    same = torch.equal(gps.alpha, gp1.alpha) and torch.equal(gps.L, gp1.L)
    print(f"  (a) fit_batched_sharded B={P30['B']} n={P30['nf']}, route {gps.route}: "
          f"{'bit for bit' if same else 'NOT bit for bit'} the one-process fit_batched; launches {c}")
    check(same, "fit_batched_sharded on one rank differs from fit_batched")

    # the predictive's draws split over the world of one
    nh = P30["nf"]
    Xh, Yh, cfg, z0 = hmc_data(dev)
    Xs = t32(np.linspace(-0.5, 10.5, P30["points"])[:, None])
    theta = t32(np.exp(np.random.default_rng(30).normal(0.0, 0.2, (P30["draws"], 2))))
    p1 = tpred.predictive(tg.Gaussian(1.0, 1.0), theta, Xh, Yh, Xs, 0.1)
    _cuda.reset_launch_counts()
    ps = tpred.predictive_sharded(tg.Gaussian(1.0, 1.0), theta, Xh, Yh, Xs, 0.1, mesh=sg.default_mesh(axis="draws"))
    torch.cuda.synchronize()
    c = _cuda.launch_counts()
    counts_out.append(c)
    check(c["gram_batched"] == 1 and c["crout_chol"] == nh // 128, f"predictive_sharded launches {c}")
    diffs = {f: float((getattr(ps, f) - getattr(p1, f)).abs().max()) for f in ps._fields}
    same_p = all(v == 0.0 for v in diffs.values())
    m64, v64 = plain_mixture(Xh.double(), Yh.double(), Xs.double(), theta, 0.1)
    m32, v32 = plain_mixture(Xh, Yh, Xs, theta, 0.1)
    g_m, g_v = gate(ps.mean, m32, m64), gate(ps.variance, v32, v64)
    print(f"  (a) predictive_sharded {P30['draws']} draws n={nh} at {P30['points']} points: "
          f"{'bit for bit' if same_p else 'within 3x'} the one-process predictive (max diffs {diffs}); "
          f"mean rel err {g_m['err']:.3g} (plain f32 {g_m['plain_f32_err']:.3g}), variance {g_v['err']:.3g} "
          f"(plain f32 {g_v['plain_f32_err']:.3g}); launches {c}")
    check(same_p or (g_m["ok"] and g_v["ok"]), "predictive_sharded: neither bit for bit nor within 3x")

    # the sharded chunked sampler, 16 chains of bench_hmc's posterior, draw for draw
    lp = thmc.make_gp_log_posterior(tg.Gaussian(1.0, 1.0), Xh, Yh, 0.1)
    check(lp.route == "fleet-crout", f"the log posterior took route {lp.route}")
    t0 = time.perf_counter()
    r1 = thmc.sample_hmc_chunked(lp, z0, torch.Generator(dev).manual_seed(5), cfg, chunk_size=4)
    torch.cuda.synchronize()
    t_one = time.perf_counter() - t0
    half = P30["chains"] // 2

    def lp_halves(z):  # the log posterior of half the chains at a time, as each of (b)'s two ranks takes it
        return torch.cat([lp(z[:half]), lp(z[half:])])

    r1h = thmc.sample_hmc_chunked(lp_halves, z0, torch.Generator(dev).manual_seed(5), cfg, chunk_size=4)
    vg = thmc._value_and_grad(lp)
    (v_all, g_all), (v_a, g_a), (v_b, g_b) = vg(z0), vg(z0[:half]), vg(z0[half:])
    bdiff = max(float((torch.cat([v_a, v_b]) - v_all).abs().max()), float((torch.cat([g_a, g_b]) - g_all).abs().max()))
    print(f"  (a) the log posterior and its gradient of {half} chains against the same chains among "
          f"{P30['chains']} (one fleet call each): largest difference {bdiff:.3g}")
    t1 = time.perf_counter()
    _cuda.reset_launch_counts()
    rs = sh.sample_hmc_sharded_chunked(lp, z0, torch.Generator(dev).manual_seed(5), cfg, chunk_size=4)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    c = _cuda.launch_counts()
    counts_out.append(c)
    ident = all(torch.equal(getattr(rs, f), getattr(r1, f)) for f in rs._fields)
    print(f"  (a) sample_hmc_sharded_chunked {P30['chains']} chains, warmup {P30['warmup']}, {P30['samples']} draws, "
          f"L={P30['leapfrog']}: identical to sample_hmc_chunked: {ident}; {t2 - t1:.2f} s against {t_one:.2f} s; "
          f"launches {c}")
    check(ident, "sample_hmc_sharded_chunked on one rank differs from sample_hmc_chunked")
    check(c["crout_chol"] > 0, f"the sharded sampler launched no K7: {c}")
    _cuda.reset_launch_counts()
    dr = dryrun.dryrun_multichip(1)
    torch.cuda.synchronize()
    counts_out.append(_cuda.launch_counts())
    print(f"  (a) dryrun_multichip(1): {dr}")

    # (b) two gloo ranks on the one card (gloo takes CUDA tensors for broadcast, all_reduce and
    # all_gather; NCCL refuses two ranks a card)
    n2 = P30["n2"]
    X2, Y2 = bench_data(n2, d, q, dev)
    alpha1, logdet1, _ = sg.fit_sharded(k, X2, Y2, 0.1, mesh)
    K64 = gaussian64(X2.double(), X2.double(), 8.0, 1.0)
    K64.diagonal().add_(0.01)
    L64 = torch.linalg.cholesky(K64)
    a64_2, ld64_2 = torch.cholesky_solve(Y2.double(), L64), 2.0 * torch.log(L64.diagonal()).sum()
    del K64, L64
    K32 = gaussian64(X2, X2, 8.0, 1.0)
    K32.diagonal().add_(float(np.float32(0.1) ** 2))
    L32 = torch.linalg.cholesky(K32)
    a32_2, ld32_2 = torch.cholesky_solve(Y2, L32), 2.0 * torch.log(L32.diagonal()).sum()
    del K32, L32
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as run_dir:
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--phase30-rank", str(r), "2", run_dir],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
        try:
            outs = [p.communicate(timeout=300)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, o) in enumerate(zip(procs, outs)):
            check(p.returncode == 0, f"phase 30 (b) rank {r} exited {p.returncode}:\n{o[-3000:]}")
        res2 = [dict(np.load(os.path.join(run_dir, f"rank{r}.npz"))) for r in range(2)]
        c2 = [json.load(open(os.path.join(run_dir, f"rank{r}.json"))) for r in range(2)]
    for cr in c2:
        counts_out.append(cr)
    alpha2 = torch.tensor(res2[0]["alpha"], device=dev)
    logdet2 = torch.tensor(res2[0]["logdet"], device=dev)
    check(all(np.array_equal(res2[1][kk], res2[0][kk]) for kk in ("alpha", "logdet")),
          "phase 30 (b): the ranks' replicated alpha or logdet differ")
    g_a2 = gate32(alpha2, a32_2, a64_2)
    g_l2 = gate32(logdet2.reshape(1), ld32_2.reshape(1), ld64_2.reshape(1))
    g_a1 = gate32(alpha1, a32_2, a64_2)
    print(f"  (b) fit_sharded n={n2} on 2 gloo ranks of one card (block rows of {n2 // 2}): alpha rel err "
          f"{g_a2['err']:.3g}, one rank {g_a1['err']:.3g} (plain f32 {g_a2['plain_f32_err']:.3g}); logdet "
          f"{g_l2['err']:.3g} (plain f32 {g_l2['plain_f32_err']:.3g}); 2 ranks vs 1: alpha max diff "
          f"{float((alpha2 - alpha1).abs().max()):.3g}, logdet {float(logdet2 - logdet1):.3g}; one fit "
          f"{float(res2[0]['fit_s']) * 1e3:.1f} / {float(res2[1]['fit_s']) * 1e3:.1f} ms (host clock, each rank); "
          f"peak device memory a rank {float(res2[0]['peak']) / 2**30:.3f} / {float(res2[1]['peak']) / 2**30:.3f} GiB "
          f"= {float(res2[0]['peak']) / (n2 * n2 * 2):.3f} / {float(res2[1]['peak']) / (n2 * n2 * 2):.3f} block rows "
          f"of {n2 * n2 * 2 / 2**30:.3f} GiB; launches {c2}")
    check(g_a2["ok"] and g_l2["ok"], "phase 30 (b): the 2-rank fit above 3x the plain f32 route's error")
    check(all(cr["syrk_update"] > 0 for cr in c2), "phase 30 (b): a rank launched no K5")
    fa2 = torch.tensor(np.concatenate([r_["fleet_alpha"] for r_ in res2]), device=dev)
    same_f = torch.equal(fa2, gp1.alpha)
    if not same_f:
        Kf64 = torch.func.vmap(lambda x: gaussian64(x, x, 2.0, 1.0))(Xf.double())
        Kf64.diagonal(dim1=1, dim2=2).add_(0.01)
        af64 = torch.cholesky_solve(Yf.double(), torch.linalg.cholesky(Kf64))
        Kf32 = torch.func.vmap(lambda x: gaussian64(x, x, 2.0, 1.0))(Xf)
        Kf32.diagonal(dim1=1, dim2=2).add_(float(np.float32(0.1) ** 2))
        g_f = gate(fa2, torch.cholesky_solve(Yf, torch.linalg.cholesky(Kf32)), af64)
        check(g_f["ok"], "phase 30 (b): the 2-rank fleet above 3x the plain f32 route's error")
    print(f"  (b) fit_batched_sharded B={P30['B']} over 2 ranks ({P30['B'] // 2} members each, route "
          f"{res2[0]['route']}): {'bit for bit' if same_f else 'within 3x the plain f32 route of'} the "
          f"one-process fit_batched")
    check(all(cr["gram_batched"] > 0 and cr["crout_chol"] > 0 for cr in c2), "phase 30 (b): a rank's fleet missed K6 or K7")
    def same_as(r):
        return all(np.array_equal(r_[f"hmc_{f}"], getattr(r, f).cpu().numpy()) for r_ in res2 for f in r._fields)

    hdiff = {f: max(float(np.abs(r_[f"hmc_{f}"] - getattr(r1, f).cpu().numpy()).max()) for r_ in res2)
             for f in r1._fields}
    ident_h, ident2 = same_as(r1h), same_as(r1)
    print(f"  (b) sample_hmc_sharded_chunked {P30['chains']} chains over 2 ranks ({half} a rank): identical on both "
          f"ranks to (a)'s sample_hmc_chunked with the log posterior taken {half} chains at a time: {ident_h}; "
          f"to (a)'s with all {P30['chains']} at once: {ident2} (largest differences {hdiff})")
    check(ident_h, "phase 30 (b): the 2-rank chunked sampler differs from one process taking the same fleets")
    check(ident2 or bdiff > 0, "phase 30 (b): the 2-rank chunked sampler differs from one process, whose "
          "log posterior does not depend on the fleet's size")

    # (c) fit_sharded's time beside fit and the library's factor + solve, n=16384
    def ev(fn):
        a_, b_ = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a_.record()
        fn()
        b_.record()
        b_.synchronize()
        return a_.elapsed_time(b_)

    def lib_fit():
        K_ = gaussian64(X, X, 8.0, 1.0)
        K_.diagonal().add_(float(np.float32(0.1) ** 2))
        return torch.cholesky_solve(Y, torch.linalg.cholesky(K_))

    def in_turns(runs):
        times = {name: [] for name in runs}
        for fn in runs.values():
            fn()
        order = list(runs) + list(runs)[::-1]
        for _ in range(P30["reps"]):
            for name in order:
                times[name].append(ev(runs[name]))
        return {name: float(np.median(v)) for name, v in times.items()}

    med = in_turns({"fit_sharded": lambda: sg.fit_sharded(k, X, Y, 0.1, mesh),
                    "fit": lambda: tg.fit(k, X, Y, sigma=0.1), "library": lib_fit})
    print(f"  (c) n={n}, CUDA events, median of {2 * P30['reps']} in turns: fit_sharded (1 rank) "
          f"{med['fit_sharded']:.2f} ms, fit (route {tg.fit(k, X, Y, sigma=0.1).route}) {med['fit']:.2f} ms, "
          f"torch Gram + linalg.cholesky + cholesky_solve {med['library']:.2f} ms ({smi})")
    fmesh, pmesh = sg.default_mesh(axis="fleet"), sg.default_mesh(axis="draws")
    med = in_turns({"fit_batched_sharded": lambda: fleet.fit_batched_sharded(kf, Xf, Yf, 0.1, mesh=fmesh),
                    "fit_batched": lambda: fleet.fit_batched(kf, Xf, Yf, 0.1),
                    "predictive_sharded": lambda: tpred.predictive_sharded(tg.Gaussian(1.0, 1.0), theta, Xh, Yh, Xs,
                                                                           0.1, mesh=pmesh),
                    "predictive": lambda: tpred.predictive(tg.Gaussian(1.0, 1.0), theta, Xh, Yh, Xs, 0.1)})
    print(f"  (c) 1 rank, CUDA events, median of {2 * P30['reps']} in turns: fit_batched_sharded "
          f"{med['fit_batched_sharded']:.3f} ms against fit_batched {med['fit_batched']:.3f} ms (B={P30['B']}, "
          f"n={P30['nf']}); predictive_sharded {med['predictive_sharded']:.3f} ms against predictive "
          f"{med['predictive']:.3f} ms ({P30['draws']} draws, {P30['points']} points; {smi})")
    torch.cuda.empty_cache()

    # (d) cho_solve_blocked against two triangular solves on a row-major factor
    Kd = gaussian64(X, X, 8.0, 1.0)
    Kd.diagonal().add_(float(np.float32(0.1) ** 2))
    Ld = torch.linalg.cholesky(Kd).contiguous()
    del Kd
    for qq in P30["solve_q"]:
        B_ = t32(np.random.default_rng(qq).standard_normal((n, qq)))

        def two_tri():
            return torch.linalg.solve_triangular(Ld.mT, torch.linalg.solve_triangular(Ld, B_, upper=False),
                                                 upper=True)

        def blk():
            return blocked.cho_solve_blocked(Ld, B_)

        reps = 2 if qq > 1024 else 5
        tt = {"blocked": [], "triangular": []}
        blk(), two_tri()
        for _ in range(reps):
            tt["blocked"].append(ev(blk))
            tt["triangular"].append(ev(two_tri))
            tt["triangular"].append(ev(two_tri))
            tt["blocked"].append(ev(blk))
        Xb_, Xt_ = blk(), two_tri()
        diff = float((Xb_ - Xt_).abs().max() / Xt_.abs().max())
        print(f"  (d) n={n} q={qq}: cho_solve_blocked {float(np.median(tt['blocked'])):.3f} ms, two "
              f"solve_triangular {float(np.median(tt['triangular'])):.3f} ms (medians of {2 * reps}, in turns; "
              f"{smi}); rel diff {diff:.3g}")
        del B_, Xb_, Xt_
    del Ld
    torch.cuda.empty_cache()
    sg.shutdown()
    print(f"  phase 30 wall time {time.perf_counter() - t30:.1f} s")
    return counts_out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1

    import gpr_tpu_torch as tg
    from gpr_tpu_torch.gp import likelihood as lk
    from gpr_tpu_torch.inference import priors
    from gpr_tpu_torch.gp import batched as fleet
    from gpr_tpu_torch.ops import _cuda, blocked, fullchol, syrk
    from gpr_tpu_torch.ops import batched as fbatched
    from gpr_tpu_torch.ops import crout as fcrout
    from gpr_tpu_torch.ops import leaf as tleaf
    from gpr_tpu_torch.ops import gram as gop
    from gpr_tpu_torch.gp import exact as texact
    from gpr_tpu_torch.ops import linalg as tlin
    from gpr_tpu_torch.ops import solve as nsolve
    from gpr_tpu_torch.ops import inplace_chol as tinp
    from gpr_tpu_torch.ops import panel as tpanel
    from gpr_tpu_torch.ops import chol as tchol

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)} | {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    t0 = t_start = time.perf_counter()
    lib = _cuda.build()
    _cuda.library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {lib.name}")
    entry = "?"
    for line in lib.with_suffix(".ptxas.txt").read_text().splitlines():
        if "Compiling entry function" in line:  # '_ZN3gpr<len><name>...': the kernel's name
            mangled = line.split("'")[1]
            m = re.match(r"_ZN3gpr(\d+)", mangled)
            entry = mangled[m.end():m.end() + int(m.group(1))] if m else mangled
        elif "registers" in line or "spill" in line and " 0 bytes spill" not in line:
            print(f"  ptxas {entry}:", line.strip().removeprefix("ptxas info    : "))

    def t32(a):
        return torch.tensor(np.ascontiguousarray(a), dtype=torch.float32, device=dev)

    kstats = {}

    # ---------------------------------------------------------------- 1 ----
    rng = np.random.default_rng(3)
    worst = 0.0
    for form in gop.FORMS:
        for tril in (False, True):
            n, m, d = 200, (200 if tril else 150), 37
            X = t32(rng.standard_normal((n, d)))
            Y = X if tril else t32(rng.standard_normal((m, d)))
            args = (X, Y, 1.7, 1.2, 0.7 if form == "periodic" else 2.0, 0.37)
            K = gop.gram(*args, form=form, tril=tril)
            R = gop.gram_reference(*args, form=form, tril=tril)
            if tril:
                K, R = torch.tril(K), torch.tril(R)
            err = float((K - R).abs().max()) / (float(R.abs().max()) if form == "sqdist" else 1.44)
            # d2's float32 cancellation near the diagonal is ~1e-7 |x|^2 and
            # dk/dd2 <= 1.5 scale^2 / sigma^2; matern12's sqrt(d2) cusp turns
            # it into sqrt(1e-7 |x|^2)
            check(err <= (1e-2 if form == "matern12" else 3e-5), f"K1 {form} tril={tril}: {err}")
            worst = max(worst, err) if form != "matern12" else worst
    # the tensor-core path (gaussian, rq, matern32, matern52, sqdist; matern12
    # and periodic stay FP32) at widths a multiple of 4, ragged against the
    # 128 tiles, |x|^2 ~ 4; in tril mode nothing above the diagonal written
    worst_tc = 0.0
    for d in (128, 64):
        for n, m, tril in ((200, 150, False), (383, 383, True)):
            X = t32(rng.standard_normal((n, d)) * (2.0 / np.sqrt(d)))
            Y = X if tril else t32(rng.standard_normal((m, d)) * (2.0 / np.sqrt(d)))
            for form in gop.FORMS:
                args = (1.7, 1.2, 0.7 if form == "periodic" else 2.0, 0.37)
                K = torch.full((n, m), 12345.0, device=dev)
                _cuda.GRAM.launch(dev, X.data_ptr(), Y.data_ptr(), K.data_ptr(), n, m, d, gop.FORMS.index(form),
                                  *args, int(tril))
                R = gop.gram_reference(X, Y, *args, form=form)
                if tril:
                    low = torch.ones((n, m), dtype=torch.bool, device=dev).tril_()
                    check(bool(torch.all(K[~low] == 12345.0)), f"K1 {form} d={d} tril wrote above the diagonal")
                    K, R = K[low], R[low]
                err = float((K - R).abs().max()) / (float(R.abs().max()) if form == "sqdist" else 1.44)
                check(err <= (1e-2 if form == "matern12" else 3e-5), f"K1 {form} d={d} n={n} m={m}: {err}")
                worst_tc = max(worst_tc, err) if form not in ("matern12", "periodic") else worst_tc
    torch.cuda.synchronize()
    print(f"phase 1a K1 gram_tile: 7 forms x (full, tril) at n=200 m=150 d=37 ok; "
          f"worst smooth-form error {worst:.3g} of scale^2; tensor-core path at d = 128, 64 (200 x 150, "
          f"tril 383, nothing above the diagonal written) ok, worst error {worst_tc:.3g}")

    for n in (128, 384):
        B = rng.standard_normal((n, n))
        A = t32(B @ B.T + n * np.eye(n))
        An = A.clone()
        An[torch.triu(torch.ones_like(A, dtype=torch.bool), 1)] = float("nan")
        L = fullchol.cholesky_fused(An)
        Lr, _ = fullchol.fused_cholesky_reference(A)
        e = relerr(L, Lr)
        check(e < 1e-4, f"matrix mode n={n}: {e}")
        check(bool(torch.all(torch.triu(L, 1) == 0)), f"matrix mode n={n}: strict upper not 0")
    for n in (128, 300, 512):
        X = t32(rng.standard_normal((n, 5)))
        L, W = fullchol.gram_cholesky_fused(X, 1.3, 2.1, 1.0, 0.7, return_winv=True)
        Lr, Wr = fullchol.fused_cholesky_reference(X, form="gaussian", sigma=1.3, scale=2.1,
                                                   diag=0.7)
        check(relerr(L, Lr) < 1e-4 and relerr(W, Wr) < 1e-4, f"gram mode n={n}")
        eye = torch.eye(128, device=dev)
        for j in range(W.shape[0]):
            Ljj = L[j * 128:(j + 1) * 128, j * 128:(j + 1) * 128]
            check(float((W[j] @ Ljj - eye).abs().max()) < 1e-4, f"W_j L_jj != I, n={n} j={j}")
        check(bool(torch.all(L[n:, :n] == 0) and torch.all(torch.triu(L, 1) == 0)),
              f"gram mode n={n}: pad block or strict upper not 0")
    for where in (3, 380):
        B = rng.standard_normal((384, 384))
        A = B @ B.T + 384 * np.eye(384)
        A[where, where] = -1e6
        check(not bool(torch.isfinite(fullchol.cholesky_fused(t32(A))[-1, -1])),
              f"failed pivot at {where} did not poison L[-1,-1]")
    torch.cuda.synchronize()
    print("phase 1b K2-K4: aligned, padded, single panel, lower-only read, "
          "failed pivot (first and last panel), W_j L_jj = I: ok")

    # each kernel at the shapes the n=16384 fit gives it
    n, d, q = 16384, 128, 8
    rng0 = np.random.default_rng(0)
    Xb = t32(rng0.standard_normal((n, d)))
    Yb = t32(rng0.standard_normal((n, q)))
    Xt = t32(np.random.default_rng(1).standard_normal((1024, d)))
    gram_args = ("gaussian", 8.0, 1.0, 1.0, float(np.float32(0.1) ** 2))
    nc = n // fullchol.PANEL
    L = torch.empty((n, n), dtype=torch.float32, device=dev)
    W = torch.empty((nc, 128, 128), dtype=torch.float32, device=dev)
    j0 = nc // 2
    for j in range(j0):
        fullchol.panel_update(L, j, Xb, *gram_args)
        fullchol.diag_factor_inv(L, W, j)
        fullchol.panel_solve(L, W, j)
    cols = slice(j0 * 128, (j0 + 1) * 128)
    Lref = L.clone()
    fullchol.panel_update(L, j0, Xb, *gram_args)
    fullchol.panel_update_reference(Lref, j0, Xb, *gram_args)
    kstats["panel_update"] = {"max_abs_err": float((L[:, cols] - Lref[:, cols]).abs().max())}
    Lref.copy_(L)
    Wref = W.clone()
    fullchol.diag_factor_inv(L, W, j0)
    fullchol.diag_factor_inv_reference(Lref, Wref, j0)
    kstats["diag_factor_inv"] = {"max_abs_err": max(
        float((L[cols, cols] - Lref[cols, cols]).abs().max()),
        float((W[j0] - Wref[j0]).abs().max()))}
    Lref.copy_(L)
    fullchol.panel_solve(L, W, j0)
    fullchol.panel_solve_reference(Lref, W, j0)
    kstats["panel_solve"] = {"max_abs_err": float((L[:, cols] - Lref[:, cols]).abs().max())}
    # K2 at a late panel (k = 15872): few row tiles, the k range dealt out to the SMs
    j1 = nc - 4
    for j in range(j0 + 1, j1):
        fullchol.panel_update(L, j, Xb, *gram_args)
        fullchol.diag_factor_inv(L, W, j)
        fullchol.panel_solve(L, W, j)
    cols1 = slice(j1 * 128, (j1 + 1) * 128)
    Lref.copy_(L)
    fullchol.panel_update(L, j1, Xb, *gram_args)
    fullchol.panel_update_reference(Lref, j1, Xb, *gram_args)
    kstats["panel_update"]["max_abs_err"] = max(kstats["panel_update"]["max_abs_err"], float(
        (L[:, cols1] - Lref[:, cols1]).abs().max()))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks1c = {j: fullchol._split_plan(n, j, sms) for j in (j0, j1)}
    Xg = Xb[:384].contiguous()
    K1 = gop.gram(Xg, Xg, 8.0, 1.0, 1.0, gram_args[4])
    kstats["gram_tile"] = {"max_abs_err": float(
        (K1 - gop.gram_reference(Xg, Xg, 8.0, 1.0, 1.0, gram_args[4])).abs().max())}
    del L, Lref, W, Wref
    torch.cuda.synchronize()
    for name, tol in (("gram_tile", 1e-5), ("panel_update", 1e-4), ("diag_factor_inv", 1e-3),
                      ("panel_solve", 1e-4)):
        e = kstats[name]["max_abs_err"]
        check(e <= tol, f"{name} at the n=16384 shapes: max abs err {e} > {tol}")
    print("phase 1c each kernel at the n=16384 fit's shapes (panel j=%d; K2 also at j=%d): %s; "
          "K2 product blocks %s" % (
              j0, j1, ", ".join(f"{k} {v['max_abs_err']:.3g}" for k, v in kstats.items()),
              ", ".join(f"j={j}: {b}" for j, b in blocks1c.items())))

    # K5 on the lower triangle, in place on views of one buffer with the
    # n=16383 recursion's row stride (rows not 16-byte aligned): a ragged
    # shape and the top-level trailing updates of n=3773 (1853 x 1920) and
    # n=16383 (8191 x 8192).  float32 sums of k terms in another order than
    # cuBLAS's: the error relative to the largest |S| grows like sqrt(k) eps,
    # so the gate is 1e-5 sqrt(k).
    g5 = torch.Generator(device=dev).manual_seed(5)
    buf5 = torch.empty((16383, 16383), dtype=torch.float32, device=dev)
    for m, k in ((200, 130), (1853, 1920), (8191, 8192)):
        A22, L21 = buf5[k:k + m, k:k + m], buf5[k:k + m, :k]
        A22.copy_(torch.randn((m, m), generator=g5, device=dev))
        L21.copy_(torch.randn((m, k), generator=g5, device=dev) / math.sqrt(k))
        R = syrk.syrk_update_reference(A22, L21)
        S = syrk.syrk_update(A22, L21, out=A22)
        low = torch.ones((m, m), dtype=torch.bool, device=dev).tril_()
        err = float((S - R)[low].abs().max())
        scale = float(R[low].abs().max())
        check(err <= 1e-5 * math.sqrt(k) * scale, f"K5 at m={m} k={k}: {err} of {scale}")
        print(f"phase 1d K5 syrk_update m={m} k={k} (row stride 16383, in place): max abs err "
              f"{err:.3g} (largest |S| {scale:.3g})")
        del A22, L21, S, R, low
    del buf5
    kstats["syrk_update"] = {"max_abs_err": err}  # at the n=16383 top level
    torch.cuda.empty_cache()

    # K6 on every form at a ragged shape with distinct per-member parameters,
    # then at the full-width fleet shape (the tolerances of K1 above)
    g6 = np.random.default_rng(6)
    for form in gop.FORMS:
        X6 = t32(g6.standard_normal((3, 200, 37)))
        P6 = t32([[1.7, 1.2, 0.7 if form == "periodic" else 2.0, 0.37],
                  [1.3, 0.9, 0.5 if form == "periodic" else 1.5, 0.1],
                  [2.2, 1.4, 0.9 if form == "periodic" else 3.0, 0.01]])
        K = gop.gram_batched(X6, P6, form=form)
        R = gop.gram_batched_reference(X6, P6, form=form)
        err = float((K - R).abs().max()) / (float(R.abs().max()) if form == "sqdist" else 1.96)
        check(err <= (1e-2 if form == "matern12" else 3e-5), f"K6 {form}: {err}")
    Bf, nf, df_, qf = 128, 512, 8, 4
    rf = np.random.default_rng(0)  # benchmarks/bench_batched.py:31-34
    Xf = t32(rf.standard_normal((Bf, nf, df_)))
    Yf = t32(rf.standard_normal((Bf, nf, qf)))
    Xsf = t32(np.random.default_rng(1).standard_normal((Bf, 64, df_)))
    sigf = float(np.float32(0.1))
    Pf = t32(np.tile([2.0, 1.0, 1.0, sigf * sigf], (Bf, 1)))
    Kf = gop.gram_batched(Xf, Pf)
    kstats["gram_batched"] = {"max_abs_err": float((Kf - gop.gram_batched_reference(Xf, Pf))
                                                   .abs().max())}
    check(kstats["gram_batched"]["max_abs_err"] <= 3e-5, "K6 at the full-width fleet shape")
    check(bool(torch.equal(Kf, Kf.mT)), "K6 at the full-width fleet shape: not exactly symmetric")
    # the larger fleet: B=256, n=1024 (benchmarks/bench_batched.py's data, seed 11)
    X6 = t32(np.random.default_rng(11).standard_normal((256, 1024, df_)))
    P6 = t32(np.tile([2.0, 1.0, 1.0, sigf * sigf], (256, 1)))
    K = gop.gram_batched(X6, P6)
    err6 = float((K - gop.gram_batched_reference(X6, P6)).abs().max())
    check(err6 <= 3e-5 and bool(torch.equal(K, K.mT)), f"K6 at B=256 n=1024: {err6} or not symmetric")
    del X6, P6, K
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    print(f"phase 1e K6 gram_batched: 7 forms at B=3 n=200 d=37 ok; B={Bf} n={nf} d={df_}: max abs "
          f"err {kstats['gram_batched']['max_abs_err']:.3g}; B=256 n=1024: {err6:.3g}; both exactly symmetric")

    # K7: odd and even tiles with NaN above the diagonal (lower-only read) and
    # one member that is not positive definite; then the first diagonal
    # block of the full-width fleet factorization
    for b in (1, 17, 32, 64, 33, 96, 128):
        G7 = torch.tensor(g6.standard_normal((6, b, b)), device=dev)
        A7 = (G7 @ G7.mT + b * torch.eye(b, device=dev, dtype=G7.dtype)).float()
        A7[4, b // 3, b // 3] = -1.0
        junk = A7.clone()
        junk[:, torch.triu(torch.ones((b, b), dtype=torch.bool, device=dev), 1)] = float("nan")
        L7 = fcrout.crout_chol(junk)
        R7 = fcrout.crout_chol_reference(A7)
        ok = [0, 1, 2, 3, 5]
        err = float((L7[ok] - R7[ok]).abs().max() / R7[ok].abs().max())
        check(err <= 1e-5, f"K7 b={b}: {err}")
        check(bool(torch.all(torch.triu(L7, 1) == 0)), f"K7 b={b}: strict upper not 0")
        check(bool(torch.isnan(L7[4, -1, -1])) and not bool(torch.isfinite(R7[4, -1, -1])),
              f"K7 b={b}: the failed member's L[-1, -1] is {float(L7[4, -1, -1])}")
        check(bool(torch.isfinite(L7[ok]).all()), f"K7 b={b}: a failure leaked into another tile")
    D7 = Kf[:, :fbatched.PANEL, :fbatched.PANEL].contiguous()
    L7 = fcrout.crout_chol(D7)
    kstats["crout_chol"] = {"max_abs_err": float((L7 - fcrout.crout_chol_reference(D7)).abs().max())}
    check(kstats["crout_chol"]["max_abs_err"] <= 1e-5, "K7 at the fleet's first diagonal block")
    del D7, L7
    torch.cuda.synchronize()
    print(f"phase 1f K7 crout_chol: b=1, 17, 32, 64, 33, 96, 128 with NaN upper and one non-SPD member ok; "
          f"B={Bf} b={fbatched.PANEL}: max abs err {kstats['crout_chol']['max_abs_err']:.3g}")

    # K8: the tiles of 1f, with NaN above the diagonal and one member that is
    # not positive definite, strided and in place (the lower-right blocks of a
    # (6, 2b, 2b) buffer); then the tiles the main paths give it: the
    # (B n / 64, 64, 64) tiles D D^T of the fused fleet's backward (D the
    # diagonal blocks of the fleet's factor) and the fleet's first (B, 128,
    # 128) diagonal block under GPR_FLEET_DIAG=crout.  L and W get 1e-5 and
    # 1e-4 of their largest entry; on D D^T, whose condition is cond(D)^2
    # (~4e3 here), two float32 inverse factors differ by up to ~cond eps, so
    # W and L (= D) get 1e-3 there.
    tri = {b: torch.triu(torch.ones((b, b), dtype=torch.bool, device=dev), 1) for b in (32, 33, 64, 128)}
    for b in (32, 64, 33, 128):
        G8 = torch.tensor(g6.standard_normal((6, b, b)), device=dev)
        A8 = (G8 @ G8.mT + b * torch.eye(b, device=dev, dtype=G8.dtype)).float()
        A8[4, b // 3, b // 3] = -1.0
        buf = torch.zeros((6, 2 * b, 2 * b), device=dev)
        D8 = buf[:, b:, b:]
        D8.copy_(A8)
        D8[:, tri[b]] = float("nan")
        L8, W8 = fcrout.crout_chol_wi(D8, L_out=D8)
        R8, RW8 = fcrout.crout_chol_wi_reference(A8)
        ok = [0, 1, 2, 3, 5]
        e_l, e_w = relerr(L8[ok], R8[ok]), relerr(W8[ok], RW8[ok])
        check(e_l <= 1e-5 and e_w <= 1e-4, f"K8 b={b}: L {e_l}, W {e_w}")
        check(bool(torch.all(L8[:, tri[b]] == 0) and torch.all(W8[:, tri[b]] == 0)),
              f"K8 b={b}: strict upper not 0")
        check(bool(torch.isnan(L8[4, -1, -1]) and torch.isnan(W8[4, -1, -1])),
              f"K8 b={b}: the failed member's L[-1, -1], W[-1, -1] are not NaN")
        check(bool(torch.isfinite(L8[ok]).all() and torch.isfinite(W8[ok]).all()),
              f"K8 b={b}: a failure leaked into another tile")
        check(bool((buf[:, :b] == 0).all() and (buf[:, b:, :b] == 0).all()),
              f"K8 b={b}: wrote outside its view")
    pf9 = fbatched.FUSED_PANEL
    Lf = fbatched.cholesky_batched(Kf)
    Df = torch.stack([Lf[:, i * pf9:(i + 1) * pf9, i * pf9:(i + 1) * pf9]
                      for i in range(nf // pf9)], 1).reshape(-1, pf9, pf9)
    DDt = torch.matmul(Df, Df.mT)
    L8, W8 = fcrout.crout_chol_wi(DDt)
    R8, RW8 = fcrout.crout_chol_wi_reference(DDt)
    kstats["crout_chol_wi"] = {"max_abs_err": float((W8 - RW8).abs().max())}
    e_w, e_d = relerr(W8, RW8), relerr(L8, Df)
    check(e_w <= 1e-3 and e_d <= 1e-3, f"K8 on D D^T: W {e_w}, L against D {e_d}")
    D8 = Kf[:, :fbatched.PANEL, :fbatched.PANEL].contiguous()
    L8, W8 = fcrout.crout_chol_wi(D8)
    R8, RW8 = fcrout.crout_chol_wi_reference(D8)
    e_l, e_w = relerr(L8, R8), relerr(W8, RW8)
    check(e_l <= 1e-5 and e_w <= 1e-4, f"K8 at the fleet's first diagonal block: L {e_l}, W {e_w}")
    del Lf, Df, L8, W8, R8, RW8, D8
    torch.cuda.synchronize()
    print(f"phase 1g K8 crout_chol_wi: b=32, 64, 33, 128 with NaN upper, one non-SPD member, strided "
          f"in place ok; D D^T tiles ({DDt.shape[0]} x {pf9}^2): W max abs err "
          f"{kstats['crout_chol_wi']['max_abs_err']:.3g}, rel {e_w:.3g}; B={Bf} b={fbatched.PANEL} ok")

    # K9: B=3, n = 128, 256, 384 at the fused panel and n = 384 at panel 128 (3
    # panels, each depending on the ones before), q = 1 and 4, with NaN above
    # the diagonal and member 1 failing in its last panel; factor 1e-5 and alpha
    # 1e-4 of their largest entry.  Then at full width, the fleet's K (B=128,
    # n=512) and Yf: the factor to 1e-4 absolute, alpha within 3x the plain
    # version's error against a float64 solve.
    g9 = np.random.default_rng(9)
    for n9, p9 in ((128, pf9), (256, pf9), (384, pf9), (384, 128)):
        up9 = torch.triu(torch.ones((n9, n9), dtype=torch.bool, device=dev), 1)
        for q9 in (1, 4):
            G9 = torch.tensor(g9.standard_normal((3, n9, n9)), device=dev)
            A9 = (G9 @ G9.mT + n9 * torch.eye(n9, device=dev, dtype=G9.dtype)).float()
            A9[1, n9 - 5, n9 - 5] = -1e4
            Y9 = t32(g9.standard_normal((3, n9, q9)))
            junk = A9.clone()
            junk[:, up9] = float("nan")
            L9, X9 = fbatched.factor_solve_fused(junk, Y9, p9)
            R9, RX9 = fbatched.factor_solve_fused_reference(A9, Y9, p9)
            ok = [0, 2]
            e_l, e_x = relerr(L9[ok], R9[ok]), relerr(X9[ok], RX9[ok])
            check(e_l <= 1e-5 and e_x <= 1e-4, f"K9 n={n9} p={p9} q={q9}: L {e_l}, alpha {e_x}")
            check(bool(torch.all(L9[:, up9] == 0)), f"K9 n={n9} p={p9}: strict upper not 0")
            check(bool(torch.isnan(L9[1, -1, -1]) and torch.isnan(X9[1]).any()),
                  f"K9 n={n9} p={p9}: the failed member is not NaN")
            check(bool(torch.isfinite(L9[ok]).all() and torch.isfinite(X9[ok]).all()),
                  f"K9 n={n9} p={p9}: a failure leaked into another member")
    del G9, A9, junk, L9, X9, R9, RX9
    L9, X9 = fbatched.factor_solve_fused(Kf, Yf)
    R9, RX9 = fbatched.factor_solve_fused_reference(Kf, Yf)
    K64 = torch.tril(Kf.double()) + torch.tril(Kf.double(), -1).mT
    X64 = torch.linalg.solve(K64, Yf.double())
    e_k, e_p = relerr(X9, X64), relerr(RX9, X64)
    kstats["fleet_fused"] = {"max_abs_err": float((X9 - RX9).abs().max())}
    e_l = float((L9 - R9).abs().max())
    check(e_l <= 1e-4 and e_k <= 3 * e_p, f"K9 at full width: L {e_l}, alpha {e_k} (plain {e_p})")
    del Kf, L9, X9, R9, RX9, K64, X64
    torch.cuda.synchronize()
    print(f"phase 1h K9 fleet_fused: B=3, n=128, 256, 384 (p={pf9}) and 384 (p=128), q=1 and 4, NaN "
          f"upper, failed member ok; B={Bf} n={nf} q={qf}: alpha max abs err vs plain "
          f"{kstats['fleet_fused']['max_abs_err']:.3g}, rel err vs f64 {e_k:.3g} (plain {e_p:.3g}), "
          f"L max abs err {e_l:.3g}")

    # -------------------------------------------------------- references ---
    def plain_mll(X, Y, sigma, params):
        """(value per output, gradient) of the straightforward marginal
        likelihood of Gaussian(*params) in the dtype of X: torch Gram,
        torch.linalg.cholesky, cholesky_solve, autograd.  log|K| is clamped
        to the reference's long-double range (include/Likelihood.h:180-188),
        as the port clamps it: at sigma 0.1 and these n it lies below it."""
        n = X.shape[0]
        p = torch.tensor(params, dtype=torch.float64, device=X.device, requires_grad=True)
        with torch.enable_grad():
            K = gaussian64(X, X, p[0], p[1])
            K = K + torch.diag(torch.full((n,), sigma * sigma, dtype=K.dtype, device=X.device))
            L = torch.linalg.cholesky(K)
            alpha = torch.cholesky_solve(Y, L)
            df = -0.5 * (Y * alpha).sum(0)
            cp = -0.5 * torch.clamp(2.0 * torch.log(torch.diagonal(L)).sum(),
                                    -LDBL_LOG_MAX, LDBL_LOG_MAX)
            ct = -n / 2.0 * math.log(2 * math.pi)
            (g,) = torch.autograd.grad(df.sum() + cp + ct, p)
        return (df + cp + ct).detach(), g

    def hold_mll(name, params, X, Y, v, g, sigma):
        """The port's value and gradient against the float64 plain MLL, within
        3x the plain float32 MLL's error; returns the two gates."""
        v64, g64 = plain_mll(X.double(), Y.double(), sigma, params)
        v32, g32 = plain_mll(X, Y, sigma, params)
        gates = {"value": gate(v, v32, v64), "gradient": gate(g, g32, g64)}
        print(f"  {name}: rel err vs f64: " + ", ".join(
            f"{k} {r['err']:.3g} (plain f32 {r['plain_f32_err']:.3g})" for k, r in gates.items()))
        check(all(r["ok"] for r in gates.values()), f"{name}: error above 3x the plain f32 MLL's")
        return gates

    def judge(name, gp, X, Y, Xs, kfun, kss, sigma, with_alpha=False):
        """Mean and credible interval at Xs (and alpha) within 3x the plain
        float32 route's error against float64; returns the gates."""
        mean = gp.predict(Xs)
        ci = gp.credible_interval(Xs)
        check(mean.shape == (Xs.shape[0], Y.shape[1]) and ci.shape == (Xs.shape[0],),
              f"{name}: output shapes")
        check(bool(torch.isfinite(mean).all() and torch.isfinite(ci).all()), f"{name}: non-finite")
        gates = fit_gates(gp, X, Y, Xs, kfun, kss, sigma)
        if not with_alpha:
            del gates["alpha"]
        K64 = kfun(X.double(), X.double())
        K64.diagonal().add_(sigma * sigma)
        res = float((K64 @ gp.alpha.double() - Y.double()).norm() / Y.double().norm())
        del K64
        print(f"  {name}: route {gp.route}; rel err vs f64: " + ", ".join(
            f"{k} {r['err']:.3g} (plain f32 {r['plain_f32_err']:.3g})" for k, r in gates.items())
            + f"; residual |(K+s^2I)a-Y|/|Y| {res:.3g}")
        check(all(r["ok"] for r in gates.values()), f"{name}: error above 3x the plain f32 route's")
        return gates

    sig = float(np.float32(0.1))

    # ---------------------------------------------------------------- 2 ----
    _cuda.reset_launch_counts()
    bench_k = tg.Gaussian(8.0, 1.0)
    gp = tg.fit(bench_k, Xb, Yb, sigma=0.1, use_pallas_gram=True)
    check(gp.route == "fused-gram", f"bench fit took route {gp.route}")
    torch.cuda.synchronize()
    print("phase 2 slice at full size: n=16384 d=128 q=8, 1024 test points")
    judge("bench Gaussian(8,1)", gp, Xb, Yb, Xt, lambda A, B: gaussian64(A, B, 8.0, 1.0),
          1.0, sig)
    del gp

    # ---------------------------------------------------------------- 3 ----
    n3, d3, q3 = 4096, 8, 4
    r3 = np.random.default_rng(0)  # __graft_entry__._make_dataset's seeds
    X3 = r3.standard_normal((n3, d3)).astype(np.float32)
    Y3 = (np.sin(X3.sum(axis=1, keepdims=True)) + 0.1 * r3.standard_normal((n3, q3)))
    Xs3 = np.random.default_rng(1).standard_normal((64, d3)).astype(np.float32)
    check(len(np.unique(X3, axis=0)) == n3, "entry data rows must be distinct")
    X3, Y3, Xs3 = t32(X3), t32(Y3), t32(Xs3)
    entry_k = tg.Sum(tg.Gaussian(1.5, 1.0), tg.White(0.1))
    gp = tg.fit(entry_k, X3, Y3, sigma=0.1)
    check(gp.route == "fused-matrix", f"entry fit took route {gp.route}")

    def entry64(A, B):  # distinct rows: White adds its 0.01 on the diagonal of K(X, X) only
        K = gaussian64(A, B, 1.5, 1.0)
        if A is B:
            K.diagonal().add_(0.01)
        return K

    torch.cuda.synchronize()
    print("phase 3 entry model in matrix mode: n=4096 d=8 q=4, 64 test points")
    judge("entry Sum(Gaussian,White)", gp, X3, Y3, Xs3, entry64, 1.01, sig)

    # ---------------------------------------------------------------- 4 ----
    print("phase 4 unaligned n")
    r4 = np.random.default_rng(4)
    X4 = t32(r4.standard_normal((3773, 5)))
    Y4 = t32(np.sin(r4.standard_normal((3773, 3))) + 0.1 * r4.standard_normal((3773, 3)))
    Xs4 = t32(r4.standard_normal((256, 5)))
    k4 = tg.Gaussian(2.0, 1.0)
    gp = tg.fit(k4, X4, Y4, sigma=0.1, use_pallas_gram=True)
    check(gp.route == "fused-gram" and gp.L.shape == (3773, 3773), "n=3773 route / factor shape")
    breathing = {"shape": "n=3773 d=5 q=3 float32, Gaussian(2, 1) start, sigma 0.1",
                 "fit n=3773 (fused-gram)": judge("n=3773 d=5 q=3 (pad to 3840)", gp, X4, Y4, Xs4,
                                                  lambda A, B: gaussian64(A, B, 2.0, 1.0), 1.0, sig,
                                                  with_alpha=True)}
    gp = tg.fit(bench_k, Xb[:384], Yb[:384], sigma=0.1, use_pallas_gram=True)
    check(gp.route == "gram-kernel", f"n=384 fit took route {gp.route}")
    judge("n=384 d=128 q=8", gp, Xb[:384], Yb[:384], Xt[:64],
          lambda A, B: gaussian64(A, B, 8.0, 1.0), 1.0, sig)

    # ---------------------------------------------------------------- 5 ----
    xs = torch.tensor(np.arange(10) * 2 * math.pi / 10, dtype=torch.float64, device=dev)
    xt = torch.tensor(np.arange(50) * 2 * math.pi / 50, dtype=torch.float64, device=dev)
    gp = tg.fit(tg.Gaussian(2.889), xs[:, None], torch.sin(xs)[:, None], sigma=0.0)
    err = float((gp.predict(xt[:, None])[:, 0] - torch.sin(xt)).abs().sum())
    check(err < 0.0008, f"sinus gate: {err}")
    torch.cuda.synchronize()
    print(f"phase 5 sinus gate on CUDA (float64): sum |err| = {err:.3g} < 0.0008 ok")

    counts_fit = _cuda.launch_counts()
    print(f"launches on the fit path (phases 2-5): {counts_fit}")
    fused = ("gram_tile", "panel_update", "diag_factor_inv", "panel_solve")
    check(all(counts_fit[k] > 0 for k in fused), "a kernel of the fit path was never launched")

    # ---------------------------------------------------------------- 6 ----
    # training at the breathing shape, on the phase 4 data
    print("phase 6 training at n=3773 d=5 q=3 (float32), Gaussian(2, 1) start, sigma 0.1")
    _cuda.reset_launch_counts()
    k0 = tg.Gaussian(2.0, 1.0)
    prior = [priors.LogGaussianDensity.from_mode_and_variance(2.0, 1.0), None]
    k_mle, r_mle = tg.fit_mle(k0, X4, Y4, 0.1, iterations=5)
    k_map, r_map = tg.fit_map(k0, X4, Y4, 0.1, prior, iterations=3)
    check(r_mle.route == "blocked-syrk" and r_map.route == "blocked-syrk",
          f"training took routes {r_mle.route}, {r_map.route}")
    sg, sc = (float(v) for v in k_mle.params)
    gp = tg.fit(k_mle, X4, Y4, sigma=0.1, use_pallas_gram=False)
    check(gp.route == "blocked-syrk", f"fit with the learned kernel took route {gp.route}")
    torch.cuda.synchronize()
    counts_train = _cuda.launch_counts()
    print(f"  fit_mle trace {[round(float(v), 3) for v in r_mle.trace]} -> Gaussian({sg:.5g}, "
          f"{sc:.5g}); fit_map trace {[round(float(v), 3) for v in r_map.trace]}")
    breathing["fit with the learned kernel (blocked-syrk)"] = judge(
        "learned Gaussian, n=3773", gp, X4, Y4, Xs4, lambda A, B: gaussian64(A, B, sg, sc),
        sc * sc, sig, with_alpha=True)
    del gp
    print(f"launches on the training path (phase 6): {counts_train}")
    check(counts_train["syrk_update"] > 0, "K5 was never launched on the training path")
    # each step's value and gradient, at the parameters the step started from
    # (a run of i steps ends there; the kernels are deterministic)
    for name, steps, run in (
            ("fit_mle", 5, lambda i: tg.fit_mle(k0, X4, Y4, 0.1, iterations=i)),
            ("fit_map", 3, lambda i: tg.fit_map(k0, X4, Y4, 0.1, prior, iterations=i))):
        for i in range(steps):
            ki, _ = run(i)
            v, g = lk.mll_value_and_grad(ki, X4, Y4, 0.1)
            if name == "fit_mle":
                s_i = float(lk.mll_scalar(ki, X4, Y4, 0.1))
                check(abs(s_i - float(r_mle.trace[i])) <= 1e-5 * abs(s_i), f"trace of step {i}")
            breathing[f"{name} step {i}"] = hold_mll(f"{name} step {i}", [float(p) for p in ki.params],
                                                     X4, Y4, v, g, sig)
    os.makedirs(os.path.dirname(BREATHING_JSON), exist_ok=True)
    with open(BREATHING_JSON, "w") as f:
        json.dump(breathing, f, indent=1)
    print(f"breathing check ({BREATHING_JSON}): " + json.dumps(
        {k: {q: round(r["err"] / r["limit"], 3) for q, r in v.items()}
         for k, v in breathing.items() if k != "shape"}) + " (each the port's error over its limit)")

    # ---------------------------------------------------------------- 7 ----
    print("phase 7 value + gradient at full width: Gaussian(8, 1), d=128, q=8, sigma 0.1")
    _cuda.reset_launch_counts()
    X163, Y163 = Xb[:16383], Yb[:16383]
    check(lk.factor_route(Xb) == "fused-matrix" and lk.factor_route(X163) == "blocked-syrk",
          "full-width routes")
    v16k, g16k = lk.mll_value_and_grad(bench_k, Xb, Yb, 0.1)
    v163, g163 = lk.mll_value_and_grad(bench_k, X163, Y163, 0.1)
    torch.cuda.synchronize()
    counts_full = _cuda.launch_counts()
    print(f"launches on the full-width path (phase 7): {counts_full}")
    check(all(counts_full[k] > 0 for k in fused[1:] + ("syrk_update",)),
          "a factorization kernel of the full-width path was never launched")
    hold_mll("n=16384 fused-matrix", [8.0, 1.0], Xb, Yb, v16k, g16k, sig)
    torch.cuda.empty_cache()
    hold_mll("n=16383 blocked-syrk", [8.0, 1.0], X163, Y163, v163, g163, sig)
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 8 ----
    def fleet_gauss(A, Bm, sg, sc):
        """Gaussian Grams of a fleet in the dtype of A; sg, sc per member."""
        sg = torch.as_tensor(sg, dtype=A.dtype, device=A.device).reshape(-1, 1, 1)
        sc = torch.as_tensor(sc, dtype=A.dtype, device=A.device).reshape(-1, 1, 1)
        d2 = (A * A).sum(-1)[:, :, None] + (Bm * Bm).sum(-1)[:, None, :] - 2.0 * (A @ Bm.mT)
        return sc * sc * torch.exp(-0.5 * d2.clamp(min=0.0) / (sg * sg))

    def plain_fleet(X, Y, Xs, sg, sc, sigma):
        """Mean, variance and alpha of the straightforward fleet in the dtype of
        X: batched torch Gram, torch.linalg.cholesky, cholesky_solve."""
        K = fleet_gauss(X, X, sg, sc)
        noise = torch.as_tensor(sigma, dtype=X.dtype, device=X.device) ** 2
        K.diagonal(dim1=1, dim2=2).add_(noise.reshape(-1, 1))
        L = torch.linalg.cholesky(K)
        alpha = torch.cholesky_solve(Y, L)
        Ks = fleet_gauss(Xs, X, sg, sc)
        kss = torch.as_tensor(sc, dtype=X.dtype, device=X.device).reshape(-1, 1) ** 2
        var = kss - (Ks * torch.cholesky_solve(Ks.mT, L).mT).sum(-1)
        return Ks @ alpha, var, alpha

    def judge_fleet(name, gp, Xs, sg, sc, sigma):
        mean = tg.predict_batched(gp, Xs)
        var = fleet.variance_batched(gp, Xs)
        B_, m_ = Xs.shape[:2]
        check(mean.shape == (B_, m_, gp.Y.shape[2]) and var.shape == (B_, m_), f"{name}: shapes")
        check(bool(torch.isfinite(mean).all() and torch.isfinite(var).all()), f"{name}: non-finite")
        X, Y = gp.X, gp.Y
        m64, v64, a64 = plain_fleet(X.double(), Y.double(), Xs.double(), sg, sc, sigma)
        m32, v32, a32 = plain_fleet(X, Y, Xs, sg, sc, sigma)
        e = [relerr(mean, m64), relerr(var, v64), relerr(gp.alpha, a64)]
        p = [relerr(m32, m64), relerr(v32, v64), relerr(a32, a64)]
        print(f"  {name}: route {gp.route}; rel err vs f64: mean {e[0]:.3g} (plain f32 {p[0]:.3g}), "
              f"variance {e[1]:.3g} (plain f32 {p[1]:.3g}), alpha {e[2]:.3g} (plain f32 {p[2]:.3g})")
        check(all(a <= 3 * b for a, b in zip(e, p)), f"{name}: error above 3x the plain f32 route's")

    print(f"phase 8 fleet fit: Gaussian(2, 1), sigma 0.1, B={Bf} n={nf} d={df_} q={qf}, "
          "64 test points per member")
    _cuda.reset_launch_counts()
    k_f = tg.Gaussian(2.0, 1.0)
    gpf = tg.fit_batched(k_f, Xf, Yf, 0.1)
    torch.cuda.synchronize()
    c1 = _cuda.launch_counts()
    check(gpf.route == "fleet-crout", f"fleet fit took route {gpf.route}")
    check(c1["gram_batched"] == 1 and c1["crout_chol"] == nf // fbatched.PANEL,
          f"fleet fit launches {c1}")
    judge_fleet(f"B={Bf} n={nf}", gpf, Xsf, 2.0, 1.0, sigf)
    del gpf
    r9 = np.random.default_rng(9)
    X2k = t32(r9.standard_normal((256, 1024, df_)))  # BENCHMARKS.md:433's second size
    Y2k = t32(r9.standard_normal((256, 1024, qf)))
    gp2k = tg.fit_batched(k_f, X2k, Y2k, 0.1)
    check(gp2k.route == "fleet-crout", f"B=256 n=1024 took route {gp2k.route}")
    judge_fleet("B=256 n=1024", gp2k, t32(r9.standard_normal((256, 64, df_))), 2.0, 1.0, sigf)
    del gp2k, X2k, Y2k
    torch.cuda.empty_cache()
    sig_b = t32(np.geomspace(0.05, 0.5, Bf))  # per-member noise
    gps = tg.fit_batched(k_f, Xf, Yf, sig_b)
    judge_fleet("per-member sigma 0.05..0.5", gps, Xsf, 2.0, 1.0, sig_b)
    del gps
    # an 8-member lengthscale grid on one series (tests/test_batched.py:166-184 at n=512)
    xg = np.linspace(0, 6, nf)
    yg = np.sin(xg) + 0.1 * np.random.default_rng(1).standard_normal(nf)
    sgrid = np.geomspace(0.2, 5.0, 8)
    Xg8 = t32(np.broadcast_to(xg[None, :, None], (8, nf, 1)))
    Yg8 = t32(np.broadcast_to(yg[None, :, None], (8, nf, 1)))
    kgrid = tg.Gaussian(torch.tensor(sgrid), torch.ones(8, dtype=torch.float64))
    gpg = tg.fit_batched(kgrid, Xg8, Yg8, 0.1, batched_kernel=True)
    check(gpg.route == "fleet-crout", f"grid fit took route {gpg.route}")
    judge_fleet("lengthscale grid fit", gpg, Xg8[:, ::8].contiguous(), t32(sgrid), 1.0, sigf)
    mg = tg.mll_batched(kgrid, Xg8, Yg8, 0.1, batched_kernel=True)
    check(0 < int(torch.argmax(mg)) < 7, f"grid MLL best at an end: {mg.tolist()}")
    del gpg
    # n=500 misses every panel: torch's batched Cholesky, no K7
    c_before = _cuda.launch_counts()["crout_chol"]
    gp500 = tg.fit_batched(k_f, Xf[:, :500].contiguous(), Yf[:, :500].contiguous(), 0.1)
    check(gp500.route == "torch-cholesky" and _cuda.launch_counts()["crout_chol"] == c_before,
          f"n=500 took route {gp500.route}")
    judge_fleet("n=500", gp500, Xsf, 2.0, 1.0, sigf)
    del gp500

    # ---------------------------------------------------------------- 9 ----
    def plain_fleet_mll(X, Y, sigma, P0):
        """(values (B,), gradient (B, 2)) of the straightforward per-member MLL of
        Gaussian(P0[b, 0], P0[b, 1]) in the dtype of X (batch Gram, cholesky,
        cholesky_solve, autograd), as gp/batched.py's mll_batched counts it."""
        n = X.shape[1]
        p = P0.detach().clone().requires_grad_()
        with torch.enable_grad():
            K = fleet_gauss(X, X, p[:, 0].to(X.dtype), p[:, 1].to(X.dtype))
            K = K + (sigma * sigma) * torch.eye(n, dtype=X.dtype, device=X.device)
            L = torch.linalg.cholesky(K)
            alpha = torch.cholesky_solve(Y, L)
            v = (-0.5 * (Y * alpha).sum((1, 2)) - torch.log(torch.diagonal(L, dim1=1, dim2=2)).sum(1)
                 - n / 2.0 * math.log(2 * math.pi))
            (g,) = torch.autograd.grad(v.sum(), p)
        return v.detach(), g

    def port_fleet_mll(X, Y, sigma, P0):
        p = P0.detach().clone().requires_grad_()
        with torch.enable_grad():
            v = tg.mll_batched(tg.Gaussian(p[:, 0], p[:, 1]), X, Y, sigma, batched_kernel=True)
            (g,) = torch.autograd.grad(v.sum(), p)
        return v.detach(), g

    print(f"phase 9 fleet training at B={Bf} n={nf}: per-member hyperparameters")
    P0 = torch.tensor(np.stack([np.linspace(1.5, 3.0, Bf), np.linspace(0.8, 1.2, Bf)], 1),
                      device=dev)
    v_f, g_f = port_fleet_mll(Xf, Yf, 0.1, P0)
    c2 = _cuda.launch_counts()
    v64, g64 = plain_fleet_mll(Xf.double(), Yf.double(), sigf, P0)
    v32, g32 = plain_fleet_mll(Xf, Yf, sigf, P0)
    e_v, e_g, p_v, p_g = relerr(v_f, v64), relerr(g_f, g64), relerr(v32, v64), relerr(g32, g64)
    print(f"  mll_batched value + gradient: rel err vs f64: value {e_v:.3g} (plain f32 {p_v:.3g}), "
          f"gradient {e_g:.3g} (plain f32 {p_g:.3g})")
    check(e_v <= 3 * p_v and e_g <= 3 * p_g, "fleet MLL: error above 3x the plain f32 route's")
    init = torch.stack([P0[:, 0], P0[:, 1]], 1).cpu()
    _, r_mle_f = fleet.fit_mle_batched(k_f, Xf, Yf, 0.1, iterations=5, init=init)
    torch.cuda.synchronize()
    counts_fleet = _cuda.launch_counts()
    check(r_mle_f.route == "fleet-crout" and r_mle_f.params.shape == (Bf, 2), "fit_mle_batched")
    check(bool(torch.isfinite(r_mle_f.trace).all()) and r_mle_f.value > float(r_mle_f.trace[0]),
          f"fit_mle_batched did not climb: {r_mle_f.trace.tolist()} -> {r_mle_f.value}")
    print(f"  fit_mle_batched 5 steps: summed MLL {[round(float(v), 1) for v in r_mle_f.trace]} -> "
          f"{r_mle_f.value:.1f}")
    # one factorization per step and one for the final value; none in a backward
    check(counts_fleet["crout_chol"] - c2["crout_chol"] == 6 * (nf // fbatched.PANEL),
          f"K7 launches per factorization in fit_mle_batched: {counts_fleet}")
    print(f"launches on the fleet paths (phases 8-9): {counts_fleet}")
    check(counts_fleet["gram_batched"] > 0 and counts_fleet["crout_chol"] > 0,
          "a fleet kernel was never launched on the fleet path")
    counts = {k.name: counts_fit[k.name] + counts_train[k.name] + counts_full[k.name]
              + counts_fleet[k.name] for k in _cuda.KERNELS}

    # --------------------------------------------------------------- 10 ----
    def ev():
        return torch.cuda.Event(enable_timing=True)

    def timed(fn, queued=False):
        """CUDA events around fn; with ``queued`` the device first sleeps
        while the host enqueues the events and fn's launches, so that a
        short kernel is timed and not the host's time to launch it."""
        a, b = ev(), ev()
        if queued:
            torch.cuda._sleep(300_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b)

    def alternate(port, plain, pairs):
        """Medians (port, plain) and the runs, in turns plain/port, port/plain."""
        port(), plain()  # warm-up
        t_port, t_plain = [], []
        for i in range(pairs):
            for fn in ((plain, port) if i % 2 == 0 else (port, plain)):
                (t_port if fn is port else t_plain).append(timed(fn))
        return float(np.median(t_port)), float(np.median(t_plain)), t_port, t_plain

    def port_fit():
        tg.fit(bench_k, Xb, Yb, sigma=0.1, use_pallas_gram=True)

    def plain_fit():
        K = gaussian64(Xb, Xb, 8.0, 1.0)
        K.diagonal().add_(sig * sig)
        torch.cholesky_solve(Yb, torch.linalg.cholesky(K))

    med_port, med_plain, t_port, t_plain = alternate(port_fit, plain_fit, 6)

    def per_kernel(steps):
        update, factor_inv, solve = steps
        tot = [0.0, 0.0, 0.0]
        L = torch.empty((n, n), dtype=torch.float32, device=dev)
        W = torch.empty((nc, 128, 128), dtype=torch.float32, device=dev)
        for j in range(nc):
            tot[0] += timed(lambda: update(L, j, Xb, *gram_args), True)
            tot[1] += timed(lambda: factor_inv(L, W, j), True)
            if j + 1 < nc:
                tot[2] += timed(lambda: solve(L, W, j), True)
        check(bool(torch.isfinite(L[-1, -1])), "timed factorization failed")
        return tot, L

    ker, L16 = per_kernel((fullchol.panel_update, fullchol.diag_factor_inv, fullchol.panel_solve))
    ref, _ = per_kernel((fullchol.panel_update_reference, fullchol.diag_factor_inv_reference,
                         fullchol.panel_solve_reference))
    for name, k_ms, p_ms in zip(("panel_update", "diag_factor_inv", "panel_solve"), ker, ref):
        kstats[name].update(ms=k_ms, plain_ms=p_ms)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = [fullchol._split_plan(n, j, sms) for j in range(nc)]
    runs_b, j_ = [], 0
    while j_ < nc:  # K2's product blocks per panel, in runs of equal counts
        e_ = j_
        while e_ + 1 < nc and blocks[e_ + 1] == blocks[j_]:
            e_ += 1
        runs_b.append(f"j={j_}{'' if e_ == j_ else f'-{e_}'}: {blocks[j_]}")
        j_ = e_ + 1

    # each kernel's library call, per panel on the same factor: K2 one
    # torch.addmm(S, L21, L_j^T, alpha=-1) in matrix mode, K3 cholesky_ex +
    # solve_triangular(L_jj, I) on the diagonal tile, K4 one matmul(P, W_j^T)
    Kb16 = gaussian64(Xb, Xb, 8.0, 1.0)
    Kb16.diagonal().add_(sig * sig)
    W16 = torch.empty((nc, 128, 128), dtype=torch.float32, device=dev)
    eye128 = torch.eye(128, dtype=torch.float32, device=dev)
    lib = [0.0, 0.0, 0.0]
    for j in range(nc):
        jp, je = j * 128, (j + 1) * 128
        S = Kb16[jp:, jp:je]
        if j:
            lib[0] += timed(lambda: torch.addmm(S, L16[jp:, :jp], L16[jp:je, :jp].T, alpha=-1), True)
        Ljj = L16[jp:je, jp:je]
        Pjj = Ljj @ Ljj.T
        lib[1] += timed(lambda: torch.linalg.solve_triangular(
            torch.linalg.cholesky_ex(Pjj)[0], eye128, upper=False), True)
        W16[j] = torch.linalg.solve_triangular(Ljj, eye128, upper=False)
        if j + 1 < nc:
            P_ = L16[je:, jp:je] @ Ljj.T  # the panel before K4: P = L21 L_jj^T
            lib[2] += timed(lambda: torch.matmul(P_, W16[j].T), True)
    del Kb16, L16, W16
    torch.cuda.empty_cache()

    def median_ms(fn, reps=20):
        fn()
        return float(np.median([timed(fn) for _ in range(reps)]))

    def queued_ms(fn, reps=20):
        fn()
        return float(np.median([timed(fn, True) for _ in range(reps)]))

    GRAM_LIBRARY_CALLS = 5

    def gram_library(X, sigma, diag):
        """A Gaussian Gram (scale 1) in torch: cdist, square_, mul_, exp_ and
        the diagonal's add_, 5 calls (K1's composition; batched, K6's)."""
        K = torch.cdist(X, X).square_().mul_(-0.5 / (sigma * sigma)).exp_()
        K.diagonal(dim1=-2, dim2=-1).add_(diag)
        return K

    # the factorization whole: the lookahead overlaps K3 and K4 with the next
    # panel's products, which per-launch events cannot see
    fact16 = [timed(lambda: fullchol.gram_cholesky_fused(Xb, *gram_args[1:], form="gaussian"))
              for _ in range(6)][1:]

    # where one bench fit's device time goes: a torch.profiler trace; kernels
    # on two streams overlap, so busy time is the union of their intervals
    from torch.profiler import ProfilerActivity, profile

    def busy_ms(spans):
        tot, end = 0.0, -math.inf
        for a, b in sorted(spans):
            if b > end:
                tot += b - max(a, end)
                end = b
        return tot / 1e3

    fact_names = ("panel_products", "panel_last", "panel_strip", "panel_solve", "diag_factor_inv")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tg.fit(bench_k, Xb, Yb, sigma=0.1, use_pallas_gram=True)
        torch.cuda.synchronize()
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.end > e.time_range.start]
    check(len(spans) > 0, "the profiler saw no device time in the bench fit")
    by_k16 = {}
    for name, a, b in spans:
        key = name.split("(")[0].split("<")[0].replace("void ", "").replace("gpr::", "")[:48]
        t_, c_ = by_k16.get(key, (0.0, 0))
        by_k16[key] = (t_ + (b - a) / 1e3, c_ + 1)
    in_fact = [sp for sp in spans if any(f in sp[0] for f in fact_names)]
    f_end = max(b for _, _, b in in_fact)
    after = [(a, b) for name, a, b in spans if a >= f_end]
    t0_, t1_ = min(a for _, a, _ in spans), max(b for _, _, b in spans)
    trace16 = {
        "span_ms": (t1_ - t0_) / 1e3,
        "busy_ms": busy_ms([(a, b) for _, a, b in spans]),
        "factorization_span_ms": (f_end - min(a for _, a, _ in in_fact)) / 1e3,
        "factorization_busy_ms": busy_ms([(a, b) for _, a, b in in_fact]),
        "after_span_ms": (t1_ - f_end) / 1e3,  # cho_solve_panels and what follows it
        "after_busy_ms": busy_ms(after),
    }
    trace16["idle_share"] = 1.0 - trace16["busy_ms"] / trace16["span_ms"]
    # the lookahead's aim: each K3 launch under the next panel's products
    prods = [(a, b) for name, a, b in spans if "panel_products" in name]
    k3 = sorted((a, b) for name, a, b in spans if "diag_factor_inv" in name)
    k3_hidden = [sum(max(0.0, min(b, d_) - max(a, c_)) for c_, d_ in prods) / (b - a) for a, b in k3]
    k3_exposed = sum((b - a) * (1.0 - h) for (a, b), h in zip(k3, k3_hidden)) / 1e3

    # K1 queued behind a device sleep and with the host's enqueue, at n=384
    # (the gram-kernel route's full square) and n=16384 (the lower triangle the
    # recursive and inplace routes build); no single torch call builds a
    # kernel's Gram matrix, so library_ms is the shortest torch composition
    kstats["gram_tile"].update(
        ms=queued_ms(lambda: gop.gram(Xg, Xg, 8.0, 1.0, 1.0, gram_args[4])),
        ms_enqueue=median_ms(lambda: gop.gram(Xg, Xg, 8.0, 1.0, 1.0, gram_args[4])),
        plain_ms=median_ms(lambda: gop.gram_reference(Xg, Xg, 8.0, 1.0, 1.0, gram_args[4])),
        library_ms=queued_ms(lambda: gram_library(Xg, 8.0, gram_args[4])),
        library_calls=GRAM_LIBRARY_CALLS,
    )
    big_ms = queued_ms(lambda: gop.gram(Xb, Xb, 8.0, 1.0, 1.0, gram_args[4], tril=True), 6)
    big_enqueue = median_ms(lambda: gop.gram(Xb, Xb, 8.0, 1.0, 1.0, gram_args[4], tril=True), 5)
    big_plain = median_ms(lambda: gop.gram_reference(Xb, Xb, 8.0, 1.0, 1.0, gram_args[4]), 5)
    big_library = queued_ms(lambda: gram_library(Xb, 8.0, gram_args[4]), 5)
    # the timed output held against the plain version's lower triangle: each
    # block walks ~63 tiles here, the mechanism the small checks cannot reach
    Kb = torch.tril(gop.gram(Xb, Xb, 8.0, 1.0, 1.0, gram_args[4], tril=True))
    Kb -= torch.tril(gop.gram_reference(Xb, Xb, 8.0, 1.0, 1.0, gram_args[4]))
    big_err = float(Kb.abs_().max())
    del Kb
    check(big_err <= 3e-5, f"K1 at n={Xb.shape[0]} d={Xb.shape[1]} tril: {big_err}")  # of scale^2 = 1
    kstats["gram_tile"]["max_abs_err"] = max(kstats["gram_tile"]["max_abs_err"], big_err)
    Kb = gaussian64(Xb, Xb, 8.0, 1.0)
    Kb.diagonal().add_(sig * sig)
    chol_ms = median_ms(lambda: torch.linalg.cholesky(Kb), 5)  # K2-K4 together
    del Kb
    for name, ms_ in zip(("panel_update", "diag_factor_inv", "panel_solve"), lib):
        kstats[name]["library_ms"] = ms_

    # value + gradient against the plain float32 route
    vg_times = {}
    for label, kern, X_, Y_, params, pairs in (
            ("n=3773 d=5 q=3 (blocked-syrk)", k_mle, X4, Y4, [sg, sc], 5),
            ("n=16384 d=128 q=8 (fused-matrix)", bench_k, Xb, Yb, [8.0, 1.0], 3),
            ("n=16383 d=128 q=8 (blocked-syrk)", bench_k, X163, Y163, [8.0, 1.0], 3)):
        vg_times[label] = alternate(lambda: lk.mll_value_and_grad(kern, X_, Y_, 0.1),
                                    lambda: plain_mll(X_, Y_, sig, params), pairs)
        torch.cuda.empty_cache()

    # K5 per factorization at n=16383: each trailing update of the recursion
    # timed alone, with the kernel, its plain version and torch.addmm in turn
    K163 = gaussian64(X163, X163, 8.0, 1.0)
    K163.diagonal().add_(sig * sig)
    shapes = []

    def updates_ms(update):
        tot = [0.0]
        orig = blocked.syrk_update

        def timed_update(A22, L21, out):
            shapes.append(tuple(L21.shape))
            box = []
            tot[0] += timed(lambda: box.append(update(A22, L21)))
            if box[0] is not out:
                out.copy_(box[0])
            return out

        blocked.syrk_update = timed_update
        try:
            L = blocked.cholesky_blocked(K163)
        finally:
            blocked.syrk_update = orig
        check(bool(torch.isfinite(L[-1, -1])), "timed blocked factorization failed")
        return tot[0]

    upd = {"kernel": lambda A22, L21: syrk.syrk_update(A22, L21, out=A22),
           "plain": syrk.syrk_update_reference,
           "library": lambda A22, L21: torch.addmm(A22, L21, L21.mT, alpha=-1)}
    runs = {k: [] for k in upd}
    for order in (("kernel", "plain", "library"), ("library", "plain", "kernel")):
        for k in order:
            runs[k].append(updates_ms(upd[k]))
    k5_shapes = shapes[:len(shapes) // 6]
    kstats["syrk_update"].update(ms=float(np.median(runs["kernel"])),
                                 plain_ms=float(np.median(runs["plain"])),
                                 library_ms=float(np.median(runs["library"])))
    fact_ms, tchol_ms, t_fact, t_tchol = alternate(lambda: blocked.cholesky_blocked(K163),
                                                   lambda: torch.linalg.cholesky(K163), 3)
    del K163
    torch.cuda.empty_cache()

    # bounds: the larger of operations over the peak of the tier the kernel
    # computes on (the 67 TFLOP/s FP32 peak unless named) and bytes (each
    # input read once, each output written once) over 3.35 TB/s
    fp32 = (67e12, "FP32 67 TFLOP/s")

    def bound(flop, nbytes, tier=fp32):
        t_op, t_mem = flop / tier[0] * 1e3, nbytes / 3.35e12 * 1e3
        return {"bound_ms": max(t_op, t_mem), "bound_by": "operations" if t_op >= t_mem else "bytes",
                "bound_tier": tier[1]}

    def sum_bounds(parts, tier=fp32):
        t_op = sum(f for f, _ in parts) / tier[0] * 1e3
        t_mem = sum(b for _, b in parts) / 3.35e12 * 1e3
        by = "operations" if t_op >= t_mem else "bytes"
        return {"bound_ms": sum(max(f / tier[0], b / 3.35e12) * 1e3 for f, b in parts),
                "bound_by": by, "bound_tier": tier[1]}

    # K1 computes the cross term on the tensor cores' 3xTF32 tier (the bench
    # form, d = 128); its FP32 bound stands beside it.  At n=16384 it writes
    # the lower triangle: n (n + 1) / 2 entries of 2 d FLOP each
    tf32x3 = (495e12 / 3, "3xTF32 495/3 = 165 TFLOP/s")
    ng, dg, P = Xg.shape[0], Xg.shape[1], fullchol.PANEL
    k1_small = (2.0 * ng * ng * dg, 4.0 * (2 * ng * dg + ng * ng))
    nb_ = Xb.shape[0]
    k1_big = (2.0 * dg * nb_ * (nb_ + 1) / 2, 4.0 * (nb_ * (nb_ + 1) / 2 + nb_ * dg))
    kstats["gram_tile"].update(bound(*k1_small, tf32x3), bound_fp32_ms=bound(*k1_small)["bound_ms"],
                               full_width_ms=big_ms, full_width_ms_enqueue=big_enqueue,
                               full_width_plain_ms=big_plain, full_width_library_ms=big_library,
                               full_width_bound_ms=bound(*k1_big, tf32x3)["bound_ms"],
                               full_width_bound_fp32_ms=bound(*k1_big)["bound_ms"])
    d = Xb.shape[1]
    # K2 panel j: the strip's Gram cross term and update, 2 rows P (jp + d)
    # FLOP; it reads X's rows and L[rows, :jp] and writes the strip and the
    # zeros above it
    k2_parts = [(2.0 * (n - j * P) * P * (j * P + d),
                 4.0 * ((n - j * P) * (d + j * P + P) + j * P * P)) for j in range(nc)]
    # K2 computes on the tensor cores' 3xTF32 tier: three TF32 products at
    # 495 TFLOP/s for each FP32 one; its FP32 bound stands beside it
    kstats["panel_update"].update(sum_bounds(k2_parts, (495e12 / 3, "3xTF32 495/3 = 165 TFLOP/s")),
                                  bound_fp32_ms=sum_bounds(k2_parts)["bound_ms"])
    kstats["diag_factor_inv"].update(sum_bounds([(2.0 * P ** 3 / 3.0, 4.0 * 3 * P * P)] * nc))
    # K4 computes in FP32; W_j is lower triangular, so the product needs
    # rows * 128 * 129 FLOP a panel; it reads P and W_j's lower triangle and
    # writes P's place
    kstats["panel_solve"].update(sum_bounds([
        (1.0 * (n - (j + 1) * P) * P * (P + 1), 4.0 * (2 * (n - (j + 1) * P) * P + P * (P + 1) / 2))
        for j in range(nc - 1)]))
    # K5 computes on the 3xTF32 tier, as K2
    k5_parts = [(1.0 * m * (m + 1) * k, 4.0 * (m * (m + 1) + m * k)) for m, k in k5_shapes]
    kstats["syrk_update"].update(sum_bounds(k5_parts, tf32x3),
                                 bound_fp32_ms=sum_bounds(k5_parts)["bound_ms"])

    print(f"phase 10 timings ({smi}), CUDA events, medians:")
    print(f"  fit n=16384 d=128 q=8: hand-written route {med_port:.2f} ms "
          f"(runs {', '.join(f'{t:.1f}' for t in t_port)}); plain torch route {med_plain:.2f} ms "
          f"(runs {', '.join(f'{t:.1f}' for t in t_plain)})")
    print(f"  per fit at n=16384: K2 panel_update {ker[0]:.2f} ms (plain {ref[0]:.2f}, addmm "
          f"{lib[0]:.2f}; bound {kstats['panel_update']['bound_ms']:.2f} 3xTF32, "
          f"{kstats['panel_update']['bound_fp32_ms']:.2f} FP32), "
          f"K3 diag_factor_inv {ker[1]:.2f} ms (plain {ref[1]:.2f}, cholesky_ex + solve_triangular "
          f"{lib[1]:.2f}), K4 panel_solve {ker[2]:.2f} ms (plain {ref[2]:.2f}, matmul {lib[2]:.2f}; "
          f"bound {kstats['panel_solve']['bound_ms']:.3f} FP32); "
          f"sums of per-launch events, each launch queued behind a device sleep; "
          f"torch.linalg.cholesky of K {chol_ms:.2f} ms")
    print(f"  K2 product blocks per panel: {', '.join(runs_b)}")
    print(f"  the fused-gram factorization whole (lookahead, two streams): median "
          f"{float(np.median(fact16)):.2f} ms (runs {', '.join(f'{t:.2f}' for t in fact16)})")
    print(f"  profiled bench fit: device span {trace16['span_ms']:.2f} ms, busy {trace16['busy_ms']:.2f} "
          f"(idle share {100 * trace16['idle_share']:.1f} %); factorization span "
          f"{trace16['factorization_span_ms']:.2f} busy {trace16['factorization_busy_ms']:.2f}; after it "
          f"(cho_solve_panels) span {trace16['after_span_ms']:.2f} busy {trace16['after_busy_ms']:.2f}")
    hid = [j for j, h in enumerate(k3_hidden) if h >= 0.9]
    print(f"  K3 under the next panel's products (profiled fit): {len(hid)} of {len(k3_hidden)} launches "
          f"at least 90 % hidden (panels {hid[0] if hid else '-'}-{hid[-1] if hid else '-'}); "
          f"K3 time not hidden {k3_exposed:.2f} ms")
    print("  profiled bench fit, device ms (launches): " + "; ".join(
        f"{k} {v[0]:.2f} ({v[1]})" for k, v in sorted(by_k16.items(), key=lambda kv: -kv[1][0])[:10]))
    k1 = kstats["gram_tile"]
    print(f"  K1 gram_tile n=384 d=128 (queued): {k1['ms']:.4f} ms, with the host's enqueue "
          f"{k1['ms_enqueue']:.4f} (plain {k1['plain_ms']:.4f}, torch composition of {GRAM_LIBRARY_CALLS} calls "
          f"{k1['library_ms']:.4f}; bound {k1['bound_ms']:.5f} 3xTF32, {k1['bound_fp32_ms']:.5f} FP32); "
          f"n=16384 d=128 tril (queued): {big_ms:.4f} ms, with the host's enqueue {big_enqueue:.4f} (plain full "
          f"{big_plain:.2f}, torch composition full {big_library:.4f}; bound {k1['full_width_bound_ms']:.4f} "
          f"3xTF32, {k1['full_width_bound_fp32_ms']:.4f} FP32; lower triangle against the plain version: max "
          f"abs err {big_err:.3g})")
    for label, (tp, tq, rp, rq) in vg_times.items():
        print(f"  MLL value + gradient {label}: port {tp:.2f} ms (runs "
              f"{', '.join(f'{t:.1f}' for t in rp)}); plain f32 {tq:.2f} ms (runs "
              f"{', '.join(f'{t:.1f}' for t in rq)})")
    print(f"  K5 per n=16383 factorization ({len(k5_shapes)} launches, (m, k) = {k5_shapes}): "
          f"kernel {runs['kernel']} ms, plain {runs['plain']} ms, torch.addmm {runs['library']} ms; "
          f"bound {kstats['syrk_update']['bound_ms']:.2f} 3xTF32, "
          f"{kstats['syrk_update']['bound_fp32_ms']:.2f} FP32")
    print(f"  blocked-syrk factorization n=16383: {fact_ms:.2f} ms (runs "
          f"{', '.join(f'{t:.1f}' for t in t_fact)}); torch.linalg.cholesky {tchol_ms:.2f} ms "
          f"(runs {', '.join(f'{t:.1f}' for t in t_tchol)})")

    # --------------------------------------------------------------- 11 ----
    def plain_fleet_fit(X, Y):
        K = fleet_gauss(X, X, 2.0, 1.0)
        K.diagonal(dim1=1, dim2=2).add_(sigf * sigf)
        torch.cholesky_solve(Y, torch.linalg.cholesky(K))

    def fit_at(X, Y, P_, panel):  # fit_batched's steps with the panel given
        with torch.no_grad():
            fbatched.factor_solve_batched_diff(gop.gram_batched(X, P_), Y, panel)

    fleet_times, panel_runs = {}, {}
    r11 = np.random.default_rng(11)
    for B_, n_ in ((Bf, nf), (256, 1024)):
        X_ = Xf if n_ == nf else t32(r11.standard_normal((B_, n_, df_)))
        Y_ = Yf if n_ == nf else t32(r11.standard_normal((B_, n_, qf)))
        fleet_times[(B_, n_)] = alternate(lambda: tg.fit_batched(k_f, X_, Y_, 0.1),
                                          lambda: plain_fleet_fit(X_, Y_), 10)
        P_ = Pf if B_ == Bf else t32(np.tile([2.0, 1.0, 1.0, sigf * sigf], (B_, 1)))
        panels = (32, 64, 128) if n_ == nf else (64, 128)
        runs_ = panel_runs[(B_, n_)] = {p_: [] for p_ in panels}
        for p_ in panels:
            fit_at(X_, Y_, P_, p_)  # warm-up
        for order in (panels, panels[::-1]) * 4:
            for p_ in order:
                runs_[p_].append(timed(lambda: fit_at(X_, Y_, P_, p_)))
        del X_, Y_, P_
    torch.cuda.empty_cache()

    # where the fleet fit's time goes: a torch.profiler trace of 5 fits
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t_w = time.perf_counter()
        for _ in range(5):
            tg.fit_batched(k_f, Xf, Yf, 0.1)
        torch.cuda.synchronize()
        wall_fit = (time.perf_counter() - t_w) * 1e3 / 5
    by_kernel = []
    for e in prof.key_averages():
        if "CUDA" in str(e.device_type):
            us = getattr(e, "self_device_time_total", None)
            us = e.self_cuda_time_total if us is None else us
            by_kernel.append((us / 1e3 / 5, e.count / 5, e.key))
    busy_fit = sum(t for t, _, _ in by_kernel)

    # K6 per fit queued and with the host's enqueue, and at B=256, n=1024
    kstats["gram_batched"].update(
        ms=queued_ms(lambda: gop.gram_batched(Xf, Pf)),
        ms_enqueue=median_ms(lambda: gop.gram_batched(Xf, Pf)),
        plain_ms=median_ms(lambda: gop.gram_batched_reference(Xf, Pf)),
        library_ms=queued_ms(lambda: gram_library(Xf, 2.0, sigf * sigf)),
        library_calls=GRAM_LIBRARY_CALLS,
    )
    X6 = t32(np.random.default_rng(11).standard_normal((256, 1024, df_)))
    P6 = t32(np.tile([2.0, 1.0, 1.0, sigf * sigf], (256, 1)))
    kstats["gram_batched"].update(
        large_ms=queued_ms(lambda: gop.gram_batched(X6, P6), 10),
        large_library_ms=queued_ms(lambda: gram_library(X6, 2.0, sigf * sigf), 10),
        large_bound_ms=bound(2.0 * 256 * 1024 * 1024 * df_,
                             4.0 * (256 * 1024 * df_ + 4 * 256 + 256 * 1024 * 1024))["bound_ms"])
    del X6, P6
    torch.cuda.empty_cache()
    # K7 per fleet fit: each panel step's launch timed alone, queued behind a
    # device sleep (the kernel is shorter than the host's enqueue), with the
    # kernel, its plain version and torch.linalg.cholesky_ex on the same tiles
    # in turn
    Kfit = gop.gram_batched(Xf, Pf)

    def crout_total(diag):
        tot = [0.0]
        orig = fbatched.crout_chol

        def timed_diag(D, out):
            box = []
            tot[0] += timed(lambda: box.append(diag(D)), queued=True)
            return box[0] if box[0] is out else out.copy_(box[0])

        fbatched.crout_chol = timed_diag
        try:
            L = fbatched.cholesky_batched(Kfit)
        finally:
            fbatched.crout_chol = orig
        check(bool(torch.isfinite(L[:, -1, -1]).all()), "timed fleet factorization failed")
        return tot[0]

    diags = {"kernel": lambda D: fcrout.crout_chol(D, out=D),
             "plain": fcrout.crout_chol_reference,
             "library": lambda D: torch.linalg.cholesky_ex(D)[0]}
    k7runs = {k: [] for k in diags}
    crout_total(diags["kernel"])  # warm-up
    for order in (("kernel", "plain", "library"), ("library", "plain", "kernel")) * 3:
        for k in order:
            k7runs[k].append(crout_total(diags[k]))
    kstats["crout_chol"].update(ms=float(np.median(k7runs["kernel"])),
                                plain_ms=float(np.median(k7runs["plain"])),
                                library_ms=float(np.median(k7runs["library"])))
    del Kfit
    fleet_vg = alternate(lambda: port_fleet_mll(Xf, Yf, 0.1, P0),
                         lambda: plain_fleet_mll(Xf, Yf, sigf, P0), 5)

    nbf, pf = nf // fbatched.PANEL, fbatched.PANEL
    kstats["gram_batched"].update(bound(2.0 * Bf * nf * nf * df_,
                                        4.0 * (Bf * nf * df_ + 4 * Bf + Bf * nf * nf)))
    # K7 reads each tile's lower triangle and writes the whole tile
    kstats["crout_chol"].update(sum_bounds(
        [(Bf * pf ** 3 / 3.0, 4.0 * Bf * (pf * (pf + 1) / 2 + pf * pf))] * nbf))
    print(f"phase 11 fleet timings ({smi}), CUDA events, medians:")
    for (B_, n_), (tp, tq, rp, rq) in fleet_times.items():
        print(f"  fleet fit B={B_} n={n_} d={df_} q={qf}: port {tp:.3f} ms = {B_ / tp * 1e3:.0f} "
              f"fits/s (runs {', '.join(f'{t:.2f}' for t in rp)}); plain f32 route {tq:.3f} ms = "
              f"{B_ / tq * 1e3:.0f} fits/s (runs {', '.join(f'{t:.2f}' for t in rq)})")
    k6 = kstats["gram_batched"]
    print(f"  K6 gram_batched per fit (B={Bf} n={nf} d={df_}, 1 launch, queued): {k6['ms']:.4f} ms, with the "
          f"host's enqueue {k6['ms_enqueue']:.4f} (plain {k6['plain_ms']:.4f}, torch composition of "
          f"{GRAM_LIBRARY_CALLS} calls {k6['library_ms']:.4f}; bound {k6['bound_ms']:.4f}); B=256 n=1024 "
          f"(queued): {k6['large_ms']:.4f} ms (torch composition {k6['large_library_ms']:.4f}; bound "
          f"{k6['large_bound_ms']:.4f})")
    print(f"  K7 crout_chol per fit ({nbf} launches of {Bf} x {pf}^2 tiles): kernel "
          f"{[round(t, 4) for t in k7runs['kernel']]} ms, plain "
          f"{[round(t, 4) for t in k7runs['plain']]} ms, torch.linalg.cholesky_ex "
          f"{[round(t, 4) for t in k7runs['library']]} ms")
    tp, tq, rp, rq = fleet_vg
    print(f"  mll_batched value + gradient B={Bf} n={nf}: port {tp:.3f} ms (runs "
          f"{', '.join(f'{t:.2f}' for t in rp)}); plain f32 {tq:.3f} ms (runs "
          f"{', '.join(f'{t:.2f}' for t in rq)})")
    for (B_, n_), runs_ in panel_runs.items():
        print("  panel sweep, fleet fit B=%d n=%d (K6 + factor + solve): %s" % (B_, n_, "; ".join(
            f"p={p_} {float(np.median(r)):.3f} ms (runs {', '.join(f'{t:.2f}' for t in r)})"
            for p_, r in runs_.items())))
    print(f"  torch.profiler, 5 fleet fits B={Bf} n={nf}: {wall_fit:.3f} ms per fit on the host "
          f"clock, device kernels {busy_fit:.3f} ms per fit, idle "
          f"{100.0 * (1.0 - busy_fit / wall_fit):.1f} % (profiler on)")
    for t, c, name in sorted(by_kernel, reverse=True)[:12]:
        print(f"    {t:.4f} ms per fit, {c:g} launches: {name[:100]}")

    # --------------------------------------------------------------- 12 ----
    # the fused fleet: each path driven with the counts set to 0 just before
    # it and read just after
    print("phase 12 the fused fleet (route fleet-fused; GPR_FLEET_FUSED_MAX_N = 1024 for the phase)")
    saved_max_n = fbatched._FLEET_FUSED_MAX_N
    path_counts = []
    fbatched._FLEET_FUSED_MAX_N = 1024
    try:
        _cuda.reset_launch_counts()
        gpf = tg.fit_batched(k_f, Xf, Yf, 0.1)
        check(gpf.route == "fleet-fused", f"fused fleet fit took route {gpf.route}")
        judge_fleet(f"fused B={Bf} n={nf}", gpf, Xsf, 2.0, 1.0, sigf)
        del gpf
        r12 = np.random.default_rng(9)  # phase 8's data at B=256, n=1024
        X2k = t32(r12.standard_normal((256, 1024, df_)))
        Y2k = t32(r12.standard_normal((256, 1024, qf)))
        gp2k = tg.fit_batched(k_f, X2k, Y2k, 0.1)
        check(gp2k.route == "fleet-fused", f"fused B=256 n=1024 took route {gp2k.route}")
        judge_fleet("fused B=256 n=1024", gp2k, t32(r12.standard_normal((256, 64, df_))), 2.0, 1.0,
                    sigf)
        del gp2k
        torch.cuda.synchronize()
        c = _cuda.launch_counts()
        path_counts.append(c)
        print(f"  launches on the fused fit path: {c}")
        check(c["gram_batched"] == 2 and c["fleet_fused"] == 2 and c["crout_chol"] == 0
              and c["crout_chol_wi"] == 0, "fused fit launches")

        _cuda.reset_launch_counts()
        v_ff, g_ff = port_fleet_mll(Xf, Yf, 0.1, P0)
        torch.cuda.synchronize()
        c = _cuda.launch_counts()
        path_counts.append(c)
        e_v, e_g = relerr(v_ff, v64), relerr(g_ff, g64)
        print(f"  fused mll_batched value + gradient: rel err vs f64: value {e_v:.3g} (plain f32 "
              f"{p_v:.3g}), gradient {e_g:.3g} (plain f32 {p_g:.3g}); launches {c}")
        check(e_v <= 3 * p_v and e_g <= 3 * p_g, "fused fleet MLL: error above 3x the plain f32 route's")
        check(c["fleet_fused"] == 1 and c["crout_chol_wi"] == 1 and c["crout_chol"] == 0,
              "fused value + gradient launches: one K9 forward, one K8 in the backward, no K7")

        _cuda.reset_launch_counts()
        _, r_ff = fleet.fit_mle_batched(k_f, Xf, Yf, 0.1, iterations=5, init=init)
        torch.cuda.synchronize()
        c = _cuda.launch_counts()
        path_counts.append(c)
        check(r_ff.route == "fleet-fused" and r_ff.params.shape == (Bf, 2), "fused fit_mle_batched")
        check(bool(torch.isfinite(r_ff.trace).all()) and r_ff.value > float(r_ff.trace[0]),
              f"fused fit_mle_batched did not climb: {r_ff.trace.tolist()} -> {r_ff.value}")
        print(f"  fused fit_mle_batched 5 steps: summed MLL {[round(float(v), 1) for v in r_ff.trace]}"
              f" -> {r_ff.value:.1f}; launches {c}")
        # a K9 launch per step and one for the final value, a K8 launch per backward
        check(c["fleet_fused"] == 6 and c["crout_chol_wi"] == 5 and c["crout_chol"] == 0,
              "fused fit_mle_batched launches")
    finally:
        fbatched._FLEET_FUSED_MAX_N = saved_max_n

    saved_diag = os.environ.get("GPR_FLEET_DIAG")
    os.environ["GPR_FLEET_DIAG"] = "crout"
    try:
        _cuda.reset_launch_counts()
        gpc = tg.fit_batched(k_f, Xf, Yf, 0.1)
        torch.cuda.synchronize()
        c = _cuda.launch_counts()
        path_counts.append(c)
        check(gpc.route == "fleet-crout", f"GPR_FLEET_DIAG=crout fit took route {gpc.route}")
        judge_fleet(f"GPR_FLEET_DIAG=crout B={Bf} n={nf}", gpc, Xsf, 2.0, 1.0, sigf)
        del gpc
        print(f"  launches on the crout-scheme path: {c}")
        check(c["crout_chol_wi"] == nf // fbatched.PANEL and c["crout_chol"] == 0,
              "GPR_FLEET_DIAG=crout: one K8 launch per panel step, no K7")
    finally:
        if saved_diag is None:
            del os.environ["GPR_FLEET_DIAG"]
        else:
            os.environ["GPR_FLEET_DIAG"] = saved_diag
    for c in path_counts:
        for name, v in c.items():
            counts[name] += v
    check(counts["crout_chol_wi"] > 0 and counts["fleet_fused"] > 0,
          "a kernel of the fused paths was never launched")

    # --------------------------------------------------------------- 13 ----
    def fleet_fit_at(max_n, X, Y):
        fbatched._FLEET_FUSED_MAX_N = max_n
        try:
            tg.fit_batched(k_f, X, Y, 0.1)
        finally:
            fbatched._FLEET_FUSED_MAX_N = saved_max_n

    def rotate(fns, rounds, queued=False):
        """Each fn timed in turns, the order reversed every round, after a
        warm-up: {name: (median, runs)}; ``queued`` as in timed."""
        for fn in fns.values():
            fn()
        runs = {k: [] for k in fns}
        keys = list(fns)
        for i in range(rounds):
            for k in (keys if i % 2 == 0 else keys[::-1]):
                runs[k].append(timed(fns[k], queued))
        return {k: (float(np.median(v)), v) for k, v in runs.items()}

    r13 = np.random.default_rng(11)  # phase 11's data at B=256, n=1024
    fit_cmp, panel_cmp = {}, {}
    for B_, n_ in ((Bf, nf), (256, 1024)):
        X_ = Xf if n_ == nf else t32(r13.standard_normal((B_, n_, df_)))
        Y_ = Yf if n_ == nf else t32(r13.standard_normal((B_, n_, qf)))
        fit_cmp[(B_, n_)] = rotate({"fused": lambda: fleet_fit_at(1024, X_, Y_),
                                    "panel-stepped": lambda: fleet_fit_at(0, X_, Y_),
                                    "plain f32": lambda: plain_fleet_fit(X_, Y_)}, 10)
        P_ = Pf if B_ == Bf else t32(np.tile([2.0, 1.0, 1.0, sigf * sigf], (B_, 1)))
        K_ = gop.gram_batched(X_, P_)
        panel_cmp[(B_, n_)] = rotate({p_: (lambda p_=p_: fbatched.factor_solve_fused(K_, Y_, p_))
                                      for p_ in (64, 128)}, 6)
        del X_, Y_, P_, K_

    def vg_at(max_n):
        fbatched._FLEET_FUSED_MAX_N = max_n
        try:
            port_fleet_mll(Xf, Yf, 0.1, P0)
        finally:
            fbatched._FLEET_FUSED_MAX_N = saved_max_n

    vg_cmp = rotate({"fused": lambda: vg_at(1024), "panel-stepped": lambda: vg_at(0)}, 6)

    # K9 per fit: one launch on the fleet's K, against its plain version and the
    # library pair torch.linalg.cholesky_ex + torch.cholesky_solve (two calls)
    Kfit = gop.gram_batched(Xf, Pf)
    k9 = rotate({"kernel": lambda: fbatched.factor_solve_fused(Kfit, Yf),
                 "plain": lambda: fbatched.factor_solve_fused_reference(Kfit, Yf),
                 "library": lambda: torch.cholesky_solve(Yf, torch.linalg.cholesky_ex(Kfit)[0])}, 5)
    kstats["fleet_fused"].update(ms=k9["kernel"][0], plain_ms=k9["plain"][0],
                                 library_ms=k9["library"][0])

    # K8 per fleet fit under GPR_FLEET_DIAG=crout: each panel step's diagonal
    # step timed alone, with K8, crout_xlaw's pair (K7 + the triangular solve),
    # the plain version and the library pair torch.linalg.cholesky_ex +
    # solve_triangular (two calls) in turn
    def diag_total(step):
        tot = [0.0]

        def timed_diag(D, out):
            box = []
            tot[0] += timed(lambda: box.append(step(D, out)))
            return box[0]

        L = fbatched.cholesky_batched(Kfit, diag=timed_diag)
        check(bool(torch.isfinite(L[:, -1, -1]).all()), "timed fleet factorization failed")
        return tot[0]

    def k7_trsm(D, out):
        L = fcrout.crout_chol(D, out=out)
        return L, fbatched._tri_inverse(L)

    def library8(D, out):
        L = out.copy_(torch.linalg.cholesky_ex(D)[0])
        return L, fbatched._tri_inverse(L)

    steps8 = {"kernel": lambda D, out: fcrout.crout_chol_wi(D, L_out=out),
              "K7 + trsm": k7_trsm, "plain": fbatched._wi_reference, "library": library8}
    k8runs = {k: [] for k in steps8}
    diag_total(steps8["kernel"])  # warm-up
    for order in (list(steps8), list(steps8)[::-1]) * 3:
        for k in order:
            k8runs[k].append(diag_total(steps8[k]))
    kstats["crout_chol_wi"].update(ms=float(np.median(k8runs["kernel"])),
                                   plain_ms=float(np.median(k8runs["plain"])),
                                   library_ms=float(np.median(k8runs["library"])))
    k8dd = rotate({"kernel": lambda: fcrout.crout_chol_wi(DDt),
                   "plain": lambda: fcrout.crout_chol_wi_reference(DDt)}, 5)
    del Kfit, DDt

    fbatched._FLEET_FUSED_MAX_N = 1024
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t_w = time.perf_counter()
            for _ in range(5):
                tg.fit_batched(k_f, Xf, Yf, 0.1)
            torch.cuda.synchronize()
            wall_fused = (time.perf_counter() - t_w) * 1e3 / 5
    finally:
        fbatched._FLEET_FUSED_MAX_N = saved_max_n
    by_kernel_f = []
    for e in prof.key_averages():
        if "CUDA" in str(e.device_type):
            us = getattr(e, "self_device_time_total", None)
            us = e.self_cuda_time_total if us is None else us
            by_kernel_f.append((us / 1e3 / 5, e.count / 5, e.key))
    busy_fused = sum(t for t, _, _ in by_kernel_f)

    # K8 per fit: n / 128 launches of B tiles of 128, L and W (2 b^3 / 3 FLOP;
    # the lower triangle read, both tiles written); K9 per fit: one launch
    kstats["crout_chol_wi"].update(sum_bounds(
        [(Bf * 2.0 * pf ** 3 / 3.0, 4.0 * Bf * (pf * (pf + 1) / 2 + 2 * pf * pf))] * nbf))
    kstats["fleet_fused"].update(bound(Bf * (nf ** 3 / 3.0 + 2.0 * nf * nf * qf),
                                       4.0 * Bf * (nf * (nf + 1) / 2 + nf * nf + 2 * nf * qf)))

    def runs_text(r):
        return ", ".join(f"{t:.3f}" for t in r)

    print(f"phase 13 fused fleet timings ({smi}), CUDA events, medians:")
    for (B_, n_), res in fit_cmp.items():
        print(f"  fleet fit B={B_} n={n_} d={df_} q={qf}: " + "; ".join(
            f"{k} {m:.3f} ms = {B_ / m * 1e3:.0f} fits/s (runs {runs_text(r)})" for k, (m, r) in res.items()))
    for (B_, n_), res in panel_cmp.items():
        print(f"  K9 alone, B={B_} n={n_}: " + "; ".join(
            f"panel {k} {m:.3f} ms (runs {runs_text(r)})" for k, (m, r) in res.items()))
    print("  mll_batched value + gradient B=%d n=%d: %s" % (Bf, nf, "; ".join(
        f"{k} {m:.3f} ms (runs {runs_text(r)})" for k, (m, r) in vg_cmp.items())))
    print(f"  K9 fleet_fused per fit (1 launch, B={Bf} n={nf} q={qf}, panel {pf9}): " + "; ".join(
        f"{k} {m:.4f} ms" for k, (m, r) in k9.items()) + " (library: cholesky_ex + cholesky_solve)")
    print(f"  K8 crout_chol_wi per fit under GPR_FLEET_DIAG=crout ({nbf} launches of {Bf} x {pf}^2 "
          f"tiles): " + "; ".join(f"{k} {[round(t, 4) for t in v]} ms" for k, v in k8runs.items())
          + " (library: cholesky_ex + solve_triangular)")
    print(f"  K8 on the fused backward's D D^T tiles ({nf // pf9 * Bf} x {pf9}^2, 1 launch): kernel {k8dd['kernel'][0]:.4f} ms, plain {k8dd['plain'][0]:.4f} ms")
    print(f"  torch.profiler, 5 fused fleet fits B={Bf} n={nf}: {wall_fused:.3f} ms per fit on the host "
          f"clock, device kernels {busy_fused:.3f} ms per fit, idle "
          f"{100.0 * (1.0 - busy_fused / wall_fused):.1f} % (profiler on; panel-stepped in phase 11: "
          f"{100.0 * (1.0 - busy_fit / wall_fit):.1f} %)")
    for t, c, name in sorted(by_kernel_f, reverse=True)[:8]:
        print(f"    {t:.4f} ms per fit, {c:g} launches: {name[:100]}")

    # --------------------------------------------------------------- 14 ----
    # K10 narrow_subst and K11 diag_tri_inv against their plain versions, on
    # the narrow-solve system of tests/test_ops.py:630-634 (X X^T / 64 + 4 I)
    # at n=16384 and 4096 with junk above the diagonal (only the lower triangle
    # is read): q = 1, 8, 128 (bs 512) and 8 (bs 1024, K11 by pairs) at 16384,
    # q = 3 at 4096; K11 at bs 256 and 512; a NaN in L makes the solve
    # non-finite.  K10's sweeps get 1e-5 and K11 1e-4 of the plain result's
    # largest entry (float32 sums in other orders); the solve 2e-5 against a
    # float64 solve of the same factor.
    print("phase 14 K10 narrow_subst and K11 diag_tri_inv against their plain versions")
    g14 = torch.Generator(device=dev).manual_seed(14)

    def narrow_system(n_):
        G = torch.randn((n_, 64), generator=g14, device=dev)
        A_ = G @ G.T / 64
        A_.diagonal().add_(4.0)
        L_ = torch.linalg.cholesky(A_)
        del A_
        return L_, L_ + torch.triu(torch.randn((n_, n_), generator=g14, device=dev), 1)

    L16, Lj16 = narrow_system(n)
    worst10 = {}
    for n_, Lc, Lj in ((n, L16, Lj16), (4096, *narrow_system(4096))):
        L64 = Lc.double()
        for bs, qs in (((512, (1, 8, 128)), (1024, (8,))) if n_ == n else ((512, (3,)),)):
            W_ = nsolve.diag_block_inverses(Lj, bs, "pallas")
            check(relerr(W_, nsolve.diag_block_inverses(Lc, bs, "xla")) <= 1e-4,
                  f"diagonal-tile inverses n={n_} bs={bs}")
            for q_ in qs:
                B_ = torch.randn((n_, q_), generator=g14, device=dev)
                Y_ = nsolve.subst_pass(Lj, W_, B_, True)
                X_ = nsolve.subst_pass(Lj, W_, Y_, False)
                Yr = nsolve.subst_pass_reference(Lc, W_, B_, True)
                Xr = nsolve.subst_pass_reference(Lc, W_, Y_, False)
                e_s, e_64 = max(relerr(Y_, Yr), relerr(X_, Xr)), relerr(X_, torch.cholesky_solve(B_.double(), L64))
                worst10[(n_, bs, q_)] = (e_s, e_64)
                check(e_s <= 1e-5 and e_64 <= 2e-5, f"K10 n={n_} bs={bs} q={q_}: sweeps {e_s}, solve {e_64}")
                if (n_, bs, q_) == (n, 512, 8):
                    kstats["narrow_subst"] = {"max_abs_err": max(float((Y_ - Yr).abs().max()),
                                                                 float((X_ - Xr).abs().max()))}
        x1 = nsolve.cho_solve_narrow(Lj, B_[:, 0], diag_inv="pallas")
        check(x1.shape == (n_,) and relerr(x1, torch.cholesky_solve(B_[:, :1].double(), L64)[:, 0]) <= 2e-5,
              f"1-D right-hand side at n={n_}")
        del L64
    for bs in (256, 512):
        W_ = nsolve.diag_tri_inv(Lj16, bs)
        Wr = nsolve.diag_tri_inv_reference(L16, bs)
        e = relerr(W_, Wr)
        check(e <= 1e-4 and bool(torch.all(torch.triu(W_, 1) == 0)), f"K11 bs={bs}: {e}")
        if bs == 512:
            kstats["diag_tri_inv"] = {"max_abs_err": float((W_ - Wr).abs().max())}
    bad = L16.clone()
    bad[n - 3, 5] = float("nan")
    check(not bool(torch.isfinite(nsolve.cho_solve_narrow(bad, torch.ones((n, 1), device=dev),
                                                          diag_inv="pallas")).all()),
          "a NaN in L did not reach the solve")
    bad[700, 700] = float("nan")
    check(not bool(torch.isfinite(nsolve.diag_tri_inv(bad, 512)[1]).all()), "a NaN pivot did not reach W")
    del bad, W_, Wr
    torch.cuda.synchronize()
    print("  " + "; ".join(f"n={a} bs={b} q={c}: sweeps vs plain {e1:.3g}, solve vs f64 {e2:.3g}"
                           for (a, b, c), (e1, e2) in worst10.items()))
    print(f"  K11 bs 256, 512 ok (bs 512 max abs err {kstats['diag_tri_inv']['max_abs_err']:.3g}); "
          "junk upper ignored; NaN in L and on a pivot non-finite ok")

    def with_env(env, fn):
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            return fn()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    narrow_env = {"GPR_SOLVE_SCHEDULE": "narrow", "GPR_SOLVE_DIAGINV": "pallas"}
    nb16 = n // 512

    # --------------------------------------------------------------- 15 ----
    print("phase 15 the narrow solve at full width (GPR_SOLVE_SCHEDULE=narrow, GPR_SOLVE_DIAGINV=pallas):"
          " bench fit n=16384 d=128 q=8, credible interval at 128 points, MLL value + gradient")
    bench64 = lambda A, B: gaussian64(A, B, 8.0, 1.0)  # noqa: E731

    def phase15_fit():
        _cuda.reset_launch_counts()
        gp_ = tg.fit(bench_k, Xb, Yb, sigma=0.1, use_pallas_gram=False)
        gp_.credible_interval(Xt[:128])
        torch.cuda.synchronize()
        c_ = _cuda.launch_counts()
        check(gp_.route == "fused-matrix" and tlin.solve_route(gp_.L, gp_.Y) == "narrow"
              and tlin.solve_route(gp_.L, Xt[:128].T) == "narrow", "narrow fit routes")
        # alpha and the interval's solve (q = 128): 2 K10 launches (one a sweep) and one K11 each
        check(c_["narrow_subst"] == 2 * 2 and c_["diag_tri_inv"] == 2
              and c_["panel_update"] > 0, f"narrow fit launches {c_}")
        print(f"  launches on the narrow fit path: {c_}")
        judge("narrow bench fit", gp_, Xb, Yb, Xt[:128], bench64, 1.0, sig, with_alpha=True)
        return c_

    def phase15_mll():
        _cuda.reset_launch_counts()
        v_, g_ = lk.mll_value_and_grad(bench_k, Xb, Yb, 0.1)
        torch.cuda.synchronize()
        c_ = _cuda.launch_counts()
        # alpha forward and its backward's solve
        check(c_["narrow_subst"] == 2 * 2 and c_["diag_tri_inv"] == 2, f"narrow MLL launches {c_}")
        print(f"  launches on the narrow MLL path: {c_}")
        hold_mll("narrow MLL n=16384", [8.0, 1.0], Xb, Yb, v_, g_, sig)
        return c_

    path_counts.extend([with_env(narrow_env, phase15_fit), with_env(narrow_env, phase15_mll)])
    torch.cuda.empty_cache()

    # --------------------------------------------------------------- 16 ----
    nw, kw = 4096, 512
    print(f"phase 16 the sliding window under the narrow schedule: Gaussian(2, 1), sigma 0.1, d=5 q=3, "
          f"fit n={nw} -> extend {kw} -> shrink {kw} -> predict at 64 points -> loo_cv")
    r16 = np.random.default_rng(16)
    Xw = t32(r16.standard_normal((nw + kw, 5)))
    Yw = t32(np.sin(Xw[:, :3].cpu().numpy()) + 0.1 * r16.standard_normal((nw + kw, 3)))
    Xs16 = t32(r16.standard_normal((64, 5)))
    k16 = lambda A, B: gaussian64(A, B, 2.0, 1.0)  # noqa: E731

    def plain_loo(X, Y):
        K = k16(X, X)
        K.diagonal().add_(sig * sig)
        L_ = torch.linalg.cholesky(K)
        dinv = torch.cholesky_inverse(L_).diagonal()
        return Y - torch.cholesky_solve(Y, L_) / dinv[:, None], 1.0 / dinv

    def phase16():
        _cuda.reset_launch_counts()
        gw = tg.fit(k4, Xw[:nw], Yw[:nw], sigma=0.1, use_pallas_gram=False)
        ge = tg.extend(gw, Xw[nw:], Yw[nw:])
        gs = tg.shrink(ge, kw)
        gs.predict(Xs16)
        gs.credible_interval(Xs16)
        loo = texact.loo_cv(gs)
        torch.cuda.synchronize()
        c_ = _cuda.launch_counts()
        check(gw.route == "fused-matrix" and tlin.solve_route(ge.L, ge.Y) == "narrow"
              and tlin.solve_route(gs.L, gs.Y) == "narrow", "window routes")
        # alpha at 4096, 4608 and 4096, and the interval's solve: one K10 launch a sweep
        check(c_["narrow_subst"] == 2 * 4 and c_["diag_tri_inv"] == 4, f"window launches {c_}")
        print(f"  launches on the window path: {c_}")
        win = {"fit n=4096": judge("window fit n=4096", gw, Xw[:nw], Yw[:nw], Xs16, k16, 1.0, sig, True),
               "extend to 4608": judge("extended n=4608", ge, Xw, Yw, Xs16, k16, 1.0, sig, True),
               "shrink to 4096": judge("shrunk n=4096", gs, Xw[kw:], Yw[kw:], Xs16, k16, 1.0, sig, True)}
        m64, v64_ = plain_loo(Xw[kw:].double(), Yw[kw:].double())
        m32, v32_ = plain_loo(Xw[kw:], Yw[kw:])
        win["loo_cv"] = {"loo_mean": gate(loo[0], m32, m64), "loo_var": gate(loo[1], v32_, v64_)}
        print("  loo_cv: rel err vs f64: " + ", ".join(
            f"{k} {r['err']:.3g} (plain f32 {r['plain_f32_err']:.3g})" for k, r in win["loo_cv"].items()))
        check(all(r["ok"] for r in win["loo_cv"].values()) and bool(torch.isfinite(loo[2])),
              "loo_cv: error above 3x the plain f32 route's")
        return c_

    path_counts.append(with_env(narrow_env, phase16))
    # ROADMAP's open cell: shrink by 64 at the breathing shape, against a refit
    gp4 = tg.fit(k4, X4, Y4, sigma=0.1, use_pallas_gram=False)
    shrink_ms = [timed(lambda: tg.shrink(gp4, 64)) for _ in range(3)]
    refit_ms = [timed(lambda: tg.fit(k4, X4[64:], Y4[64:], sigma=0.1, use_pallas_gram=False))
                for _ in range(3)]
    judge("shrink by 64 at n=3773", tg.shrink(gp4, 64), X4[64:], Y4[64:], Xs4, k16, 1.0, sig, True)
    del gp4
    print(f"  shrink k=64 at n=3773 (two products, then blocked-syrk at 3709): "
          f"{float(np.median(shrink_ms)):.2f} ms (runs "
          f"{', '.join(f'{t:.1f}' for t in shrink_ms)}); a refit on the 3709 samples "
          f"{float(np.median(refit_ms)):.2f} ms (runs {', '.join(f'{t:.1f}' for t in refit_ms)})")

    # --------------------------------------------------------------- 17 ----
    # torch.linalg.cholesky gives a column-major factor, which the kernels'
    # wrappers copy to row-major (2.3 ms at n=16384); the port's factorizations
    # write L row-major, so K10, K11 and their plain versions are timed on a
    # row-major copy, as the fit path hands them L, and torch.cholesky_solve on
    # the column-major factor, its own layout
    Lr16, Ljr16 = L16.contiguous(), Lj16.contiguous()
    B8 = torch.randn((n, 8), generator=g14, device=dev)
    W16 = nsolve.diag_block_inverses(Ljr16, 512, "pallas")
    W128 = nsolve.diag_block_inverses(L16, 128, "xla")
    k10 = rotate({
        "kernel": lambda: nsolve.subst_pass(Ljr16, W16, nsolve.subst_pass(Ljr16, W16, B8, True), False),
        "plain": lambda: nsolve.subst_pass_reference(Lr16, W16, nsolve.subst_pass_reference(Lr16, W16, B8, True), False),
        "library": lambda: torch.cholesky_solve(B8, L16),
        "library: two solve_triangular on the row-major factor": lambda: torch.linalg.solve_triangular(
            Lr16.T, torch.linalg.solve_triangular(Lr16, B8, upper=False), upper=True),
        "cho_solve_panels": lambda: fullchol.cho_solve_panels(L16, W128, B8),
        "narrow solve (K11 + K10)": lambda: nsolve.cho_solve_narrow(Ljr16, B8, diag_inv="pallas"),
        "narrow solve on the column-major factor": lambda: nsolve.cho_solve_narrow(Lj16, B8, diag_inv="pallas")}, 6)
    # library_ms: torch.cholesky_solve on its own column-major factor;
    # library_trsm_ms: two torch.linalg.solve_triangular on the row-major one
    kstats["narrow_subst"].update(ms=k10["kernel"][0], plain_ms=k10["plain"][0],
                                  library_ms=k10["library"][0],
                                  library_trsm_ms=k10["library: two solve_triangular on the row-major factor"][0])
    k11 = rotate({"kernel": lambda: nsolve.diag_tri_inv(Ljr16, 512),
                  "plain": lambda: nsolve.diag_tri_inv_reference(Lr16, 512),
                  "library": lambda: nsolve.diag_block_inverses(L16, 512, "xla")}, 6)
    kstats["diag_tri_inv"].update(ms=k11["kernel"][0], plain_ms=k11["plain"][0],
                                  library_ms=k11["library"][0])
    # a sweep reads the nb(nb-1)/2 off-diagonal tiles of L and the lower
    # triangle of each W_ii (never L's diagonal tiles), reads B, writes X
    offdiag, wlow = nb16 * (nb16 - 1) / 2 * 512 * 512, nb16 * 512 * 513 / 2
    sweep = (2.0 * 8 * (offdiag + wlow), 4.0 * (offdiag + wlow + 2 * n * 8))
    kstats["narrow_subst"].update(sum_bounds([sweep, sweep]))
    kstats["diag_tri_inv"].update(bound(nb16 * 512 ** 3 / 3.0, 4.0 * nb16 * (512 * 513 / 2 + 512 * 512)))
    Lw, _ = narrow_system(4096)
    Lwr = Lw.contiguous()
    Ww = nsolve.diag_block_inverses(Lwr, 512, "pallas")
    B3 = torch.randn((4096, 3), generator=g14, device=dev)
    k10w = median_ms(lambda: nsolve.subst_pass(Lwr, Ww, nsolve.subst_pass(Lwr, Ww, B3, True), False), 10)
    libw = median_ms(lambda: torch.cholesky_solve(B3, Lw), 10)
    del L16, Lj16, Lr16, Ljr16, W16, W128, Lw, Lwr, Ww
    torch.cuda.empty_cache()
    def fit17():
        return tg.fit(bench_k, Xb, Yb, sigma=0.1, use_pallas_gram=False)

    fit_cmp17 = rotate({"narrow": lambda: with_env(narrow_env, fit17),
                        "default": lambda: with_env({"GPR_SOLVE_SCHEDULE": "blocked"}, fit17)}, 4)
    mll_cmp17 = rotate({"narrow": lambda: with_env(narrow_env, lambda: lk.mll_value_and_grad(bench_k, Xb, Yb, 0.1)),
                        "default": lambda: with_env({"GPR_SOLVE_SCHEDULE": "blocked"},
                                                    lambda: lk.mll_value_and_grad(bench_k, Xb, Yb, 0.1))}, 4)
    print(f"phase 17 narrow-solve timings ({smi}), CUDA events, medians:")
    print(f"  per solve at n=16384 q=8 (K10: 2 launches, one a sweep): " + "; ".join(
        f"{k} {m:.4f} ms (runs {runs_text(r)})" for k, (m, r) in k10.items())
        + f"; bound {kstats['narrow_subst']['bound_ms']:.4f} ms ({kstats['narrow_subst']['bound_by']})")
    print(f"  K11 per call at n=16384 bs=512 (32 tiles; blocked: 1 + 4 kernels): " + "; ".join(
        f"{k} {m:.4f} ms (runs {runs_text(r)})" for k, (m, r) in k11.items())
        + f"; bound {kstats['diag_tri_inv']['bound_ms']:.4f} ms ({kstats['diag_tri_inv']['bound_by']}); "
        "the first design, one warp a column, 3.5028 ms with the wrapper's layout copy (PERF.md row 12)")
    print(f"  K10 per solve at n=4096 q=3 (16 launches): {k10w:.4f} ms; torch.cholesky_solve {libw:.4f} ms")
    print("  fit n=16384 d=128 q=8 (fused-matrix), alpha by the narrow solve against the default "
          "triangular solves: " + "; ".join(f"{k} {m:.2f} ms (runs {runs_text(r)})" for k, (m, r) in fit_cmp17.items()))
    print("  MLL value + gradient n=16384: " + "; ".join(
        f"{k} {m:.2f} ms (runs {runs_text(r)})" for k, (m, r) in mll_cmp17.items()))
    for c in path_counts[-3:]:
        for name, v in c.items():
            counts[name] += v
    check(counts["narrow_subst"] > 0 and counts["diag_tri_inv"] > 0,
          "a kernel of the narrow-solve paths was never launched")

    # --------------------------------------------------------------- 18 ----
    # K12-K14 against their plain versions at n = 256, 512, 768 and 1024, each
    # on a strided view (row stride n + 200) inside a buffer that holds NaN
    # above the leaf's diagonal and all around it, then K13 in place; a leaf
    # that is not positive definite.  1e-5 relative against the plain version
    # (the same 64-block algorithm, float32 sums in another order) and
    # |W L - I| < 1e-4, as tests/test_ops.py:457-499 holds JAX's leaf kernels.
    print("phase 18 K12 leaf_chol, K13 leaf_chol_wi and K14 tri_inv_leaf against their plain versions")
    g18 = torch.Generator(device=dev).manual_seed(18)
    nan = float("nan")
    # K12 holds the leaf in one thread-block cluster of n / 64 CTAs (16 at
    # n = 1024, a non-portable size): how many such clusters the card places
    # at once, by cudaOccupancyMaxActiveClusters (0: the launch would fail)
    placed18 = {n_: tleaf.max_active_clusters(n_) for n_ in (256, 512, 768, 1024)}
    check(all(v > 0 for v in placed18.values()), f"K12's cluster cannot be placed: {placed18}")
    print("  K12 clusters the card places at once (cudaOccupancyMaxActiveClusters): " + ", ".join(
        f"n={n_} ({n_ // 64} CTAs) {v}" for n_, v in placed18.items()))

    def leaf_spd(n_):
        G = torch.randn((n_, n_), generator=g18, device=dev)
        A_ = G @ G.T / n_
        A_.diagonal().add_(1.0)
        return A_

    worst18 = {}
    for n_ in (256, 512, 768, 1024):
        A_ = leaf_spd(n_)
        up = torch.triu(torch.full_like(A_, nan), 1)
        buf = torch.full((n_ + 64, n_ + 200), nan, device=dev)
        view = buf[32:32 + n_, 100:100 + n_]
        view.copy_(torch.tril(A_) + up)
        Lr, Wr = tleaf.leaf_cholesky_wi_reference(A_)
        L12 = tleaf.leaf_cholesky(view)
        L13, W13 = tleaf.leaf_cholesky_wi(view)
        check(torch.equal(L13, L12), f"K13 n={n_}: its factor is not K12's")
        W14 = tleaf.tri_inv_leaf(L13 + up)
        check(torch.equal(W14, W13), f"K13 n={n_}: its W is not K14's of its factor")
        W14r = tleaf.tri_inv_leaf_reference(L13)
        eye = torch.eye(n_, device=dev)
        errs = {"leaf_chol": relerr(L12, Lr), "leaf_chol_wi": max(relerr(L13, Lr), relerr(W13, Wr)),
                "tri_inv_leaf": relerr(W14, W14r)}
        res = max(float((W13 @ L13 - eye).abs().max()), float((W14 @ L13 - eye).abs().max()))
        check(all(e <= 1e-5 for e in errs.values()) and res < 1e-4, f"K12-K14 n={n_}: {errs}, |WL-I| {res}")
        check(all(bool(torch.all(torch.triu(M, 1) == 0)) for M in (L12, L13, W13, W14)),
              f"K12-K14 n={n_}: strict upper not 0")
        check(bool(torch.isnan(buf[:32]).all() and torch.isnan(buf[:, :100]).all()),
              f"K12-K14 n={n_}: wrote outside the leaf")
        # K12 reads only the lower triangle: the same factor from a clean copy,
        # twice (a fixed sum order), and in place over the strided view
        low = torch.tril(A_).contiguous()
        check(torch.equal(tleaf.leaf_cholesky(low), L12) and torch.equal(tleaf.leaf_cholesky(view), L12),
              f"K12 n={n_}: NaN above the diagonal or a second call changed the factor")
        saved = view.clone()
        Lk = tleaf.leaf_cholesky(view, out=view)
        check(Lk.data_ptr() == view.data_ptr() and torch.equal(view, L12), f"K12 n={n_} in place")
        view.copy_(saved)
        Lv, Wv = tleaf.leaf_cholesky_wi(view, out=view)
        check(Lv.data_ptr() == view.data_ptr() and relerr(view, Lr) <= 1e-5 and relerr(Wv, Wr) <= 1e-5,
              f"K13 n={n_} in place")
        worst18[n_] = (errs, res)
        if n_ == 1024:
            kstats["leaf_chol"] = {"max_abs_err": float((L12 - Lr).abs().max())}
            kstats["leaf_chol_wi"] = {"max_abs_err": max(float((L13 - Lr).abs().max()),
                                                         float((W13 - Wr).abs().max()))}
            kstats["tri_inv_leaf"] = {"max_abs_err": float((W14 - W14r).abs().max())}
    bad = leaf_spd(1024)
    bad[600, 600] = -1.0
    Lb, Wb = tleaf.leaf_cholesky_wi(bad)
    check(bool(torch.isnan(Lb[-1, -1])) and not bool(torch.isfinite(Wb).all())
          and bool(torch.isnan(tleaf.leaf_cholesky(bad)[-1, -1]))
          and not bool(torch.isfinite(tleaf.tri_inv_leaf(Lb)).all()), "a failed leaf is not poisoned")
    del A_, buf, view, Lr, Wr, L12, L13, W13, W14, W14r, bad, Lb, Wb, low, saved, Lk
    torch.cuda.synchronize()
    for n_, (errs, res) in worst18.items():
        print(f"  n={n_} (strided, NaN upper): rel err vs plain " + ", ".join(
            f"{k} {e:.3g}" for k, e in errs.items()) + f"; |WL-I| {res:.3g}; K12 bit-identical to its "
            "factor of the lower triangle alone, twice and in place; K13's factor K12's and its W K14's of "
            "that factor; K13 in place ok")
    print("  a leaf that is not positive definite: L[-1,-1] NaN, W non-finite ok")

    # --------------------------------------------------------------- 19 ----
    leaf_env = {"GPR_CHOL_LEAF_INV": "1"}
    rec_leaf_env = {"GPR_CHOL_LEAF_INV": "1", "GPR_CHOL_SCHEDULE": "recursive"}
    print("phase 19 the leaf kernel on the blocked route (GPR_CHOL_LEAF_INV=1): breathing training, "
          "then with GPR_CHOL_SCHEDULE=recursive the bench fit and the MLL at n=16384 and 16383")

    def phase19_train():
        _cuda.reset_launch_counts()
        k_mle19, r_mle19 = tg.fit_mle(k0, X4, Y4, 0.1, iterations=5)
        k_map19, r_map19 = tg.fit_map(k0, X4, Y4, 0.1, prior, iterations=3)
        gp19 = tg.fit(k_mle19, X4, Y4, sigma=0.1, use_pallas_gram=False)
        torch.cuda.synchronize()
        c_ = _cuda.launch_counts()
        check(r_mle19.route == "blocked-syrk-leaf" and r_map19.route == "blocked-syrk-leaf"
              and gp19.route == "blocked-syrk-leaf",
              f"leaf training routes {r_mle19.route}, {r_map19.route}, {gp19.route}")
        # every factorization at n=3773: 3 trailing updates (K5), 2 aligned leaves (K13)
        check(c_["syrk_update"] % 3 == 0 and c_["leaf_chol_wi"] == 2 * (c_["syrk_update"] // 3) > 0,
              f"leaf training launches {c_}")
        print(f"  launches on the leaf training path ({c_['syrk_update'] // 3} factorizations): {c_}")
        sg19, sc19 = (float(v) for v in k_mle19.params)
        print(f"  fit_mle trace {[round(float(v), 3) for v in r_mle19.trace]} -> Gaussian({sg19:.5g}, "
              f"{sc19:.5g}) (phase 6: Gaussian({sg:.5g}, {sc:.5g})); fit_map trace "
              f"{[round(float(v), 3) for v in r_map19.trace]}")
        check(abs(sg19 - sg) <= 1e-3 * abs(sg) and abs(sc19 - sc) <= 1e-3 * abs(sc),
              "the leaf route learned other hyperparameters than the default route")
        judge("learned Gaussian, n=3773, leaf route", gp19, X4, Y4, Xs4,
              lambda A, B: gaussian64(A, B, sg19, sc19), sc19 * sc19, sig, with_alpha=True)
        for name, kern in (("start", k0), ("learned", k_mle19)):
            v_, g_ = lk.mll_value_and_grad(kern, X4, Y4, 0.1)
            hold_mll(f"leaf MLL n=3773 at the {name} kernel", [float(p) for p in kern.params],
                     X4, Y4, v_, g_, sig)
        return c_

    def phase19_bench():
        _cuda.reset_launch_counts()
        gp_ = tg.fit(bench_k, Xb, Yb, sigma=0.1, use_pallas_gram=True)
        gp_.credible_interval(Xt[:128])
        torch.cuda.synchronize()
        c_ = _cuda.launch_counts()
        check(gp_.route == "gram-kernel" and tlin.cholesky_route(gp_.L) == "blocked-syrk-leaf",
              f"leaf bench fit routes {gp_.route}")
        check(c_["leaf_chol_wi"] == 16 and c_["gram_tile"] > 0 and c_["syrk_update"] > 0,
              f"leaf bench fit launches {c_}")
        print(f"  launches on the leaf bench fit (n=16384: 16 leaves): {c_}")
        judge("leaf bench fit n=16384", gp_, Xb, Yb, Xt[:128], bench64, 1.0, sig, with_alpha=True)
        return c_

    def phase19_mll():
        out = {}
        for X_, Y_, leaves in ((Xb, Yb, 16), (X163, Y163, 15)):
            _cuda.reset_launch_counts()
            v_, g_ = lk.mll_value_and_grad(bench_k, X_, Y_, 0.1)
            torch.cuda.synchronize()
            c_ = _cuda.launch_counts()
            check(lk.factor_route(X_) == "blocked-syrk-leaf" and c_["leaf_chol_wi"] == leaves,
                  f"leaf MLL n={X_.shape[0]} launches {c_}")
            print(f"  launches on the leaf MLL n={X_.shape[0]} ({leaves} leaves): {c_}")
            hold_mll(f"leaf MLL n={X_.shape[0]}", [8.0, 1.0], X_, Y_, v_, g_, sig)
            torch.cuda.empty_cache()
            out = {k: out.get(k, 0) + v for k, v in c_.items()}
        return out

    path_counts.extend([with_env(leaf_env, phase19_train), with_env(rec_leaf_env, phase19_bench),
                        with_env(rec_leaf_env, phase19_mll)])
    for c in path_counts[-3:]:
        for name, v in c.items():
            counts[name] += v
    check(counts["leaf_chol_wi"] > 0, "K13 was never launched on the leaf paths")
    torch.cuda.empty_cache()

    # --------------------------------------------------------------- 20 ----
    A20 = leaf_spd(1024)
    L20 = torch.linalg.cholesky(A20).contiguous()  # cuSOLVER returns a column-major factor
    I20 = torch.eye(1024, device=dev)
    # K12 at n = 256, 512 and 1024 in turns with its plain version and
    # cholesky_ex: each call queued behind a device sleep (the kernel's time,
    # the kernels line's ms at 1024), then with the host's enqueue (the
    # wrapper's checks, its allocations and the ctypes launch)
    t12s = {}
    for n_ in (256, 512, 1024):
        A_ = A20 if n_ == 1024 else leaf_spd(n_)
        fns12 = {"kernel": lambda: tleaf.leaf_cholesky(A_), "plain": lambda: tleaf.leaf_cholesky_reference(A_),
                 "library": lambda: torch.linalg.cholesky_ex(A_)}
        t12s[(n_, "queued")] = rotate(fns12, 10, queued=True)
        t12s[(n_, "with the host's enqueue")] = rotate(fns12, 10)
    t12 = t12s[(1024, "queued")]
    # K13 and K14 per 1024-leaf the same way: queued (the kernels line's ms),
    # then with the host's enqueue (its ms_enqueue)
    fns13 = {"kernel": lambda: tleaf.leaf_cholesky_wi(A20), "plain": lambda: tleaf.leaf_cholesky_wi_reference(A20),
             "library": lambda: torch.linalg.solve_triangular(torch.linalg.cholesky_ex(A20)[0], I20, upper=False)}
    t13s = {"queued": rotate(fns13, 10, queued=True), "with the host's enqueue": rotate(fns13, 10)}
    t13 = t13s["queued"]
    fns14 = {"kernel": lambda: tleaf.tri_inv_leaf(L20), "plain": lambda: tleaf.tri_inv_leaf_reference(L20),
             "library": lambda: torch.linalg.solve_triangular(L20, I20, upper=False)}
    t14s = {"queued": rotate(fns14, 10, queued=True), "with the host's enqueue": rotate(fns14, 10)}
    t14 = t14s["queued"]
    # what one of K12's 16 diagonal steps costs alone: K8 on one 64-tile is
    # the same load, sweep, inverse and stores on one block
    diag_ms = median_ms(lambda: fcrout.crout_chol_wi(A20[:64, :64][None]), 20)
    s20 = 1024
    tri, sq = 4.0 * s20 * (s20 + 1) / 2, 4.0 * s20 * s20
    for name, t_, flop, nbytes in (("leaf_chol", t12, s20 ** 3 / 3.0, tri + sq),
                                   ("leaf_chol_wi", t13, 2.0 * s20 ** 3 / 3.0, tri + 2 * sq),
                                   ("tri_inv_leaf", t14, s20 ** 3 / 3.0, tri + sq)):
        kstats[name].update(ms=t_["kernel"][0], plain_ms=t_["plain"][0], library_ms=t_["library"][0],
                            **bound(flop, nbytes))
    for name, t_ in (("leaf_chol_wi", t13s), ("tri_inv_leaf", t14s)):
        kstats[name]["ms_enqueue"] = t_["with the host's enqueue"]["kernel"][0]
    del A20, L20, I20
    K20 = gaussian64(Xb, Xb, 8.0, 1.0)
    K20.diagonal().add_(sig * sig)
    fact20 = rotate({"blocked-syrk-leaf": lambda: blocked.cholesky_blocked(K20, leaf_inverse=True),
                     "blocked-syrk": lambda: blocked.cholesky_blocked(K20, leaf_inverse=False),
                     "torch.linalg.cholesky": lambda: torch.linalg.cholesky(K20)}, 4)
    del K20
    torch.cuda.empty_cache()
    rec_env = {"GPR_CHOL_SCHEDULE": "recursive", "GPR_CHOL_LEAF_INV": "0"}
    fit20 = rotate({"leaf": lambda: with_env(rec_leaf_env, lambda: tg.fit(bench_k, Xb, Yb, sigma=0.1,
                                                                         use_pallas_gram=True)),
                    "no leaf": lambda: with_env(rec_env, lambda: tg.fit(bench_k, Xb, Yb, sigma=0.1,
                                                                       use_pallas_gram=True))}, 4)
    mll20 = rotate({"leaf": lambda: with_env(rec_leaf_env, lambda: lk.mll_value_and_grad(bench_k, Xb, Yb, 0.1)),
                    "no leaf": lambda: with_env(rec_env, lambda: lk.mll_value_and_grad(bench_k, Xb, Yb, 0.1))},
                   4)
    print(f"phase 20 leaf timings ({smi}), CUDA events, medians:")
    for (n_, mode), t_ in t12s.items():
        print(f"  K12 leaf_chol n={n_} {mode}: " + "; ".join(
            f"{k} {m:.4f} ms (runs {runs_text(r)})" for k, (m, r) in t_.items())
            + f"; cholesky_ex / kernel {t_['library'][0] / t_['kernel'][0]:.2f}x")
    for label, name, t_ in (("K12 leaf_chol (queued)", "leaf_chol", t12),
                            ("K13 leaf_chol_wi (queued)", "leaf_chol_wi", t13),
                            ("K13 leaf_chol_wi (with the host's enqueue)", "leaf_chol_wi", t13s["with the host's enqueue"]),
                            ("K14 tri_inv_leaf (queued)", "tri_inv_leaf", t14),
                            ("K14 tri_inv_leaf (with the host's enqueue)", "tri_inv_leaf", t14s["with the host's enqueue"])):
        print(f"  {label} per 1024-leaf: " + "; ".join(
            f"{k} {m:.4f} ms (runs {runs_text(r)})" for k, (m, r) in t_.items())
            + f"; bound {kstats[name]['bound_ms']:.4f} ms ({kstats[name]['bound_by']})")
    print(f"  one 64-wide diagonal step alone (K8 crout_chol_wi on one 64x64 tile, a launch): {diag_ms:.4f} ms")
    print("  factorization n=16384 (bench K): " + "; ".join(
        f"{k} {m:.2f} ms (runs {runs_text(r)})" for k, (m, r) in fact20.items()))
    print("  fit n=16384 d=128 q=8 under GPR_CHOL_SCHEDULE=recursive (gram-kernel): " + "; ".join(
        f"{k} {m:.2f} ms (runs {runs_text(r)})" for k, (m, r) in fit20.items()))
    print("  MLL value + gradient n=16384 under GPR_CHOL_SCHEDULE=recursive: " + "; ".join(
        f"{k} {m:.2f} ms (runs {runs_text(r)})" for k, (m, r) in mll20.items()))
    # --------------------------------------------------------------- 21 ----
    # K15-K18 against their plain versions: K16 on JAX's lists (tests/test_ops.py:
    # 805-823) and on the schedule's first narrow and wide lists at n=4096, K17 at
    # tile columns 0 and 8 with NaN above its diagonal tile, K18 bit-exact on NaN
    # above the diagonal at n = 2048 and the main path's 4096, 4608 and 16384,
    # K15 at (1024, 256) and (8192, 256).  1e-5 relative to
    # the largest entry (float32 sums in other orders; the kernels' panels by
    # 64-blocks and products with W, the plain versions by cholesky_ex and a
    # triangular solve).  Then the whole schedule at n = 1024, 2048, 4096 with
    # NaN and 1234.0 above the diagonal: bit-identical factors, an exact-zero
    # upper, 1e-5 relative to float64; a matrix that is not positive definite.
    print("phase 21 K15 panel_factor, K16 rank_update_tiles, K17 panel_inplace and K18 zero_upper "
          "against their plain versions")
    g21 = torch.Generator(device=dev).manual_seed(21)

    def spd21(n_):
        G = torch.randn((n_, n_), generator=g21, device=dev)
        A_ = G @ G.T / n_
        A_.diagonal().add_(1.0)
        return A_

    def tile_mask(S, rows, cols, bm):
        m = torch.zeros_like(S, dtype=torch.bool)
        for i, j in zip(rows, cols):
            m[i * bm:(i + 1) * bm, j * bm:(j + 1) * bm] = True
        return m

    errs21 = {}
    S0 = torch.randn((1024, 1024), generator=g21, device=dev)
    upd4096 = [s_ for s_ in tinp.schedule(4096, 512, 256, dev) if s_[0] == "update"]
    lists = [("JAX's lists", S0, [2, 3, 3], [2, 2, 3], [0, 1], 256)]
    S4 = torch.randn((4096, 4096), generator=g21, device=dev)
    for label, st in (("narrow n=4096", upd4096[0]), ("wide n=4096", upd4096[1])):
        lists.append((label, S4, st[1].tolist(), st[2].tolist(), st[3].tolist(), st[4]))
    for label, S_, rows, cols, kcols, bm in lists:
        K_, R_ = S_.clone(), S_.clone()
        tinp.rank_update_inplace(K_, rows, cols, kcols, bm=bm, bk=bm)
        tinp.rank_update_reference(R_, rows, cols, kcols, bm=bm, bk=bm)
        m = tile_mask(S_, rows, cols, bm)
        e = float((K_ - R_).abs().max()) / float(R_.abs().max())
        check(e <= 1e-5 and torch.equal(K_[~m], S_[~m]), f"K16 {label}: {e}")
        errs21[f"K16 {label}"] = e
        kstats["rank_update_tiles"] = {"max_abs_err": float((K_ - R_).abs().max())}
    A4 = spd21(4096)
    nan_tile = torch.triu(torch.full((256, 256), float("nan"), device=dev), 1)
    for c0t in (0, 8):
        e_ = (c0t + 1) * 256
        S_ = A4.clone()
        S_[c0t * 256:e_, c0t * 256:e_] += nan_tile
        R_ = tinp.panel_inplace_reference(A4.clone(), c0t)
        tinp.panel_inplace(S_, c0t)
        pan = (slice(c0t * 256, None), slice(c0t * 256, e_))
        m = torch.zeros_like(S_, dtype=torch.bool)
        m[pan] = True
        e = relerr(S_[pan], R_[pan])
        check(e <= 1e-5 and bool(torch.all(torch.triu(S_[c0t * 256:e_, c0t * 256:e_], 1) == 0))
              and torch.equal(S_[~m], A4[~m]), f"K17 c0t={c0t}: {e}")
        errs21[f"K17 c0t={c0t}"] = e
        if c0t == 8:
            kstats["panel_inplace"] = {"max_abs_err": float((S_[pan] - R_[pan]).abs().max())}
    # K18 at n=2048 and at the main path's buffers (4096, 4608, 16384)
    for n_ in (2048, 4096, 4608, 16384):
        S_ = torch.randn((n_, n_), generator=g21, device=dev)
        S_ += torch.triu(torch.full_like(S_, float("nan")), 1)
        R_ = torch.tril(S_)
        tinp.zero_upper_inplace(S_)
        check(torch.equal(S_, R_), f"K18 n={n_}: not bit-exact")
        del S_, R_
    kstats["zero_upper"] = {"max_abs_err": 0.0}
    A8 = spd21(8192)
    for n_ in (1024, 8192):
        P_ = A8[:n_, :256]
        L15 = tpanel.panel_factor(P_)
        e = relerr(L15, tpanel.panel_factor_reference(P_))
        check(e <= 1e-5, f"K15 ({n_}, 256): {e}")
        errs21[f"K15 ({n_}, 256)"] = e
        Pn = P_.clone()  # D is read from its upper triangle only; a fixed sum order
        Pn[:256] += torch.tril(torch.full((256, 256), float("nan"), device=dev), -1)
        check(torch.equal(tpanel.panel_factor(Pn), L15) and torch.equal(tpanel.panel_factor(P_), L15),
              f"K15 ({n_}, 256): NaN below the diagonal tile or a second call changed the output")
    del L15, Pn
    kstats["panel_factor"] = {"max_abs_err": float((tpanel.panel_factor(A8[:, :256])
                                                    - tpanel.panel_factor_reference(A8[:, :256])).abs().max())}
    try:
        tpanel.panel_factor(A8[:1000, :256])
        check(False, "K15 took a panel of 1000 rows")
    except ValueError:
        pass
    del S0, S4, A8, K_
    for n_ in (1024, 2048, 4096):
        A_ = A4[:n_, :n_]
        L_ = tinp.cholesky_inplace(A_)
        e = relerr(L_, torch.linalg.cholesky(A_.double()))
        same = all(torch.equal(tinp.cholesky_inplace(torch.tril(A_) + torch.triu(torch.full_like(A_, j), 1)), L_)
                   for j in (float("nan"), 1234.0))
        check(e <= 1e-5 and same and bool(torch.all(torch.triu(L_, 1) == 0)),
              f"cholesky_inplace n={n_}: err {e}, junk-independent {same}")
        errs21[f"cholesky_inplace n={n_} vs f64"] = e
    bad = A4[:2048, :2048].clone()
    bad[1500, 1500] = -1.0
    check(bool(torch.isnan(tinp.cholesky_inplace(bad)[-1, -1])), "a failed pivot did not reach L[-1, -1]")
    Lz, jz = with_env({"GPR_CHOL_SCHEDULE": "inplace"},
                      lambda: tlin.safe_cholesky(torch.zeros((1024, 1024), device=dev)))
    check(float(jz) > 0.0 and bool(torch.isfinite(Lz).all()), "inplace jitter escalation")
    del A4, bad, L_, Lz
    torch.cuda.synchronize()
    print("  rel err vs plain: " + ", ".join(f"{k} {v:.3g}" for k, v in errs21.items()))
    print("  K15: NaN below its diagonal tile leaves the output bit-identical; two calls bit-equal")
    print(f"  K18 bit-exact at n = 2048, 4096, 4608, 16384; junk above the diagonal (NaN, 1234.0) leaves the factor bit-identical; a failed "
          f"pivot gives L[-1,-1] NaN; safe_cholesky on 0 escalates to jitter {float(jz):.3g}: ok")

    # --------------------------------------------------------------- 22 ----
    inplace_env = {"GPR_CHOL_SCHEDULE": "inplace"}
    other_factors = ("panel_update", "diag_factor_inv", "panel_solve", "syrk_update", "leaf_chol_wi")

    def inplace_launches(c_, n_, label):
        """Exact launches per factorization on the in-place route: n/256 K17,
        n/256 - 1 K16, one K18, and no other factorization kernel."""
        f = c_["zero_upper"]
        check(f > 0 and c_["panel_inplace"] == n_ // 256 * f and c_["rank_update_tiles"] == (n_ // 256 - 1) * f
              and all(c_[k] == 0 for k in other_factors), f"{label} launches {c_}")
        return f

    print("phase 22 the in-place route at full width (GPR_CHOL_SCHEDULE=inplace): bench fit n=16384, MLL at "
          "n=16384 and 16383, training and the sliding window at n=4096")

    def phase22_bench():
        _cuda.reset_launch_counts()
        gp_ = tg.fit(bench_k, Xb, Yb, sigma=0.1, use_pallas_gram=True)
        gp_.credible_interval(Xt[:128])
        torch.cuda.synchronize()
        c_ = _cuda.launch_counts()
        check(gp_.route == "gram-kernel" and tlin.cholesky_route(gp_.L) == "inplace", "inplace bench fit routes")
        check(inplace_launches(c_, n, "inplace bench fit") == 1 and c_["gram_tile"] > 0,
              f"inplace bench fit launches {c_}")
        print(f"  launches on the inplace bench fit (n=16384: 64 / 63 / 1): {c_}")
        judge("inplace bench fit n=16384", gp_, Xb, Yb, Xt[:128], bench64, 1.0, sig, with_alpha=True)
        return c_

    def phase22_mll():
        out = {}
        for X_, Y_, route in ((Xb, Yb, "inplace"), (X163, Y163, "blocked-syrk")):
            _cuda.reset_launch_counts()
            v_, g_ = lk.mll_value_and_grad(bench_k, X_, Y_, 0.1)
            torch.cuda.synchronize()
            c_ = _cuda.launch_counts()
            check(lk.factor_route(X_) == route, f"inplace MLL n={X_.shape[0]} route {lk.factor_route(X_)}")
            if route == "inplace":
                check(inplace_launches(c_, n, "inplace MLL") == 1, f"inplace MLL launches {c_}")
            else:  # n % 512 != 0 falls through to the blocked route, as in JAX
                check(c_["syrk_update"] > 0 and c_["panel_inplace"] == c_["rank_update_tiles"]
                      == c_["zero_upper"] == 0, f"MLL n=16383 launches {c_}")
            print(f"  launches on the MLL n={X_.shape[0]} ({route}): {c_}")
            hold_mll(f"MLL n={X_.shape[0]} under inplace ({route})", [8.0, 1.0], X_, Y_, v_, g_, sig)
            torch.cuda.empty_cache()
            out = {k: out.get(k, 0) + v for k, v in c_.items()}
        return out

    def phase22_window():
        Xn, Yn = Xw[:nw], Yw[:nw]
        _cuda.reset_launch_counts()
        k_mle22, r_mle22 = tg.fit_mle(k0, Xn, Yn, 0.1, iterations=5)
        k_map22, r_map22 = tg.fit_map(k0, Xn, Yn, 0.1, prior, iterations=3)
        gw = tg.fit(k_mle22, Xn, Yn, sigma=0.1, use_pallas_gram=False)
        torch.cuda.synchronize()
        c_ = _cuda.launch_counts()
        check(r_mle22.route == r_map22.route == gw.route == "inplace",
              f"inplace training routes {r_mle22.route}, {r_map22.route}, {gw.route}")
        f = inplace_launches(c_, nw, "inplace training")
        print(f"  launches on the inplace training at n={nw} ({f} factorizations: 16 / 15 / 1 each): {c_}")
        sg22, sc22 = (float(v) for v in k_mle22.params)
        print(f"  fit_mle trace {[round(float(v), 3) for v in r_mle22.trace]} -> Gaussian({sg22:.5g}, {sc22:.5g});"
              f" fit_map trace {[round(float(v), 3) for v in r_map22.trace]}")
        kl = lambda A, B: gaussian64(A, B, sg22, sc22)  # noqa: E731
        judge(f"learned Gaussian, n={nw}, inplace", gw, Xn, Yn, Xs16, kl, sc22 * sc22, sig, with_alpha=True)
        for name, kern in (("start", k0), ("learned", k_mle22)):
            v_, g_ = lk.mll_value_and_grad(kern, Xn, Yn, 0.1)
            hold_mll(f"inplace MLL n={nw} at the {name} kernel", [float(p) for p in kern.params],
                     Xn, Yn, v_, g_, sig)
        total = dict(c_)
        # extend factors only its 512-row block (torch-cholesky); shrink
        # refactors the 4096 window; a refit of the 4608 window takes 18 / 17 / 1
        for label, step, n_, expect in (
                ("extend by 512", lambda: tg.extend(gw, Xw[nw:], Yw[nw:]), None, 0),
                ("shrink by 512", lambda: tg.shrink(ge, kw), nw, 1),
                ("refit n=4608", lambda: tg.fit(k_mle22, Xw, Yw, sigma=0.1, use_pallas_gram=False), nw + kw, 1)):
            _cuda.reset_launch_counts()
            g_ = step()
            torch.cuda.synchronize()
            c_ = _cuda.launch_counts()
            if expect:
                check(inplace_launches(c_, n_, label) == 1, f"{label} launches {c_}")
            else:
                check(c_["panel_inplace"] == c_["rank_update_tiles"] == c_["zero_upper"] == 0, f"{label} {c_}")
            print(f"  launches on {label}: {c_}")
            if label == "extend by 512":
                ge = g_
                judge(f"extended n={nw + kw}", ge, Xw, Yw, Xs16, kl, sc22 * sc22, sig, with_alpha=True)
            elif label == "shrink by 512":
                check(tlin.cholesky_route(g_.L) == "inplace", "shrink route")
                judge(f"shrunk n={nw}", g_, Xw[kw:], Yw[kw:], Xs16, kl, sc22 * sc22, sig, with_alpha=True)
            else:
                check(g_.route == "inplace", f"refit route {g_.route}")
                judge(f"refit n={nw + kw}", g_, Xw, Yw, Xs16, kl, sc22 * sc22, sig, with_alpha=True)
            total = {k: total[k] + v for k, v in c_.items()}
        return total

    counts22 = [with_env(inplace_env, fn) for fn in (phase22_bench, phase22_mll, phase22_window)]
    torch.cuda.empty_cache()

    # --------------------------------------------------------------- 23 ----
    print("phase 23 row 13's path: cholesky_panels and cholesky_left_panels at n=8192 (K15 once per panel)")
    n23 = 8192
    K23 = gaussian64(Xb[:n23], Xb[:n23], 8.0, 1.0)
    K23.diagonal().add_(sig * sig)
    ref23 = torch.linalg.cholesky(K23.double())
    plain23 = torch.linalg.cholesky(K23)
    for fn in (tpanel.cholesky_panels, tpanel.cholesky_left_panels):
        _cuda.reset_launch_counts()
        L23 = fn(K23)
        torch.cuda.synchronize()
        c_ = _cuda.launch_counts()
        g23 = gate(L23, plain23, ref23)
        check(c_["panel_factor"] == n23 // 256 and g23["ok"] and bool(torch.all(torch.triu(L23, 1) == 0)),
              f"{fn.__name__}: launches {c_['panel_factor']}, {g23}")
        print(f"  {fn.__name__}: {c_['panel_factor']} K15 launches; rel err vs f64 {g23['err']:.3g} "
              f"(torch.linalg.cholesky f32 {g23['plain_f32_err']:.3g})")
        counts22.append(c_)
    del L23, ref23, plain23
    for c in counts22:
        for name, v in c.items():
            counts[name] += v
    check(all(counts[k] > 0 for k in ("panel_factor", "rank_update_tiles", "panel_inplace", "zero_upper")),
          "a kernel of the in-place or panel paths was never launched")
    torch.cuda.empty_cache()

    # --------------------------------------------------------------- 24 ----
    # per n=16384 factorization (the bench K): each K16-K18 call of the
    # schedule timed alone by CUDA events, in walks with the kernels, their
    # plain versions and the library calls (K16: one torch.baddbmm over the
    # list's tiles, gathered beforehand; K17: cholesky_ex + solve_triangular of
    # the panel; K18: Tensor.tril_), each walk on a fresh copy, in turns; the
    # K16 and K17 kernels' and their library calls' launches queued behind a
    # device sleep, so that a short call is not timed by the host's enqueue
    K24 = gaussian64(Xb, Xb, 8.0, 1.0)
    K24.diagonal().add_(sig * sig)

    def library_update(S, rows, cols, kcols, bm):
        ri, ci = rows.tolist(), cols.tolist()
        k0_, k1_ = int(kcols[0]) * bm, (int(kcols[-1]) + 1) * bm
        src = S[:, k0_:k1_]
        A_ = torch.stack([src[i * bm:(i + 1) * bm] for i in ri])
        B_ = torch.stack([src[j * bm:(j + 1) * bm] for j in ci])
        C_ = torch.stack([S[i * bm:(i + 1) * bm, j * bm:(j + 1) * bm] for i, j in zip(ri, ci)])
        t_ = timed(lambda: C_.baddbmm_(A_, B_.mT, alpha=-1), True)
        for t, (i, j) in enumerate(zip(ri, ci)):
            S[i * bm:(i + 1) * bm, j * bm:(j + 1) * bm] = C_[t]
        return t_

    def library_panel(S, c):
        c0_, e_ = c * 256, (c + 1) * 256
        low = torch.tril(S[c0_:e_, c0_:e_])
        D_ = low + torch.tril(low, -1).mT
        R_ = S[e_:, c0_:e_]
        box = []
        t_ = timed(lambda: box.append(torch.linalg.cholesky_ex(D_)[0]), True)
        S[c0_:e_, c0_:e_] = box[0]
        if e_ < S.shape[0]:
            t_ += timed(lambda: box.append(torch.linalg.solve_triangular(box[0].mT, R_, upper=True, left=False)),
                        True)
            S[e_:, c0_:e_] = box[1]
        return t_

    def inplace_walk(mode):
        S = K24.clone()
        tot = {"rank_update_tiles": 0.0, "panel_inplace": 0.0, "zero_upper": 0.0, "calls16": []}
        for st in tinp.schedule(n, 512, 256, dev):
            if st[0] == "panel":
                if mode == "library":
                    tot["panel_inplace"] += library_panel(S, st[1])
                else:
                    fn = tinp.panel_inplace if mode == "kernel" else tinp.panel_inplace_reference
                    tot["panel_inplace"] += timed(lambda: fn(S, st[1]), mode == "kernel")
            else:
                _, rows, cols, kcols, bm = st
                if mode == "library":
                    tot["rank_update_tiles"] += library_update(S, rows, cols, kcols, bm)
                elif mode == "kernel":  # as cholesky_inplace launches it, on the cached lists
                    t16 = timed(lambda: tinp._rank_update_tiles(S, rows, cols, kcols, bm, bm), True)
                    tot["rank_update_tiles"] += t16
                    tot["calls16"].append(t16)
                else:
                    tot["rank_update_tiles"] += timed(
                        lambda: tinp.rank_update_reference(S, rows, cols, kcols, bm=bm, bk=bm))
        zu = tinp.zero_upper_inplace if mode == "kernel" else torch.Tensor.tril_
        tot["zero_upper"] = timed(lambda: zu(S))
        check(bool(torch.isfinite(S[-1, -1])), f"timed in-place walk ({mode}) failed")
        return tot

    walks = {m: [] for m in ("kernel", "plain", "library")}
    for order in (("kernel", "plain", "library"), ("library", "plain", "kernel")):
        for m in order:
            walks[m].append(inplace_walk(m))
            torch.cuda.empty_cache()
    for name in ("rank_update_tiles", "panel_inplace", "zero_upper"):
        kstats[name].update({f"{m}_ms" if m != "kernel" else "ms": float(np.median([w[name] for w in walks[m]]))
                             for m in walks})
    # bounds: K16 2 bm^2 (ks bk) FLOP a target tile, its tiles read and
    # written, the source rows read once; K17 b^3/3 + rows b^2 FLOP, the panel
    # read and written; K18 the strict upper written, n(n-1)/2 floats (masking
    # a diagonal tile needs no read of it)
    parts16, parts17 = [], []
    for st in tinp.schedule(n, 512, 256, dev):
        if st[0] == "panel":
            rows_ = n - st[1] * 256
            parts17.append((256 ** 3 / 3.0 + (rows_ - 256) * 256.0 ** 2, 2 * 4.0 * rows_ * 256))
        else:
            _, rows, cols, kcols, bm = st
            T_, ks_ = rows.numel(), kcols.numel()
            src_rows = len(set(rows.tolist()) | set(cols.tolist())) * bm
            parts16.append((2.0 * T_ * bm * bm * ks_ * bm, 4.0 * (2 * T_ * bm * bm + src_rows * ks_ * bm)))
    # K16 computes on the 3xTF32 tier, as K2 and K5; its FP32 bound stands beside it
    kstats["rank_update_tiles"].update(sum_bounds(parts16, tf32x3),
                                       bound_fp32_ms=sum_bounds(parts16)["bound_ms"])
    kstats["panel_inplace"].update(sum_bounds(parts17))
    kstats["zero_upper"].update(bound(0.0, 4.0 * n * (n - 1) / 2))
    torch.cuda.empty_cache()

    # K15 per cholesky_left_panels at n=8192: the 32 panels as the schedule
    # meets them, each timed with the kernel, the plain version and
    # cholesky_ex + solve_triangular in turns, summed; 5 walks queued behind a
    # device sleep (the kernel's time, the kernels line's ms), 3 with the
    # host's enqueue; then one walk of the kernel under torch.profiler, split
    # into its diagonal-tile kernel and its rows kernel
    L24 = torch.zeros_like(K23)
    parts15, panels15 = [], []
    for k in range(n23 // 256):
        j0 = k * 256
        P_ = K23[j0:, j0:j0 + 256]
        if k > 0:
            P_ = P_ - L24[j0:, :j0] @ L24[j0:j0 + 256, :j0].mT
        panels15.append(P_)
        L24[j0:, j0:j0 + 256] = tpanel.panel_factor(P_)
        rows_ = n23 - j0
        parts15.append((256 ** 3 / 3.0 + (rows_ - 256) * 256.0 ** 2, 2 * 4.0 * rows_ * 256))
    check(bool(torch.isfinite(L24[-1, -1])), "timed left-looking panels failed")

    def lib15(P_):
        Lk = torch.linalg.cholesky_ex(P_[:256])[0]
        return torch.linalg.solve_triangular(Lk.mT, P_[256:], upper=True, left=False)

    fns15 = {"kernel": tpanel.panel_factor, "plain": tpanel.panel_factor_reference, "library": lib15}
    t15s = {}
    for mode, walks15, queued in (("queued", 5, True), ("with the host's enqueue", 3, False)):
        runs15 = {m: [] for m in fns15}
        for w in range(walks15):
            for m in (list(fns15) if w % 2 == 0 else list(fns15)[::-1]):
                runs15[m].append(sum(timed(lambda: fns15[m](P_), queued) for P_ in panels15))
        t15s[mode] = {m: (float(np.median(v)), v) for m, v in runs15.items()}

    def device_split(fn):
        """Device time by kernel name (ms) and launches of fn's kernels, by
        torch.profiler."""
        with profile(activities=[ProfilerActivity.CUDA]) as prof_:
            fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof_.events():
            if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.end > e.time_range.start:
                key = e.name.split("(")[0].replace("void ", "").replace("gpr::", "")
                t_, c_ = out.get(key, (0.0, 0))
                out[key] = (t_ + (e.time_range.end - e.time_range.start) / 1e3, c_ + 1)
        return out

    split15 = device_split(lambda: [tpanel.panel_factor(P_) for P_ in panels15])
    check(set(split15) == {"panel_diag_cluster", "panel_factor_rows"}, f"K15's kernels: {split15}")
    t15 = t15s["queued"]
    kstats["panel_factor"].update(ms=t15["kernel"][0], plain_ms=t15["plain"][0], library_ms=t15["library"][0],
                                  **sum_bounds(parts15))
    del panels15
    panels24 = rotate({"cholesky_left_panels": lambda: tpanel.cholesky_left_panels(K23),
                       "cholesky_panels": lambda: tpanel.cholesky_panels(K23),
                       "torch.linalg.cholesky": lambda: torch.linalg.cholesky(K23)}, 4)
    del K23, L24
    torch.cuda.empty_cache()
    # K17's split: its kernels are K15's before this redesign (a 256 diagonal
    # tile walked by one block, then 64-row strips), on the in-place schedule
    split17 = device_split(lambda: tinp.cholesky_inplace(K24))
    fact24 = rotate({"inplace": lambda: tinp.cholesky_inplace(K24),
                     "blocked-syrk": lambda: blocked.cholesky_blocked(K24, leaf_inverse=False),
                     "fused-matrix": lambda: fullchol.cholesky_fused(K24),
                     "torch.linalg.cholesky": lambda: torch.linalg.cholesky(K24)}, 4)
    del K24
    torch.cuda.empty_cache()
    fit24 = rotate({"inplace": lambda: with_env(inplace_env, lambda: tg.fit(bench_k, Xb, Yb, sigma=0.1,
                                                                            use_pallas_gram=True)),
                    "default": lambda: tg.fit(bench_k, Xb, Yb, sigma=0.1, use_pallas_gram=True)}, 4)
    mll24 = rotate({"inplace": lambda: with_env(inplace_env, lambda: lk.mll_value_and_grad(bench_k, Xb, Yb, 0.1)),
                    "default": lambda: lk.mll_value_and_grad(bench_k, Xb, Yb, 0.1)}, 4)
    print(f"phase 24 in-place and panel timings ({smi}), CUDA events, medians:")
    for label, name in (("K16 rank_update_tiles (63 calls)", "rank_update_tiles"),
                        ("K17 panel_inplace (64 calls)", "panel_inplace"), ("K18 zero_upper (1 call)", "zero_upper")):
        s_ = kstats[name]
        print(f"  {label} per n=16384 factorization: kernel {s_['ms']:.4f} ms (runs "
              f"{runs_text([w[name] for w in walks['kernel']])}); plain {s_['plain_ms']:.4f}; library "
              f"{s_['library_ms']:.4f}; bound {s_['bound_ms']:.4f} ms ({s_['bound_by']})")
    # the ten K16 calls that take the most time (median of the kernel walks),
    # with their grids: how much of K16 the calls that leave SMs idle take
    sms24 = torch.cuda.get_device_properties(dev).multi_processor_count
    upd24 = [st for st in tinp.schedule(n, 512, 256, dev) if st[0] == "update"]
    per16 = np.median([w["calls16"] for w in walks["kernel"]], axis=0)
    grid16 = [st[1].numel() * (st[4] // 128) ** 2 for st in upd24]
    small16 = sum(t for t, g in zip(per16, grid16) if g < sms24)
    print(f"  K16 per call, the ten slowest of {len(upd24)} (call: bm, tiles of 128, ms): " + "; ".join(
        f"#{c}: {upd24[c][4]}, {grid16[c]}, {per16[c]:.4f}" for c in np.argsort(per16)[::-1][:10])
        + f"; calls with fewer tiles than the {sms24} SMs: {sum(g < sms24 for g in grid16)} calls, "
        f"{small16:.4f} ms of {float(per16.sum()):.4f}")
    print(f"  K16 bound at the FP32 tier: {kstats['rank_update_tiles']['bound_fp32_ms']:.4f} ms")
    s_ = kstats["panel_factor"]
    for mode, t_ in t15s.items():
        print(f"  K15 panel_factor per cholesky_left_panels at n=8192 (32 calls, {mode}): " + "; ".join(
            f"{k} {m:.4f} ms (runs {runs_text(r)})" for k, (m, r) in t_.items())
            + f"; library / kernel {t_['library'][0] / t_['kernel'][0]:.2f}x")
    print(f"  K15 bound {s_['bound_ms']:.4f} ms ({s_['bound_by']}); device split of one walk (torch.profiler): "
          + "; ".join(f"{k} {t:.4f} ms ({c} launches)" for k, (t, c) in sorted(split15.items())))
    print("  K17 device split per n=16384 in-place factorization (K15's cluster diagonal kernel on the lower "
          "triangle, in place, and its rows kernel): " + "; ".join(
              f"{k} {t:.4f} ms ({c} launches)" for k, (t, c) in sorted(split17.items())
              if k.startswith("panel_inplace")))
    print("  factorization n=8192 (bench K): " + "; ".join(
        f"{k} {m:.2f} ms (runs {runs_text(r)})" for k, (m, r) in panels24.items()))
    print("  factorization n=16384 (bench K): " + "; ".join(
        f"{k} {m:.2f} ms (runs {runs_text(r)})" for k, (m, r) in fact24.items()))
    print("  fit n=16384 d=128 q=8 (use_pallas_gram; inplace: gram-kernel -> inplace; default: fused-gram): "
          + "; ".join(f"{k} {m:.2f} ms (runs {runs_text(r)})" for k, (m, r) in fit24.items()))
    print("  MLL value + gradient n=16384 (inplace; default: fused-matrix): " + "; ".join(
        f"{k} {m:.2f} ms (runs {runs_text(r)})" for k, (m, r) in mll24.items()))

    # --------------------------------------------------------------- 25 ----
    # K19 tile_chol and K20 tile_chol_strips against their plain versions at n
    # = 1, 32, 64, 128, 200 (K19 only, unaligned), 256 and 512, K20 at sw 8 and
    # 16: 1e-5 of the plain factor's largest entry (the gate tests/test_ops.py:
    # 318 puts on JAX's kernel; float32 sums in another order) and ||L L^T - A||
    # / ||A|| < 1e-5 (Frobenius, in float64 on the float32 factor).  NaN below
    # the diagonal leaves both factors bit-identical (only the upper triangle
    # is read); the strict upper is exactly 0; a failed pivot poisons the rows
    # from it on; n % sw raises.  Then this slice's path, the leaf dispatcher.
    print("phase 25 K19 tile_chol and K20 tile_chol_strips against their plain versions; the leaf dispatcher")
    g25 = torch.Generator(device=dev).manual_seed(25)

    def spd25(n_):
        G = torch.randn((n_, n_), generator=g25, device=dev)
        A_ = G @ G.T / n_
        A_.diagonal().add_(1.0)
        return A_

    def recon(L_, A_):
        L_, A_ = L_.double(), A_.double()
        return float(torch.linalg.norm(L_ @ L_.mT - A_) / torch.linalg.norm(A_))

    def tile_runs(n_):
        runs_ = [("tile_chol", tchol.cholesky_tile, tchol.cholesky_tile_reference)]
        for sw_ in (8, 16):
            if n_ % sw_ == 0 and n_ != 200:
                runs_.append((f"tile_chol_strips sw={sw_}",
                              lambda M, sw_=sw_: tchol.cholesky_tile_v2(M, sw=sw_),
                              lambda M, sw_=sw_: tchol.cholesky_tile_v2_reference(M, sw=sw_)))
        return runs_

    worst25 = {}
    for n_ in (1, 32, 64, 128, 200, 256, 512):
        A_ = spd25(n_)
        A_nan = torch.triu(A_) + torch.tril(torch.full_like(A_, nan), -1)
        for label, fn, ref in tile_runs(n_):
            L_, Lr = fn(A_), ref(A_)
            e_, rc_ = relerr(L_, Lr), recon(L_, A_)
            check(torch.equal(fn(A_nan), L_), f"{label} n={n_}: NaN below the diagonal changed the factor")
            check(bool(torch.all(torch.triu(L_, 1) == 0)), f"{label} n={n_}: strict upper not 0")
            check(e_ <= 1e-5 and rc_ < 1e-5, f"{label} n={n_}: rel err vs plain {e_}, reconstruction {rc_}")
            worst25[(label, n_)] = (e_, rc_)
            if n_ == 512:
                name = label.split()[0]
                err_ = float((L_ - Lr).abs().max())
                kstats[name] = {"max_abs_err": max(err_, kstats.get(name, {}).get("max_abs_err", 0.0))}
    A_ = spd25(256)
    A_[100, 100] = -1.0
    for label, fn, _ in tile_runs(256):
        L_ = fn(A_)
        rows_ok = torch.isfinite(L_).all(dim=1)
        check(bool(rows_ok[:100].all()) and not bool(rows_ok[100:].any()) and bool(torch.isnan(L_[-1, -1]))
              and bool(torch.all(torch.triu(L_, 1) == 0)), f"{label}: a failed pivot at 100 is not poisoned")
    for n_, sw_ in ((200, 16), (100, 8)):
        try:
            tchol.cholesky_tile_v2(spd25(n_), sw=sw_)
        except ValueError:
            pass
        else:
            check(False, f"cholesky_tile_v2 n={n_} sw={sw_} did not raise")
    for (label, n_), (e_, rc_) in worst25.items():
        print(f"  {label} n={n_}: rel err vs plain {e_:.3g}, ||LL^T - A|| / ||A|| {rc_:.3g}; NaN lower "
              "bit-identical; strict upper 0")
    print("  a failed pivot at 100 (n=256): rows 0-99 finite, 100-255 not, L[-1,-1] NaN ok; n % sw raises ok")

    # the dispatcher (pallas_chol.py:72-76): K19 for a CUDA float32 tile with n <= 512
    A512, A513 = spd25(512), spd25(513)
    _cuda.reset_launch_counts()
    L512 = tchol.leaf_cholesky(A512)
    torch.cuda.synchronize()
    c25 = _cuda.launch_counts()
    check(c25["tile_chol"] == 1 and sum(c25.values()) == 1, f"leaf_cholesky n=512 float32 launches {c25}")
    check(relerr(L512, tchol.cholesky_tile_reference(A512)) <= 1e-5 and recon(L512, A512) < 1e-5,
          "leaf_cholesky n=512 float32")
    for name, v in c25.items():
        counts[name] += v
    _cuda.reset_launch_counts()
    for label, M in (("n=513", A513), ("float64", A512.double()), ("CPU", A512.cpu())):
        L_ = tchol.leaf_cholesky(M)
        check(recon(L_, M) < 1e-5, f"leaf_cholesky {label}: reconstruction {recon(L_, M)}")
    torch.cuda.synchronize()
    c_ = _cuda.launch_counts()
    check(sum(c_.values()) == 0, f"leaf_cholesky launched {c_} at n=513, on float64 or on the CPU")
    check(counts["tile_chol"] > 0, "K19 was never launched on the dispatcher's path")
    print(f"  leaf_cholesky: n=512 float32 -> {c25['tile_chol']} K19 launch; n=513, float64, CPU -> "
          "torch.linalg.cholesky_ex of (A + A^T) / 2, no launch ok")
    del A_, A_nan, A512, A513, L512

    # --------------------------------------------------------------- 26 ----
    # K19 and K20 (sw 8 and 16) at n=256 (the leaf pallas_chol.py's docstring
    # measures) and n=512 (the dispatcher's cap), each in turns with its plain
    # version and torch.linalg.cholesky_ex on the same symmetric tile, median
    # of 10: once with every call queued behind a device sleep (the kernel's
    # time, the kernels line's ms) and once with the host's enqueue (the
    # wrapper's checks, its allocation of L and the ctypes launch).
    # Bound: n^3 / 3 FLOP at 67 TFLOP/s against the upper triangle read and L
    # written, 4 (n (n + 1) / 2 + n^2) bytes, at 3.35 TB/s.
    t26 = {}
    for n_ in (256, 512):
        A_ = spd25(n_)
        fns26 = {"K19": lambda: tchol.cholesky_tile(A_),
                 "K19 plain": lambda: tchol.cholesky_tile_reference(A_),
                 "K20 sw=8": lambda: tchol.cholesky_tile_v2(A_, sw=8),
                 "K20 sw=8 plain": lambda: tchol.cholesky_tile_v2_reference(A_, sw=8),
                 "K20 sw=16": lambda: tchol.cholesky_tile_v2(A_, sw=16),
                 "K20 sw=16 plain": lambda: tchol.cholesky_tile_v2_reference(A_, sw=16),
                 "cholesky_ex": lambda: torch.linalg.cholesky_ex(A_)}
        t26[(n_, "queued")] = rotate(fns26, 10, queued=True)
        t26[(n_, "with the host's enqueue")] = rotate(fns26, 10)
    bounds26 = {n_: bound(n_ ** 3 / 3.0, 4.0 * (n_ * (n_ + 1) / 2 + n_ * n_)) for n_ in (256, 512)}
    for name, key in (("tile_chol", "K19"), ("tile_chol_strips", "K20 sw=8")):
        q26 = t26[(512, "queued")]
        kstats[name].update(ms=q26[key][0], plain_ms=q26[f"{key} plain"][0],
                            library_ms=q26["cholesky_ex"][0], **bounds26[512])
    del A_
    print(f"phase 26 single-tile timings ({smi}), CUDA events, medians of 10:")
    for (n_, mode), res in t26.items():
        print(f"  n={n_} {mode} (bound {bounds26[n_]['bound_ms']:.6f} ms, {bounds26[n_]['bound_by']}): "
              + "; ".join(f"{k} {m:.4f} ms (runs {runs_text(r)})" for k, (m, r) in res.items()))
        print("    cholesky_ex / kernel: " + "; ".join(
            f"{k} {res['cholesky_ex'][0] / res[k][0]:.2f}x" for k in ("K19", "K20 sw=8", "K20 sw=16")))

    # --------------------------------------------------------------- 27 ----
    # the samplers (inference/hmc.py, nuts.py, advi.py, predictive.py) on
    # bench_hmc's posterior (benchmarks/bench_hmc.py:24-58): Gaussian(1, 1),
    # sigma 0.1, X = linspace(0, 10), Y = sin(X) + 0.1 N(0, 1) (seed 0), d=1,
    # q=1, float32.  The chains are one fleet of GPs that share X and Y (route
    # fleet-crout: K7 once per 128-panel of every leapfrog step's
    # factorization); each path is driven with the counts set to 0 just
    # before it and read just after
    from gpr_tpu_torch.inference import advi as tadvi
    from gpr_tpu_torch.inference import hmc as thmc
    from gpr_tpu_torch.inference import nuts as tnuts
    from gpr_tpu_torch.inference import predictive as tpred

    t27 = time.perf_counter()
    sampler_counts = []

    def bench_hmc_data(n_):
        r_ = np.random.default_rng(0)
        x_ = np.linspace(0, 10, n_)
        return t32(x_[:, None]), t32((np.sin(x_) + 0.1 * r_.standard_normal(n_))[:, None])

    def value_grad(logp, z):
        zz = z.detach().clone().requires_grad_()
        with torch.enable_grad():
            v = logp(zz)
            (g,) = torch.autograd.grad(v.sum(), zz)
        return v.detach(), g

    def plain_logp(z, X, Y, sigma):
        """Value and gradient of the straightforward log posterior, one chain
        at a time, in the dtype of X: torch Gram, torch.linalg.cholesky,
        cholesky_solve, autograd; the same terms as make_gp_log_posterior."""
        n_ = X.shape[0]
        vals, grads = [], []
        for zc in z.to(X.dtype):
            zz = zc.detach().clone().requires_grad_()
            with torch.enable_grad():
                th_ = torch.exp(zz)
                K = gaussian64(X, X, th_[0], th_[1])
                K = K + sigma * sigma * torch.eye(n_, dtype=X.dtype, device=X.device)
                L = torch.linalg.cholesky(K)
                alpha = torch.cholesky_solve(Y, L)
                v = (-0.5 * (Y * alpha).sum() - torch.log(torch.diagonal(L)).sum()
                     - n_ / 2.0 * math.log(2 * math.pi) + zz.sum())
                (g,) = torch.autograd.grad(v, zz)
            vals.append(v.detach())
            grads.append(g)
        return torch.stack(vals), torch.stack(grads)

    def trace_idle(fn):
        """fn under torch.profiler: (host wall ms, device kernel ms, idle share)."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_:
            t_w = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ = (time.perf_counter() - t_w) * 1e3
        busy_ = 0.0
        for e in prof_.key_averages():
            if "CUDA" in str(e.device_type):
                us = getattr(e, "self_device_time_total", None)
                busy_ += (e.self_cuda_time_total if us is None else us) / 1e3
        check(busy_ > 0, "the profiler saw no device time in a sampler transition")
        return wall_, busy_, 1.0 - busy_ / wall_

    nh, C = 512, 16
    Xh, Yh = bench_hmc_data(nh)
    k_h = tg.Gaussian(1.0, 1.0)
    print(f"phase 27 the samplers on bench_hmc's posterior: Gaussian(1, 1), sigma 0.1, n={nh} d=1 q=1, "
          "float32")

    # (a) the log posterior's value + gradient, 16 chains at z over [-1, 1]^2
    lp_h = thmc.make_gp_log_posterior(k_h, Xh, Yh, 0.1)
    check(lp_h.route == "fleet-crout", f"the log posterior took route {lp_h.route}")
    ga, gb = np.meshgrid(np.linspace(-1, 1, 4), np.linspace(-1, 1, 4), indexing="ij")
    z16 = t32(np.stack([ga.ravel(), gb.ravel()], 1))
    _cuda.reset_launch_counts()
    v_a, g_a = value_grad(lp_h, z16)
    torch.cuda.synchronize()
    c = _cuda.launch_counts()
    sampler_counts.append(c)
    check(c["crout_chol"] == nh // fbatched.PANEL and c["gram_batched"] == 0,
          f"log posterior launches {c}: one K7 per panel forward, none in the backward")
    v64a, g64a = plain_logp(z16.double(), Xh.double(), Yh.double(), 0.1)
    v32a, g32a = plain_logp(z16, Xh, Yh, 0.1)
    gates_a = {"value": gate(v_a, v32a, v64a), "gradient": gate(g_a, g32a, g64a)}
    print(f"  (a) value + gradient of 16 chains, route {lp_h.route}: rel err vs f64: "
          + "; ".join(f"{k} {r['err']:.3g} (plain f32 {r['plain_f32_err']:.3g})" for k, r in gates_a.items())
          + f"; launches {c}")
    check(all(r["ok"] for r in gates_a.values()), "log posterior: error above 3x the plain f32 route's")
    # one chain forced singular (sigma 0, a lengthscale 3 grid steps wide: K is
    # rank-deficient in float32) beside three near-diagonal ones: the safe
    # fleet factor retries it alone, with jitter, and leaves the others' factor
    # and solve as the first attempt gave them
    z_s = t32([[-4.5, 0.0], [-4.5, 0.3], [-2.8, 0.0], [-4.6, -0.2]])
    th_s = torch.exp(z_s)
    K_s = thmc._chain_grams(k_h, [th_s[:, 0], th_s[:, 1]], Xh, torch.zeros((), device=dev))
    Y_s = Yh.expand(4, nh, 1).contiguous()
    L_0, a_0, _ = fbatched._attempt("fleet-crout", K_s, Y_s, fbatched.PANEL)
    first_ok = torch.isfinite(L_0[:, -1, -1]).tolist()
    _cuda.reset_launch_counts()
    L_s, a_s, jit_s = fbatched.factor_solve_safe(K_s, Y_s, "fleet-crout")
    k7_s = _cuda.launch_counts()["crout_chol"]
    keep = [0, 1, 3]
    check(first_ok == [True, True, False, True], f"forced-singular chain: first attempt ok {first_ok}")
    check(float(jit_s[2]) > 0 and bool((jit_s[keep] == 0).all()), f"jitter {jit_s.tolist()}")
    check(torch.equal(L_s[keep], L_0[keep]) and torch.equal(a_s[keep], a_0[keep]),
          "the chains that factored at once changed in the retry")
    v_s = thmc.make_gp_log_posterior(k_h, Xh, Yh, 0.0)(z_s)
    print(f"  (a) forced-singular chain (sigma 0, lengthscale {float(th_s[2, 0]):.4f}): retried alone with "
          f"jitter {float(jit_s[2]):.3g} ({(k7_s - nh // fbatched.PANEL) // (nh // fbatched.PANEL)} retries, "
          f"{k7_s} K7 launches), factor finite {bool(torch.isfinite(L_s[2, -1, -1]))}; the other three bit "
          f"for bit the first attempt's; log posterior {[round(float(v), 2) for v in v_s]}")
    del K_s, L_0, a_0, L_s, a_s

    # (b) sample_hmc: 16 chains, L = 16, warmup 128, 64 draws
    cfg_b = thmc.HMCConfig(num_warmup=128, num_samples=64, num_leapfrog=16)
    z0h = torch.zeros((C, 2), device=dev)
    _cuda.reset_launch_counts()
    t_b = time.perf_counter()
    res_b = tg.sample_hmc(lp_h, z0h, torch.Generator(dev).manual_seed(0), cfg_b)
    torch.cuda.synchronize()
    t_b = time.perf_counter() - t_b
    c = _cuda.launch_counts()
    sampler_counts.append(c)
    acc_b = float(res_b.accept_rate.mean())
    check(c["crout_chol"] > 0 and c["crout_chol"] % (nh // fbatched.PANEL) == 0, f"sample_hmc launches {c}")
    check(bool(torch.isfinite(res_b.samples).all()) and res_b.samples.shape == (C, 64, 2),
          "sample_hmc draws")
    check(0.5 < acc_b <= 1.0, f"sample_hmc mean accept rate {acc_b}")
    lp_t = thmc.make_gp_log_posterior(k_h, Xh, Yh, 0.1, use_crout=False)
    t_t = time.perf_counter()
    res_t = tg.sample_hmc(lp_t, z0h, torch.Generator(dev).manual_seed(0), cfg_b)
    torch.cuda.synchronize()
    t_t = time.perf_counter() - t_t
    mean_b, mean_t = res_b.samples.mean((0, 1)).double(), res_t.samples.mean((0, 1)).double()
    sd_b = res_b.samples.reshape(-1, 2).double().std(0)
    mcse = torch.sqrt(sd_b ** 2 / thmc.effective_sample_size(res_b.samples.double())
                      + res_t.samples.reshape(-1, 2).double().std(0) ** 2
                      / thmc.effective_sample_size(res_t.samples.double()))
    diff_b = (mean_b - mean_t).abs()
    print(f"  (b) sample_hmc 16 chains, L=16, warmup 128, 64 draws: {t_b:.2f} s (route {lp_h.route}; "
          f"use_crout=False {t_t:.2f} s), accept {acc_b:.3f}, step size {float(res_b.step_size):.4g}, "
          f"posterior mean z {mean_b.tolist()} vs use_crout=False {mean_t.tolist()}: |diff| "
          f"{diff_b.tolist()} <= 4 MCSE {(4 * mcse).tolist()}; launches {c}")
    check(bool((diff_b <= 4 * mcse).all()), "sample_hmc: the fleet route's posterior mean left 4 MCSE")
    # the sampling stage alone: resume_hmc from (b)'s checkpoint, 16 draws
    os.makedirs("chip_smoke_out", exist_ok=True)
    thmc.save_chain_checkpoint("chip_smoke_out/hmc_chains", res_b)
    evals = [0]

    def lp_counted(z):
        evals[0] += 1
        return lp_h(z)

    torch.cuda.synchronize()
    t_s = time.perf_counter()
    res_r = thmc.resume_hmc(lp_counted, "chip_smoke_out/hmc_chains.npz",
                            torch.Generator(dev).manual_seed(1), 16, cfg_b, device=dev)
    torch.cuda.synchronize()
    t_s = time.perf_counter() - t_s
    check(bool(torch.isfinite(res_r.samples).all()), "resume_hmc draws")
    hmc_rate, lf_rate = C * 16 / t_s, evals[0] / t_s
    print(f"  HMC samples/s (16 chains x 16 draws / sampling stage {t_s:.3f} s): {hmc_rate:.1f} ({smi})")
    print(f"  leapfrog evaluations/s (one fleet value + gradient of 16 chains each, {evals[0]} in the "
          f"stage): {lf_rate:.1f} ({smi})")

    # (c) sample_nuts: 8 chains at n=256, warmup 128, 32 draws, max_depth 6
    Xn, Yn = bench_hmc_data(256)
    lp_n = thmc.make_gp_log_posterior(k_h, Xn, Yn, 0.1)
    check(lp_n.route == "fleet-crout", f"NUTS posterior route {lp_n.route}")
    cfg_c = tnuts.NUTSConfig(num_warmup=128, num_samples=32, max_depth=6)
    _cuda.reset_launch_counts()
    t_c = time.perf_counter()
    res_c = tg.sample_nuts(lp_n, torch.zeros((8, 2), device=dev), torch.Generator(dev).manual_seed(0),
                           cfg_c)
    torch.cuda.synchronize()
    t_c = time.perf_counter() - t_c
    c = _cuda.launch_counts()
    sampler_counts.append(c)
    acc_c = float(res_c.accept_rate.mean())
    check(c["crout_chol"] > 0 and bool(torch.isfinite(res_c.samples).all()), f"sample_nuts {c}")
    check(0.5 < acc_c <= 1.0, f"sample_nuts mean accept statistic {acc_c}")
    mean_c = res_c.samples.mean((0, 1)).double()
    print(f"  (c) sample_nuts 8 chains n=256, warmup 128, 32 draws, max_depth 6: {t_c:.2f} s, accept "
          f"{acc_c:.3f}, step size {float(res_c.step_size):.4g}, posterior mean z {mean_c.tolist()}; "
          f"launches {c}")
    nuts_rates = {}
    vg_n = thmc._value_and_grad(lp_n)
    for D in (4, 6, 8):
        cfg_d = tnuts.NUTSConfig(max_depth=D)
        st = thmc.init_chains(lp_n, res_c.samples[:, -1].contiguous())
        gen_d = torch.Generator(dev).manual_seed(D)

        def nuts_step(s, g_, e_, im_, cfg_d=cfg_d):
            return tnuts._nuts_transition(vg_n, s, g_, e_, im_, cfg_d)

        torch.cuda.synchronize()
        t_d = time.perf_counter()
        _, zs_d, _ = thmc._sample_loop(nuts_step, st, gen_d, res_c.step_size, res_c.inv_mass, 8)
        torch.cuda.synchronize()
        t_d = time.perf_counter() - t_d
        check(bool(torch.isfinite(zs_d).all()), f"NUTS draws at max_depth {D}")
        nuts_rates[D] = 8 * 8 / t_d
        print(f"  NUTS draws/s at max_depth {D} (8 chains x 8 draws, sampling stage {t_d:.3f} s, (c)'s "
              f"step size and mass): {nuts_rates[D]:.1f} ({smi})")

    # (d) predictive_from_hmc: 32 draws of (b), 1024 test points
    Xs_d = t32(np.linspace(0, 10, 1024)[:, None])
    theta_d = tpred.subsample_draws(res_b.samples, 32)
    m64d, v64d = plain_mixture(Xh.double(), Yh.double(), Xs_d.double(), theta_d.double(), 0.1)
    m32d, v32d = plain_mixture(Xh, Yh, Xs_d, theta_d, 0.1)

    def predictive_gates(name):
        _cuda.reset_launch_counts()
        pr_ = tpred.predictive_from_hmc(k_h, res_b, Xh, Yh, Xs_d, 0.1, num_draws=32)
        torch.cuda.synchronize()
        c_ = _cuda.launch_counts()
        check(pr_.mean.shape == (1024, 1) and pr_.variance.shape == (1024,)
              and bool(torch.isfinite(pr_.mean).all() and torch.isfinite(pr_.variance).all()),
              f"{name}: shapes or non-finite")
        gates_ = {"mean": gate(pr_.mean, m32d, m64d), "variance": gate(pr_.variance, v32d, v64d)}
        print(f"  {name}: rel err vs f64: " + "; ".join(
            f"{k} {r['err']:.3g} (plain f32 {r['plain_f32_err']:.3g})" for k, r in gates_.items())
            + f"; launches {c_}")
        check(all(r["ok"] for r in gates_.values()), f"{name}: error above 3x the plain f32 route's")
        return c_

    c = predictive_gates("(d) predictive_from_hmc, 32 draws of (b), 1024 test points, route fleet-crout")
    sampler_counts.append(c)
    check(c["gram_batched"] == 1 and c["crout_chol"] == nh // fbatched.PANEL,
          "the predictive's fit: one K6 launch, one K7 per panel")
    pred_ms = median_ms(lambda: tpred.predictive_from_hmc(k_h, res_b, Xh, Yh, Xs_d, 0.1, num_draws=32), 5)
    print(f"  predictive_from_hmc latency (32 draws, n={nh}, 1024 test points), median of 5: "
          f"{pred_ms:.3f} ms ({smi})")

    # (e) fit_advi: 200 steps, 8 samples a step
    stamps = []  # the host clock at each step's log-posterior call

    def lp_stamped(z):
        stamps.append(time.perf_counter())
        return lp_h(z)

    _cuda.reset_launch_counts()
    t_e = t_e0 = time.perf_counter()
    res_e = tadvi.fit_advi(lp_stamped, torch.zeros(2, device=dev), torch.Generator(dev).manual_seed(0),
                           num_steps=200, num_samples=8)
    torch.cuda.synchronize()
    t_e = time.perf_counter() - t_e
    c = _cuda.launch_counts()
    step_ms = np.diff(stamps) * 1e3
    sampler_counts.append(c)
    tr_e = res_e.elbo_trace
    sd_post = res_b.samples.reshape(-1, 2).double().std(0)
    off_e = (res_e.mean.double() - mean_b).abs()
    print(f"  (e) fit_advi 200 steps x 8 samples: {t_e:.2f} s (steps: median {float(np.median(step_ms)):.2f} ms, "
          f"mean {float(step_ms.mean()):.2f}, longest {float(step_ms.max()):.2f}, the first call's "
          f"{(stamps[0] - t_e0) * 1e3:.2f} ms before its first step), ELBO first 20 {float(tr_e[:20].mean()):.3f} "
          f"-> last 20 {float(tr_e[-20:].mean()):.3f}, mean {res_e.mean.tolist()} std {res_e.std.tolist()}; "
          f"|mean - (b)'s| {off_e.tolist()} <= 3 sd {(3 * sd_post).tolist()}; launches {c}")
    check(bool(torch.isfinite(tr_e).all()) and float(tr_e[-20:].mean()) > float(tr_e[:20].mean()),
          "fit_advi: ELBO not finite or not climbing")
    check(bool((off_e <= 3 * sd_post).all()), "fit_advi: mean beyond 3 posterior sd of (b)'s")
    check(c["crout_chol"] == 200 * nh // fbatched.PANEL, f"fit_advi launches {c}")

    # (f) the fused fleet (as phase 12 turns it on): (a)'s value + gradient and (d)
    saved_max_n = fbatched._FLEET_FUSED_MAX_N
    fbatched._FLEET_FUSED_MAX_N = 1024
    try:
        lp_f = thmc.make_gp_log_posterior(k_h, Xh, Yh, 0.1)
        check(lp_f.route == "fleet-fused", f"fused log posterior took route {lp_f.route}")
        _cuda.reset_launch_counts()
        v_f, g_f = value_grad(lp_f, z16)
        torch.cuda.synchronize()
        c = _cuda.launch_counts()
        sampler_counts.append(c)
        gates_f = {"value": gate(v_f, v32a, v64a), "gradient": gate(g_f, g32a, g64a)}
        print(f"  (f) fused value + gradient, route {lp_f.route}: rel err vs f64: "
              + "; ".join(f"{k} {r['err']:.3g} (plain f32 {r['plain_f32_err']:.3g})"
                          for k, r in gates_f.items()) + f"; launches {c}")
        check(all(r["ok"] for r in gates_f.values()), "fused log posterior: error above 3x plain f32")
        check(c["fleet_fused"] == 1 and c["crout_chol_wi"] == 1 and c["crout_chol"] == 0,
              "fused value + gradient: one K9 forward, one K8 in the backward, no K7")
        c = predictive_gates("(f) fused predictive_from_hmc, route fleet-fused")
        sampler_counts.append(c)
        check(c["gram_batched"] == 1 and c["fleet_fused"] == 1 and c["crout_chol"] == 0,
              "fused predictive: one K6 and one K9 launch")
    finally:
        fbatched._FLEET_FUSED_MAX_N = saved_max_n
    for c in sampler_counts:
        for name, v in c.items():
            counts[name] += v

    # where a transition's time goes: one HMC transition (16 chains, 16 fixed
    # leapfrog steps) and one NUTS transition (8 chains, max_depth 6) traced
    vg_h = thmc._value_and_grad(lp_h)
    st_h = thmc.init_chains(lp_h, res_b.samples[:, -1].contiguous())
    cfg_fixed = thmc.HMCConfig(num_leapfrog=16, jitter_steps=False)
    gen_h = torch.Generator(dev).manual_seed(3)
    thmc._hmc_transition(vg_h, st_h, gen_h, res_b.step_size, res_b.inv_mass, cfg_fixed)  # warm-up
    idle_h = trace_idle(lambda: thmc._hmc_transition(vg_h, st_h, gen_h, res_b.step_size, res_b.inv_mass,
                                                     cfg_fixed))
    st_n = thmc.init_chains(lp_n, res_c.samples[:, -1].contiguous())
    leaves = [0]

    def vg_counted(z):
        leaves[0] += 1
        return vg_n(z)

    idle_n = trace_idle(lambda: tnuts._nuts_transition(vg_counted, st_n, torch.Generator(dev).manual_seed(4),
                                                       res_c.step_size, res_c.inv_mass, cfg_c))
    print(f"  idle share, one HMC transition (16 chains, 16 leapfrog steps, torch.profiler on): host "
          f"{idle_h[0]:.2f} ms, device kernels {idle_h[1]:.3f} ms, idle {100 * idle_h[2]:.1f} % ({smi})")
    print(f"  idle share, one NUTS transition (8 chains, max_depth 6, {leaves[0]} leaves, torch.profiler "
          f"on): host {idle_n[0]:.2f} ms, device kernels {idle_n[1]:.3f} ms, idle {100 * idle_n[2]:.1f} % "
          f"({smi})")
    print(f"  phase 27 wall time {time.perf_counter() - t27:.1f} s")

    # --------------------------------------------------------------- 28 ----
    for c in phase_28(dev, smi, t32):
        for name, v in c.items():
            counts[name] += v

    # --------------------------------------------------------------- 29 ----
    for c in phase_29(dev, smi, t32):
        for name, v in c.items():
            counts[name] += v

    # --------------------------------------------------------------- 30 ----
    for c in phase_30(dev, smi, t32):
        for name, v in c.items():
            counts[name] += v

    print(f"wall time: {time.perf_counter() - t_start:.1f} s")

    kernels = []
    for k in _cuda.KERNELS:
        kernels.append({
            "name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
            "launches": counts[k.name], **kstats[k.name],
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase30-rank"]:
        sys.exit(phase_30_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    sys.exit(main())
