"""A linear AR(p) model over batched feature time series.

Mirrors gpr_tpu/pipeline/autoregression.py:36-169, the reference's
``AutoRegression<T>`` (include/AutoRegression.h:20-205):

  * the series is X (T, F): rows are time steps, columns independent
    feature channels, in contiguous batches (ultrasound sweeps) given as
    (size, repetition) pairs;
  * per batch of length B the zero-padded delay embedding D (B-1, p) has
    D[t, k] = X[t-k] for t >= k and 0 otherwise, with targets X[t+1]
    (reference ComputeSubmatrix, AutoRegression.h:189-199);
  * theta (p, F) is each feature's least-squares solution (AutoRegression.h:
    106);
  * an n-step rollout shifts each prediction into the design (AutoRegression.h:
    166-173);
  * ``one_prediction_per_batch`` keeps the last row of each batch, with the
    reference's stride of the first batch's size even for batches of other
    sizes (AutoRegression.h:176-183);
  * one MatrixIO file holds theta (AutoRegression.h:36-44).

JAX solves each feature by ``jnp.linalg.lstsq`` under ``vmap``: a thin SVD
with singular values below eps * max(K, p) * s_max (and exact zeros) cut,
the minimum-norm solution.  The zero-padded embedding makes rank-deficient
designs for short batches, and ``torch.linalg.lstsq`` on the card offers
only ``gels``, which assumes full rank; so :func:`fit_ar` takes one batched
``torch.linalg.svd`` over the features with JAX's cutoff.  The functions
take the dtype of their inputs and run on the card unless given
``device="cpu"`` or CPU tensors (utils/config.py).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..utils import config, matrixio

BatchSpec = Sequence[Tuple[int, int]]  # [(batch_size, repetitions), ...]


def default_batches(n_rows: int, p: int) -> List[Tuple[int, int]]:
    """The reference's default batching: batches of size p
    (AutoRegression.h:56-62)."""
    return [(p, n_rows // p)]


def _batch_sizes(batches: BatchSpec) -> List[int]:
    sizes: List[int] = []
    for size, rep in batches:
        sizes.extend([size] * rep)
    return sizes


def _validate(n_rows: int, batches: BatchSpec) -> List[int]:
    sizes = _batch_sizes(batches)
    if not sizes or sum(sizes) != n_rows:
        raise ValueError("Batch parameters not correctly defined")
    return sizes


def _embed(Xb: torch.Tensor, p: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The zero-padded delay embedding of one batch Xb (B, F): D (B-1, p, F)
    with D[t, k, f] = Xb[t-k, f] (t >= k), and the targets Xb[1:]."""
    K = Xb.shape[0] - 1
    D = Xb.new_zeros((K, p, Xb.shape[1]))
    for k in range(min(p, K)):
        D[k:, k] = Xb[:K - k]
    return D, Xb[1:]


def _series(X, device=None) -> torch.Tensor:
    X = config.as_input(X, device)
    return X[:, None] if X.ndim == 1 else X


def build_design(X, p: int, batches: Optional[BatchSpec] = None, device=None):
    """The stacked embedding over all batches: (D (K, p, F), Y (K, F)) with
    K = T - number of batches."""
    X = _series(X, device)
    if batches is None:
        batches = default_batches(X.shape[0], p)
    Ds, Ys = [], []
    start = 0
    for size in _validate(X.shape[0], batches):
        D, Y = _embed(X[start:start + size], p)
        Ds.append(D)
        Ys.append(Y)
        start += size
    return torch.cat(Ds), torch.cat(Ys)


def fit_ar(X, p: int, batches: Optional[BatchSpec] = None, device=None) -> torch.Tensor:
    """theta (p, F): each feature's minimum-norm least-squares solution over
    the stacked embedding (reference ComputeModel, AutoRegression.h:51-110;
    ``jnp.linalg.lstsq``'s cutoff, autoregression.py:100-110)."""
    D, Y = build_design(X, p, batches, device)  # (K, p, F), (K, F)
    A = D.permute(2, 0, 1)  # (F, K, p)
    U, s, Vh = torch.linalg.svd(A, full_matrices=False)
    rcond = torch.finfo(A.dtype).eps * max(A.shape[1], p)
    keep = (s > 0) & (s >= rcond * s[:, :1])
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, 1.0), 0.0)
    theta = Vh.mT @ (s_inv[..., None] * (U.mT @ Y.T[..., None]))  # (F, p, 1)
    return theta[..., 0].T


def predict_ar(X, theta, n: int, batches: Optional[BatchSpec] = None,
               one_prediction_per_batch: Optional[bool] = None, device=None) -> torch.Tensor:
    """n-step-ahead prediction (reference Predict, AutoRegression.h:112-186):
    (K, F), or (number of batches, F) with ``one_prediction_per_batch``.
    Without ``batches`` the reference's default batching applies and one
    prediction per batch is forced on (AutoRegression.h:120-126)."""
    X = _series(X, device)
    theta = torch.as_tensor(theta, dtype=X.dtype, device=X.device)
    p = theta.shape[0]
    if batches is None:
        batches = default_batches(X.shape[0], p)
        # the reference forces this in the default-batch branch
        # (AutoRegression.h:125 'onePredictionPerBatch = true')
        one_prediction_per_batch = True
    sizes = _validate(X.shape[0], batches)
    if n < 1:
        raise ValueError("predict_ar: the step count n must be >= 1")
    D, _ = build_design(X, p, batches)  # (K, p, F)
    for _ in range(n):
        Y = torch.einsum("kpf,pf->kf", D, theta)
        D = torch.cat([Y[:, None, :], D[:, :p - 1, :]], dim=1)
    if one_prediction_per_batch:
        # the reference's stride: the FIRST batch's size for every batch
        # (AutoRegression.h:176-183); an index past the end is clamped, as
        # JAX's gather clamps it
        b0 = batches[0][0]
        return Y[[min((b + 1) * (b0 - 1) - 1, Y.shape[0] - 1) for b in range(len(sizes))]]
    return Y


def save_ar(theta, filename: str) -> None:
    """(reference WriteModelParametersToFile, AutoRegression.h:41-44)"""
    matrixio.write_matrix(torch.as_tensor(theta).detach().cpu().numpy(), filename)


def load_ar(filename: str, dtype=None, device=None) -> torch.Tensor:
    """(reference ReadModelParametersFromFile, AutoRegression.h:36-39), as the
    numpy ``dtype`` when given, on ``device`` (by default the card)."""
    return torch.as_tensor(matrixio.read_matrix(filename, dtype), device=config.resolve_device(device))
