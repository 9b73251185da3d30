"""PCA dimensionality reduction.

Mirrors gpr_tpu/pipeline/pca.py:36-160 (``PCAModel``, ``fit_pca``,
``load_pca``), the reference's ``PCA<T>`` (include/PCA.h:21-145):

  * the data matrix X is (d, N): columns are samples (d ~ 1e4-1e6 voxel
    features, N ~ 1e3 frames);
  * the mean over columns, then a thin SVD of the centered matrix;
  * singular values scaled by 1/sqrt(N) (PCA.h:44);
  * the whitened basis U diag(sigma)^-1 (PCA.h:46) and the truncated
    inverse basis (U diag(sigma))[:, :n_features] (PCA.h:47-48);
  * {prefix}Mean.bin / Sigma.bin / U.bin in the reference's MatrixIO format
    (PCA.h:126-134).

For d > N and d > ``gram_threshold`` the SVD comes from the N x N Gram
matrix Xc^T Xc = V S^2 V^T: one (N, d) x (d, N) product and
``torch.linalg.eigh`` of a small matrix (symmetrized first, as
``jnp.linalg.eigh`` does), reversed to descending order, negative
eigenvalues clamped to 0 and zero singular values kept out of the inverse
scale (pca.py:134-144).  Otherwise ``torch.linalg.svd``.  A basis column's
sign is whatever the eigensolver returns, as in JAX; a flipped column flips
its feature and leaves the reconstruction unchanged.  The functions take the
dtype of their inputs and run on the card unless given ``device="cpu"`` or
CPU tensors (utils/config.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..utils import config, matrixio


@dataclasses.dataclass(frozen=True)
class PCAModel:
    """A PCA basis.

    mean   (d,)    per-feature mean (reference m_mean)
    sigma  (r,)    singular values / sqrt(N) (reference m_sigma)
    U      (d, r)  left singular vectors (reference m_U)
    """

    mean: torch.Tensor
    sigma: torch.Tensor
    U: torch.Tensor

    @property
    def num_modes(self) -> int:
        return self.sigma.shape[0]

    def _data(self, X) -> torch.Tensor:
        return torch.as_tensor(X, dtype=self.mean.dtype, device=self.mean.device)

    def basis(self, n_features: int = 0) -> torch.Tensor:
        """Whitened basis U diag(sigma)^-1, optionally truncated (PCA.h:82-90);
        a zero singular value gets a zero column, not inf / NaN."""
        pos = self.sigma > 0
        B = torch.where(pos[None, :], self.U / torch.where(pos, self.sigma, 1.0)[None, :], 0.0)
        if 0 < n_features < B.shape[1]:
            B = B[:, :n_features]
        return B

    def reduce(self, X, n_features: int = 0) -> torch.Tensor:
        """features = basis^T (X - mean): (d, N) -> (r or n_features, N)
        (reference DimensionalityReduction, PCA.h:92-101)."""
        X = self._data(X)
        F = self.basis().T @ (X - self.mean[:, None])
        if 0 < n_features < F.shape[0]:
            F = F[:n_features]
        return F

    def reconstruct(self, weights, n_features: Optional[int] = None) -> torch.Tensor:
        """X = (U diag(sigma))[:, :k] weights + mean: (k, N) -> (d, N)
        (reference GetReconstruction, PCA.h:110-115)."""
        W = self._data(weights)
        single = W.ndim == 1
        if single:
            W = W[:, None]
        k = W.shape[0] if n_features is None else n_features
        out = (self.U[:, :k] * self.sigma[None, :k]) @ W[:k] + self.mean[:, None]
        return out[:, 0] if single else out

    def explained_variance(self) -> torch.Tensor:
        """The cumulative normalized spectrum (reference GetExplainedVariance,
        PCA.h:117-124)."""
        c = torch.cumsum(self.sigma, 0)
        return c / c[-1]

    def modes_for_compactness(self, threshold: float) -> int:
        """The fewest modes reaching the cumulative compactness ``threshold``
        (reference scripts/model_analysis.py:17-30)."""
        ev = self.explained_variance().cpu().numpy()
        return int(np.searchsorted(ev, threshold) + 1)

    def save(self, prefix: str) -> None:
        """{prefix}Mean.bin / Sigma.bin / U.bin (reference PCA.h:126-134)."""
        def host(t):
            return t.detach().cpu().numpy()

        matrixio.write_matrix(host(self.mean)[:, None], prefix + "Mean.bin")
        matrixio.write_matrix(host(self.sigma)[:, None], prefix + "Sigma.bin")
        matrixio.write_matrix(host(self.U), prefix + "U.bin")


def fit_pca(X, gram_threshold: int = 4096, device=None) -> PCAModel:
    """Fit the basis on X (d, N), columns = samples (pca.py:121-149)."""
    X = config.as_input(X, device)
    d, N = X.shape
    mean = X.mean(1)
    Xc = X - mean[:, None]
    if d > N and d > gram_threshold:
        G = Xc.T @ Xc  # (N, N)
        evals, V = torch.linalg.eigh(0.5 * (G + G.T))  # ascending
        s = torch.sqrt(torch.clamp(evals.flip(0), min=0.0))  # singular values of Xc
        V = V.flip(1)
        U = (Xc @ V) / torch.where(s > 0, s, 1.0)[None, :]
    else:
        U, s, _ = torch.linalg.svd(Xc, full_matrices=False)
    return PCAModel(mean=mean, sigma=s / math.sqrt(N), U=U)


def load_pca(prefix: str, dtype=None, device=None) -> PCAModel:
    """Load a basis written by :meth:`PCAModel.save`, by the JAX package or by
    the reference (PCA.h:51-65), as the numpy ``dtype`` when given, on
    ``device`` (by default the card)."""
    device = config.resolve_device(device)

    def read(name):
        return torch.as_tensor(matrixio.read_matrix(prefix + name, dtype), device=device)

    return PCAModel(mean=read("Mean.bin").ravel(), sigma=read("Sigma.bin").ravel(), U=read("U.bin"))
