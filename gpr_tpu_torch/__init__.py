"""gpr_tpu_torch: the PyTorch and CUDA port of gpr_tpu.

Mirrors gpr_tpu/__init__.py for the names ported so far: the kernel algebra
and its string DSL with hyperparameter gradients, exact GP fit -> predict,
save/load of the reference's 5-file model artifacts, the sparse
(inducing-point) GP, the marginal likelihood with its gradient, the prior
densities, MLE / MAP training, fleets of small GPs (fit, predict,
likelihood and MLE of B GPs at once) and the hyperparameter samplers (HMC,
NUTS, ADVI and the mixture predictive, whose chains and draws run as one
fleet).  The feature pipeline (``pipeline``: PCA, AR, image I/O, the data
parser), the image pipeline (``pipeline.bspline``, ``.warp``, ``.filters``),
the dataset preparation (``data``: DICOM ingestion, pair splitting), the
per-stage timer and tracer (``utils.profiling``) and the apps (``python -m
gpr_tpu_torch.apps.learn``, ``.predict``, ``.serve``, whose per-frame program
is one CUDA graph on the card, ``.drift``, ``.experiments``, ``.validate``,
``.tikz``, ``.analysis``) sit beside them.
On a CUDA tensor the fit, the likelihood and the fleet run through
hand-written CUDA kernels (ops/gram.py, ops/fullchol.py, ops/syrk.py,
ops/crout.py, ops/solve.py, ops/leaf.py; sources in csrc/); on a CPU tensor through their
plain torch versions.  The whole-leaf Cholesky kernels (``leaf_cholesky``,
``leaf_cholesky_wi``, ``tri_inv_leaf``) are exported as gpr_tpu/ops/pallas_leaf.py
defines them; the blocked route reaches ``leaf_cholesky_wi`` under
``GPR_CHOL_LEAF_INV=1``.  The entry points run on the card unless given ``device="cpu"``
or CPU tensors.  This package imports torch and numpy only, never JAX.
"""

from .kernels.kernels import (  # noqa: F401
    Constant,
    Gaussian,
    GaussianARD,
    GaussianExp,
    Kernel,
    Linear,
    Matern12,
    Matern32,
    Matern52,
    Periodic,
    Product,
    RationalQuadratic,
    Sum,
    White,
    gram,
    gram_derivative,
    kvec,
    params_vector,
)
from .kernels.dsl import kernel_to_string, parse_kernel  # noqa: F401
from .kernels.utils import get_general_kernel  # noqa: F401
from .gp.exact import GP, extend, fit, load, shrink  # noqa: F401
from .gp.sparse import SparseGP, fit_sparse, fit_svgp  # noqa: F401
from .gp.batched import fit_batched, mll_batched, predict_batched  # noqa: F401
from .gp import likelihood  # noqa: F401
from .inference.optimize import fit_map, fit_mle  # noqa: F401
from .inference.hmc import HMCConfig, sample_hmc, sample_hmc_chunked  # noqa: F401
from .inference.nuts import NUTSConfig, sample_nuts, sample_nuts_chunked  # noqa: F401
from .ops.leaf import leaf_cholesky, leaf_cholesky_wi, tri_inv_leaf  # noqa: F401
from .utils import config  # noqa: F401

__version__ = "0.1.0"
