"""Hyperparameter inference: MLE / MAP optimizers, HMC / NUTS samplers,
mean-field ADVI, the mixture predictive, period estimation and prior
densities (mirrors gpr_tpu/inference/__init__.py)."""

from . import optimize, prior_utils, priors  # noqa: F401
from . import advi, hmc, nuts, period, predictive  # noqa: F401
