"""Hyperparameter inference: MLE / MAP optimizers and prior densities
(mirrors gpr_tpu/inference/__init__.py for the modules ported so far)."""

from . import optimize, prior_utils, priors  # noqa: F401
