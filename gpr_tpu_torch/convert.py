"""Carry a kernel or a trained GP from the JAX package into the port.

The input is plain numpy (or a kernel string), so this module imports no JAX:
the caller extracts the state from a ``gpr_tpu`` object.  Factorizations
(the fused, blocked and whole-leaf Cholesky kernels) carry no parameters, so
nothing here concerns them: a factor travels as the ``L`` of a GP state.

  kernel tree   the kernel's ``kernel_to_string()`` (its ``.17g`` numbers
                round-trip exactly), or a nested ``(class_name, args)``
                pair: ``args`` is the list of the class's constructor
                arguments as numpy arrays, or for ``Sum``/``Product`` the two
                sub-trees.
                A fleet's kernel may carry (B,) argument arrays (a leading
                batch axis on every leaf).
  GP state      a dict ``{"kernel": tree, "X", "Y", "sigma", "alpha", "L",
                "core"}`` of numpy arrays (``L`` and ``core`` may be None).
  fleet state   a dict ``{"kernel": tree, "X", "Y", "sigma", "alpha", "L",
                "batched_kernel"}`` from a ``gpr_tpu`` ``BatchedGP``.
  sparse state  a dict ``{"kernel": tree, "Z", "X", "Y", "sigma", "jitter",
                "alpha", "R", "Lmm"}`` from a ``gpr_tpu`` ``SparseGP``.
  PCA basis     the ``mean``, ``sigma`` and ``U`` arrays of a ``gpr_tpu``
                ``PCAModel``.
  density       ``(class_name, args)``: a prior density's class name and its
                constructor arguments, e.g. ``("LogGaussianDensity", [mu,
                sigma])``, so that both packages build the same MAP objective.
"""

from __future__ import annotations

import numpy as np
import torch

from .gp.batched import BatchedGP
from .gp.exact import GP
from .gp.sparse import SparseGP
from .inference import priors
from .kernels import kernels as kermod
from .kernels.dsl import parse_kernel
from .pipeline.pca import PCAModel
from .utils import config

_CLASSES = {
    c.__name__: c
    for c in (kermod.Gaussian, kermod.GaussianExp, kermod.White, kermod.RationalQuadratic,
              kermod.Periodic, kermod.Sum, kermod.Product, kermod.Matern12, kermod.Matern32,
              kermod.Matern52, kermod.GaussianARD, kermod.Linear, kermod.Constant)
}


def kernel_from_numpy(tree) -> kermod.Kernel:
    """The port's kernel from a kernel string or a ``(class_name, args)`` tree."""
    if isinstance(tree, str):
        return parse_kernel(tree)
    name, args = tree
    if name not in _CLASSES:
        raise ValueError(f"kernel_from_numpy: unknown kernel class {name!r}")
    cls = _CLASSES[name]
    if cls in (kermod.Sum, kermod.Product):
        return cls(kernel_from_numpy(args[0]), kernel_from_numpy(args[1]))
    return cls(*[torch.as_tensor(np.array(a, np.float64)) for a in args])


_DENSITIES = {
    c.__name__: c
    for c in (priors.GaussianDensity, priors.LogGaussianDensity, priors.InverseGaussianDensity,
              priors.GammaDensity)
}


def density_from_numpy(tree) -> priors.Density:
    """The port's prior density from a ``(class_name, args)`` pair."""
    name, args = tree
    if name not in _DENSITIES:
        raise ValueError(f"density_from_numpy: unknown density class {name!r}")
    return _DENSITIES[name](*[float(np.asarray(a)) for a in args])


def gp_from_numpy(state: dict, device=None) -> GP:
    """The port's GP from the numpy state of a ``gpr_tpu.GP``, on ``device``
    (by default the card, utils/config.py)."""
    device = config.resolve_device(device)

    def tensor(key):
        v = state.get(key)
        return None if v is None else torch.as_tensor(np.array(v), device=device)

    X = tensor("X")
    return GP(kernel_from_numpy(state["kernel"]), X, tensor("Y"),
              float(np.asarray(state["sigma"])), tensor("alpha"), tensor("L"), tensor("core"),
              route="converted")


def fleet_from_numpy(state: dict, device=None) -> BatchedGP:
    """The port's ``BatchedGP`` from the numpy state of a ``gpr_tpu``
    ``BatchedGP``, on ``device`` (by default the card, utils/config.py)."""
    device = config.resolve_device(device)

    def tensor(key):
        return torch.as_tensor(np.array(state[key]), device=device)

    return BatchedGP(kernel_from_numpy(state["kernel"]), tensor("X"), tensor("Y"),
                     tensor("sigma"), tensor("alpha"), tensor("L"),
                     bool(state.get("batched_kernel", False)), route="converted")


def sparse_from_numpy(state: dict, device=None) -> SparseGP:
    """The port's ``SparseGP`` from the numpy state of a ``gpr_tpu``
    ``SparseGP``, on ``device`` (by default the card, utils/config.py)."""
    device = config.resolve_device(device)

    def tensor(key):
        return torch.as_tensor(np.array(state[key]), device=device)

    return SparseGP(kernel_from_numpy(state["kernel"]), tensor("Z"), tensor("X"), tensor("Y"),
                    tensor("sigma"), tensor("jitter"), tensor("alpha"), tensor("R"), tensor("Lmm"),
                    route="converted")


def pca_from_numpy(mean, sigma, U, device=None) -> PCAModel:
    """The port's ``PCAModel`` from a ``gpr_tpu`` ``PCAModel``'s arrays, on
    ``device`` (by default the card)."""
    device = config.resolve_device(device)
    return PCAModel(*(torch.as_tensor(np.array(a), device=device) for a in (mean, sigma, U)))
