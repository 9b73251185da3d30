"""Dtype and matmul-precision policy of the port.

Mirrors gpr_tpu/utils/config.py:25-99.  Two dtype tiers, as in the JAX
package:

  * ``fast``   float32, the production tier on the GPU;
  * ``parity`` float64, for the golden tests against the reference's double.

The policy sets defaults only; every function takes the dtype of its inputs.

Matmul tier: an f32 grade.  The JAX package runs its f32 contractions at an
f32-grade tier (bf16x3 "high" on the TPU, config.py:75-99) and never at a
single bf16 pass.  On the GPU the matching rule is: no single TF32 pass.
Importing this module turns TF32 off for PyTorch's matrix products and
cuDNN, so every float32 product in the port runs in full float32.  The
hand-written kernels compute in plain FP32 FMA, except K2 (panel_update,
csrc/fullchol.cu), whose update product runs on the tensor cores in 3xTF32:
each operand split into a tf32 big and small half, small*big + big*small +
big*big summed in FP32 (csrc/tc_tile.cuh).

Device: the entry points (``fit``, ``load``, ``convert.gp_from_numpy``, the
likelihood functions, ``fit_mle``, ``fit_map``) run on the card unless told
otherwise.  A torch tensor stays on the device it is on; numpy or list input
goes to ``device``, by default ``cuda``.  Without a CUDA device and with none
asked for they raise: the port never falls back to the CPU on its own.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

MATMUL_TIER = "ieee"


@dataclasses.dataclass(frozen=True)
class Policy:
    name: str
    default_dtype: torch.dtype


_FAST = Policy(name="fast", default_dtype=torch.float32)
_PARITY = Policy(name="parity", default_dtype=torch.float64)
_POLICIES = {"fast": _FAST, "parity": _PARITY}

_active = _FAST


def set_policy(name: str) -> Policy:
    global _active
    if name not in _POLICIES:
        raise ValueError(f"unknown policy {name!r}; expected 'fast' or 'parity'")
    _active = _POLICIES[name]
    return _active


def policy() -> Policy:
    return _active


def default_dtype() -> torch.dtype:
    return _active.default_dtype


def default_numpy_dtype() -> np.dtype:
    """:func:`default_dtype` as a numpy dtype, for arrays read from files."""
    return torch.empty((), dtype=_active.default_dtype).numpy().dtype


@contextlib.contextmanager
def policy_scope(name: str):
    global _active
    prev = _active
    try:
        yield set_policy(name)
    finally:
        _active = prev


def resolve_device(device=None) -> torch.device:
    """``device`` if given, else the card; raises where there is none."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' or CPU tensors to run on the CPU")
    return torch.device("cuda")


def as_input(x, device=None) -> torch.Tensor:
    """An entry point's array argument as a tensor: a tensor keeps its device
    unless ``device`` is given; anything else goes to :func:`resolve_device`."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    return torch.as_tensor(np.asarray(x), device=resolve_device(device))
