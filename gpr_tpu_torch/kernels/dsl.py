"""Kernel-string DSL parser and serializer.

Mirrors gpr_tpu/kernels/dsl.py:1-121: the reference's kernel-string format
(``Kernel::ToString`` / ``KernelFactory::GetKernel``, include/
KernelFactory.h:83-178), e.g. ``SumKernel(GaussianKernel(130,2,),
PeriodicKernel(1,3.14,2,))``.  The strings are byte-identical to the JAX
package's, so the ``-ParameterFile.txt`` of a saved model loads in both.
"""

from __future__ import annotations

import math

import torch

from . import kernels as K

_BASE = {
    "GaussianKernel": (K.Gaussian, 2),
    "GaussianExpKernel": (K.GaussianExp, 2),
    "WhiteKernel": (K.White, 1),
    "PeriodicKernel": (K.Periodic, 3),
    "RationalQuadraticKernel": (K.RationalQuadratic, 3),
    # extension kernels (not in the reference DSL)
    "Matern12Kernel": (K.Matern12, 2),
    "Matern32Kernel": (K.Matern32, 2),
    "Matern52Kernel": (K.Matern52, 2),
    "LinearKernel": (K.Linear, 2),
    "ConstantKernel": (K.Constant, 1),
}

_CONSTANTS = {"M_PI": math.pi, "M_PI_2": math.pi / 2, "M_E": math.e}


class _Cursor:
    def __init__(self, s: str):
        self.s = s
        self.i = 0

    def peek_name(self) -> str:
        j = self.s.index("(", self.i)
        return self.s[self.i:j].strip()

    def consume(self, tok: str):
        while self.i < len(self.s) and self.s[self.i].isspace():
            self.i += 1
        if not self.s.startswith(tok, self.i):
            raise ValueError(
                f"KernelFactory::GetKernel: expected {tok!r} at position {self.i} in {self.s!r}"
            )
        self.i += len(tok)

    def read_scalar(self) -> float:
        j = self.i
        while self.s[j] not in ",)":
            j += 1
        tok = self.s[self.i:j].strip()
        self.i = j
        return _CONSTANTS[tok] if tok in _CONSTANTS else float(tok)

    def maybe(self, ch: str) -> bool:
        while self.i < len(self.s) and self.s[self.i].isspace():
            self.i += 1
        if self.i < len(self.s) and self.s[self.i] == ch:
            self.i += 1
            return True
        return False


def parse_kernel(kernel_string: str) -> K.Kernel:
    """Build a kernel from a kernel string (reference KernelFactory::GetKernel)."""
    return _parse(_Cursor(kernel_string.strip()))


def _parse(cur: _Cursor) -> K.Kernel:
    name = cur.peek_name()
    cur.consume(name)
    cur.consume("(")
    if name in ("SumKernel", "ProductKernel"):
        k1 = _parse(cur)
        cur.maybe(",")
        k2 = _parse(cur)
        cur.consume(")")
        return K.Sum(k1, k2) if name == "SumKernel" else K.Product(k1, k2)
    if name == "GaussianARDKernel":
        # extension form: GaussianARDKernel(d, s1, ..., sd, scale,)
        d = int(cur.read_scalar())
        cur.maybe(",")
        vals = []
        for _ in range(d + 1):
            vals.append(cur.read_scalar())
            cur.maybe(",")
        cur.consume(")")
        return K.GaussianARD(torch.tensor(vals[:d], dtype=torch.float64), vals[d])
    if name not in _BASE:
        raise ValueError(f"KernelFactory::GetKernel: failed to load kernel {name!r}.")
    cls, nparams = _BASE[name]
    vals = []
    for _ in range(nparams):
        vals.append(cur.read_scalar())
        cur.maybe(",")
    cur.consume(")")
    return cls(*vals)


def kernel_to_string(kernel: K.Kernel) -> str:
    """Serialize (reference Kernel::ToString)."""
    return kernel.to_string()
