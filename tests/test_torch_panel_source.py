"""K15 panel_factor's CUDA source (gpr_tpu_torch/csrc/panel.cu) run on the
CPU: compiled by the host's g++ against tests/cuda_emu/emu.h, a shim that
runs every thread as a fiber and the 8 CTAs of the diagonal kernel's
thread-block cluster together, each with its own shared memory, with the
cluster barrier in phases and cp.async as plain copies, so that the diagonal
tile's factor and inverse on the cluster, the rows kernel's staging ring, the
strided panel and the float32 rounding are exercised where no CUDA compiler
exists.  It says nothing of speed.  Also: the sources that share chol.cuh
and tri_inv.cuh link into one library.

The same numpy inputs (seeded) go through the emulated kernel, the port's
plain version and JAX's panel_factor in interpret mode.  Tolerances: 1e-5 of
the largest entry against both (float32 sums in other orders: the kernel by
32-wide blocks and products with W, the plain version by cholesky_ex and a
triangular solve, JAX's by strips and products with its inverse; the card
test's gate, tests/test_torch_cuda.py); ||L_dd L_dd^T - D|| / ||D|| < 1e-5
(Frobenius, float64 arithmetic on the float32 factor); an exact-zero strict
upper in the top tile.  NaN below D's diagonal leaves the output
bit-identical (D is read from its upper triangle, as rows), and so does
widening the panel's row stride.
"""

import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpr_tpu.ops import pallas_panel as jpp
from gpr_tpu_torch.ops import panel

from cuda_emu_host import EMU, CSRC, build, host_source


@pytest.fixture(scope="module")
def panel_binary(tmp_path_factory):
    return build(tmp_path_factory.mktemp("panel"), "panel.cu", "panel_main.cpp")


def _run(exe, P, ldp=256):
    """K15 of the (n, 256) panel P, placed in an (n, ldp) buffer whose other
    entries are NaN."""
    n = P.shape[0]
    buf = np.full((n, ldp), np.nan, np.float32)
    buf[:, :256] = P
    d = exe.parent
    buf.tofile(d / "P.bin")
    subprocess.run([str(exe), str(n), str(ldp), str(d / "P.bin"), str(d / "out.bin")], check=True)
    return np.fromfile(d / "out.bin", np.float32).reshape(n, 256)


def _spd(n, seed):
    G = np.random.default_rng(seed).standard_normal((n, n))
    return (G @ G.T + n * np.eye(n)).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("n", [256, 1024])
def test_panel_source_matches_plain_and_jax(panel_binary, n):
    P = _spd(n, seed=n)[:, :256].copy()
    out = _run(panel_binary, P)
    assert np.all(np.triu(out[:256], 1) == 0)
    assert _rel(out, panel.panel_factor_reference(torch.tensor(P)).numpy()) <= 1e-5
    assert _rel(out, np.asarray(jpp.panel_factor(jnp.asarray(P), interpret=True))) <= 1e-5
    L64, D = out[:256].astype(np.float64), P[:256].astype(np.float64)
    assert np.linalg.norm(L64 @ L64.T - D) / np.linalg.norm(D) < 1e-5
    Pn = P.copy()
    Pn[np.tril_indices(256, -1)] = np.nan  # D's strict lower is never read
    assert np.array_equal(_run(panel_binary, Pn), out)


def test_panel_source_strided(panel_binary):
    P = _spd(1024, seed=3)[:, :256].copy()
    assert np.array_equal(_run(panel_binary, P, ldp=300), _run(panel_binary, P))


def test_sources_sharing_chol_cuh_link_together(tmp_path):
    # chol.cuh's functions are inline: chol.cu, leaf.cu and panel.cu include
    # it and go into one library; so do tri_inv.cuh's, which leaf.cu and
    # solve.cu include
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    objs = []
    for src in ("chol.cu", "leaf.cu", "panel.cu", "solve.cu"):
        host = tmp_path / (src[:-3] + "_host.cpp")
        host.write_text(host_source((CSRC / src).read_text()))
        objs.append(tmp_path / (src[:-3] + ".o"))
        subprocess.run([gxx, "-c", "-O0", "-std=c++17", f"-I{EMU}", str(host), "-o", str(objs[-1])], check=True)
    (tmp_path / "main.cpp").write_text("int main() { return 0; }\n")
    subprocess.run([gxx, "-std=c++17", f"-I{EMU}", str(EMU / "emu.cpp"), str(tmp_path / "main.cpp"),
                    *map(str, objs), "-o", str(tmp_path / "linked")], check=True)
