"""The operation and byte counts behind each share, at the cells' shapes,
and the kernel-name maps against the CUDA sources."""

import math
import re

import pytest

from portbench.core import counts, manifest, peaks
from portbench_tiny import REPO


def _metric(name):
    return manifest.load_module("metrics", name)


def test_fit_flop_is_bench_model():
    n, d, q = 16384, 128, 8
    assert counts.fit_flop(n, d, q) == 2 * n * n * d + n ** 3 / 3 + 2 * n * n * q
    assert math.isclose(counts.fit_flop(n, d, q), 1.5390e12, rel_tol=1e-4)


def test_train_flop():
    n, d, q = 16384, 128, 8
    step = counts.fit_flop(n, d, q) + 7 * n ** 3 / 3
    assert math.isclose(step, 1.18011e13, rel_tol=1e-5)
    assert counts.train_request_flop(n, d, q, 8) == 8 * step + counts.fit_flop(n, d, q)
    assert math.isclose(counts.train_request_flop(3773, 5, 3, 8) / 9, 1.3e11, rel_tol=0.15)


def test_peaks():
    assert peaks.FLOPS == 165e12 and peaks.BYTES == 3.35e12
    assert peaks.bound_s(165e12, 0) == 1.0 and peaks.bound_s(0, 3.35e12) == 1.0


def test_fullchol_bounds():
    fit = _metric("fullchol_roofline.fit").bound_s(16384, 128)
    assert math.isclose(fit, (16384 ** 2 * 128 + 16384 ** 3 / 3) / 165e12)  # compute-bound
    assert math.isclose(fit * 1e3, 9.09, rel_tol=1e-3)
    train = _metric("fullchol_roofline.train").bound_s(16384)
    assert math.isclose(train, 16384 ** 3 / 3 / 165e12)


def test_syrk_updates_mirror_blocked_recursion():
    """The metric's copy of ops/blocked.py's split and leaf gives the
    updates of the port's recursion at n=3773 (and its split everywhere)."""
    from gpr_tpu_torch.ops import blocked

    syrk = _metric("syrk_roofline.short_step")
    assert syrk.updates(3773) == [(896, 1024), (1853, 1920), (829, 1024)]
    assert syrk.LEAF == blocked.LEAF
    for n in (1025, 2048, 3773, 4097, 16383):
        assert syrk.split(n) == blocked._round_split(n)
    flop = sum(m * (m + 1) * k for m, k in syrk.updates(3773))
    assert math.isclose(flop, 8.12e9, rel_tol=1e-2)
    assert syrk.bound_s(3773) > flop / 165e12 * 0.999


def test_kernel_maps_name_every_kernel_once():
    """Every __global__ function in gpr_tpu_torch/csrc/*.cu is in exactly one
    map, and every mapped name is one."""
    src = "".join(p.read_text() for p in sorted((REPO / "gpr_tpu_torch" / "csrc").glob("*.cu")))
    defined = set(re.findall(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\([^)]*\)\s*)?(?:void\s+)?(\w+)\s*\(",
                             src))
    maps = manifest.kernel_maps()
    assert set(maps) == defined
    assert maps["panel_products_kernel"] == "ops.fullchol"
    assert maps["syrk_update_kernel"] == "ops.syrk"


@pytest.mark.parametrize("name,module", [
    ("void gpr::panel_strip_kernel<0>(float const*, float*, float const*, int, int, int, int, int, "
     "gpr::GramParams, float)", "ops.fullchol"),
    ("gpr::diag_factor_inv_kernel(float*, float*, int, int)", "ops.fullchol"),
    ("void gpr::syrk_update_kernel(float const*, int, float const*, int, float*, int, int, int)", "ops.syrk"),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x64_8x5_nn_align1>(cutlass_80_simt_sgemm_128x64_8x5_"
     "nn_align1::Params)", "library"),
])
def test_kernel_map_reads_demangled_names(name, module):
    from portbench.core.trace import KernelMap

    assert KernelMap(manifest.kernel_maps())(name)[0] == module
