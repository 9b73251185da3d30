"""The port's copy of the native runtime's bindings (gpr_tpu_torch.utils.native)
against gpr_tpu.utils.native and gpr_tpu.utils.matrixio, on the CPU.

Files written by one package are read by the other, both ways, with the
library (built by ``make -C native`` where it is missing) and without it
(the numpy codec the bindings fall back to).
"""

import numpy as np
import pytest

from gpr_tpu.utils import matrixio as jmio
from gpr_tpu.utils import native as jnative
from gpr_tpu_torch.utils import native as tnative


@pytest.fixture(params=["library", "numpy"])
def codec(request, monkeypatch):
    """The port's bindings with the library, or as if it were not built."""
    if request.param == "library":
        if not (tnative.available() or tnative.build()):
            pytest.skip("the native library does not build here")
    else:
        monkeypatch.setattr(tnative, "_load", lambda: None)
    return request.param


def _matrix(seed, shape=(7, 5)):
    return np.random.default_rng(seed).standard_normal(shape)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_reads_what_jax_writes(tmp_path, codec, dtype):
    M = _matrix(1).astype(dtype)
    p = str(tmp_path / "m.bin")
    jmio.write_matrix(M, p)
    out = tnative.read_matrix(p)
    assert out.dtype in (np.float64, dtype)
    np.testing.assert_array_equal(out, M.astype(np.float64))


def test_jax_reads_what_the_port_writes(tmp_path, codec):
    M = _matrix(2)
    p = str(tmp_path / "m.bin")
    tnative.write_matrix(M, p)
    np.testing.assert_array_equal(jmio.read_matrix(p), M)
    np.testing.assert_array_equal(jnative.read_matrix(p), M)
    q = str(tmp_path / "v.bin")
    tnative.write_matrix(M[:, 0], q)  # a vector is one row, as native.py:124 writes it
    np.testing.assert_array_equal(jmio.read_matrix(q), M[None, :, 0])


def test_num_threads_is_jax_s(codec):
    expected = jnative.num_threads() if codec == "library" else 1
    assert tnative.num_threads() == expected >= 1
