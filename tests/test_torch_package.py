"""Package rules of the port: no JAX, dispatch that follows the tensor, and
wrappers that refuse what their kernels do not take."""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import gpr_tpu_torch as tg
from gpr_tpu_torch.gp import likelihood as lk
from gpr_tpu_torch.ops import _cuda, blocked, chol, fullchol, syrk
from gpr_tpu_torch.ops import gram as gop

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_import_loads_no_jax():
    code = ("import sys, gpr_tpu_torch, gpr_tpu_torch.convert, gpr_tpu_torch.pipeline, "
            "gpr_tpu_torch.apps.learn, gpr_tpu_torch.apps.predict, gpr_tpu_torch.utils.native, "
            "gpr_tpu_torch.apps.serve, gpr_tpu_torch.apps.drift, gpr_tpu_torch.apps.experiments, "
            "gpr_tpu_torch.apps.validate, gpr_tpu_torch.apps.tikz, gpr_tpu_torch.apps.analysis, "
            "gpr_tpu_torch.data, gpr_tpu_torch.data.dicom, gpr_tpu_torch.utils.profiling, "
            "gpr_tpu_torch.parallel; "
            "print('jax' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "False"


def test_sources_import_neither_jax_nor_gpr_tpu():
    pat = re.compile(r"^\s*(import|from)\s+(jax|gpr_tpu)\b", re.M)
    files = [f for f in sorted((ROOT / "gpr_tpu_torch").rglob("*.py"))
             if "_build" not in f.parts] + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    names = {str(f.relative_to(ROOT)) for f in files}
    assert {"gpr_tpu_torch/ops/syrk.py", "gpr_tpu_torch/ops/blocked.py",
            "gpr_tpu_torch/gp/likelihood.py", "gpr_tpu_torch/inference/priors.py",
            "gpr_tpu_torch/inference/prior_utils.py",
            "gpr_tpu_torch/inference/optimize.py", "gpr_tpu_torch/gp/sparse.py",
            "gpr_tpu_torch/pipeline/pca.py", "gpr_tpu_torch/pipeline/autoregression.py",
            "gpr_tpu_torch/pipeline/dataparser.py", "gpr_tpu_torch/pipeline/imageio.py",
            "gpr_tpu_torch/utils/logutils.py", "gpr_tpu_torch/utils/native.py",
            "gpr_tpu_torch/apps/learn.py", "gpr_tpu_torch/apps/predict.py",
            "gpr_tpu_torch/pipeline/bspline.py", "gpr_tpu_torch/pipeline/warp.py",
            "gpr_tpu_torch/pipeline/filters.py", "gpr_tpu_torch/utils/profiling.py",
            "gpr_tpu_torch/apps/serve.py", "gpr_tpu_torch/apps/drift.py",
            "gpr_tpu_torch/apps/experiments.py", "gpr_tpu_torch/apps/validate.py",
            "gpr_tpu_torch/apps/tikz.py", "gpr_tpu_torch/apps/analysis.py",
            "gpr_tpu_torch/data/__init__.py", "gpr_tpu_torch/data/dicom.py",
            "gpr_tpu_torch/data/prep.py", "gpr_tpu_torch/parallel/__init__.py",
            "gpr_tpu_torch/parallel/sharded_gram.py", "gpr_tpu_torch/parallel/sharded_hmc.py",
            "gpr_tpu_torch/parallel/dryrun.py"} <= names
    for f in files:
        assert not pat.search(f.read_text()), f


# gpr_tpu's Pallas modules and the port's modules that hold their kernels
_KERNEL_MODULES = {
    "ops/pallas_gram.py": ["ops/gram.py"],
    "ops/pallas_fullchol.py": ["ops/fullchol.py"],
    "ops/pallas_syrk.py": ["ops/syrk.py"],
    "ops/pallas_batched.py": ["ops/batched.py", "ops/crout.py"],
    "ops/pallas_solve.py": ["ops/solve.py"],
    "ops/pallas_leaf.py": ["ops/leaf.py"],
    "ops/pallas_panel.py": ["ops/panel.py"],
    "ops/pallas_chol.py": ["ops/chol.py"],
}

# public names of gpr_tpu with no counterpart of the same name, each with its
# reason: a Pallas entry, and the port's wrapper of its kernel as
# (module, name); or a JAX-only knob (None)
_NO_COUNTERPART = {
    ("ops/__init__.py", "pallas_gram"): ("ops/__init__.py", "gram"),  # the Gram kernels' module
    ("ops/pallas_gram.py", "gram_pallas"): ("ops/gram.py", "gram"),  # K1
    ("ops/pallas_gram.py", "gaussian_gram"): ("ops/gram.py", "gram"),  # K1, form="gaussian"
    ("ops/pallas_gram.py", "gram_pallas_batched"): ("ops/gram.py", "gram_batched"),  # K6
    ("ops/pallas_chol.py", "cholesky_pallas"): ("ops/chol.py", "cholesky_tile"),  # K19
    ("ops/pallas_chol.py", "cholesky_pallas_v2"): ("ops/chol.py", "cholesky_tile_v2"),  # K20
    # the fused kernel's TPU gate; the port's is its route, "fused-matrix"
    ("ops/pallas_fullchol.py", "fused_usable"): ("ops/linalg.py", "route_for"),
    ("utils/config.py", "enable_x64"): None,  # JAX's 64-bit switch: torch takes the dtype
    ("utils/config.py", "matmul_precision"): None,  # XLA's matmul tier: the port states its own
    ("utils/config.py", "set_matmul_precision"): None,  # (config.MATMUL_TIER, TF32 off)
}


def _top_level_names(path: pathlib.Path, public_only: bool) -> set:
    """Names a module defines or imports at its top level, read with ast
    (neither package is imported); re-exports count in ``__init__.py``."""
    import ast

    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)) and (
                not public_only or path.name == "__init__.py"):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
    return {n for n in names if not n.startswith("_")} if public_only else names


def test_every_public_name_of_gpr_tpu_has_a_counterpart():
    """Every module of gpr_tpu has its mirror in the port (a Pallas module
    the port's modules of its kernels), and every public name there a name
    in the mirror, but for the justified exclusions above, each of which
    must still be needed and name a wrapper that exists."""
    missing, used = [], set()
    for f in sorted((ROOT / "gpr_tpu").rglob("*.py")):
        rel = f.relative_to(ROOT / "gpr_tpu").as_posix()
        mirrors = [ROOT / "gpr_tpu_torch" / m for m in _KERNEL_MODULES.get(rel, [rel])]
        assert all(m.exists() for m in mirrors), f"no mirror of gpr_tpu/{rel}"
        port = set().union(*(_top_level_names(m, public_only=False) for m in mirrors))
        for name in sorted(_top_level_names(f, public_only=True) - port):
            if (rel, name) in _NO_COUNTERPART:
                used.add((rel, name))
            else:
                missing.append(f"gpr_tpu/{rel}::{name}")
    assert not missing, missing
    assert used == set(_NO_COUNTERPART), set(_NO_COUNTERPART) - used  # an exclusion no longer needed
    for module, name in filter(None, _NO_COUNTERPART.values()):
        assert name in _top_level_names(ROOT / "gpr_tpu_torch" / module, public_only=False), (module, name)


def test_top_level_names_include_the_sparse_gp():
    # as gpr_tpu/__init__.py:35 exports them
    from gpr_tpu_torch.gp import sparse

    assert (tg.SparseGP, tg.fit_sparse, tg.fit_svgp) == (sparse.SparseGP, sparse.fit_sparse,
                                                          sparse.fit_svgp)


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert tg.config.MATMUL_TIER == "ieee"
    with tg.config.policy_scope("parity"):
        assert tg.config.default_dtype() == torch.float64
    assert tg.config.default_dtype() == torch.float32


def test_cpu_tensors_launch_no_kernel(rng):
    _cuda.reset_launch_counts()
    X = torch.tensor(rng.standard_normal((600, 4)), dtype=torch.float32)
    Y = torch.tensor(rng.standard_normal((600, 2)), dtype=torch.float32)
    gop.gram(X, X, form="matern32", tril=True)
    gp = tg.fit(tg.Gaussian(2.0), X, Y, sigma=0.1, use_pallas_gram=True)
    gp.predict(X[:5])
    fullchol.gram_cholesky_fused(X, 2.0, 1.0, 1.0, 0.1)
    fullchol.cholesky_fused(torch.eye(256) * 2.0)
    blocked.cholesky_blocked(torch.eye(1100) * 2.0)
    syrk.syrk_update(torch.eye(70), torch.ones((70, 3)))
    lk.mll_value_and_grad(tg.Gaussian(2.0), X[:100], Y[:100], 0.1)
    tile = torch.eye(32) * 2.0
    chol.cholesky_tile(tile)
    chol.cholesky_tile_v2(tile, sw=16)
    chol.leaf_cholesky(tile)
    chol.leaf_cholesky(tile.double())
    assert _cuda.launch_counts() == {k.name: 0 for k in _cuda.KERNELS}


def test_wrappers_refuse_what_the_kernels_do_not_take():
    X = torch.zeros((10, 3))
    with pytest.raises(ValueError):
        gop.gram(X.double(), X.double())  # dtype
    with pytest.raises(ValueError):
        gop.gram(X, torch.zeros((10, 4)))  # feature widths differ
    with pytest.raises(ValueError):
        gop.gram(X.T, X.T)  # not contiguous
    with pytest.raises(ValueError):
        gop.gram(X, X[:5], tril=True)  # tril needs the square case
    with pytest.raises(ValueError):
        gop.gram(X, X, form="linear")
    with pytest.raises(ValueError):
        fullchol.cholesky_fused(torch.eye(200))  # not a multiple of the panel
    with pytest.raises(ValueError):
        fullchol.cholesky_fused(torch.eye(256, dtype=torch.float64))
    with pytest.raises(ValueError):
        fullchol.gram_cholesky_fused(X, 1.0, 1.0, 1.0, 0.0, form="periodic")
    L = torch.empty((256, 256))
    with pytest.raises(ValueError):
        fullchol.diag_factor_inv(L, torch.empty((3, 128, 128)), 0)  # W of the wrong shape
    with pytest.raises(ValueError):
        fullchol.panel_update(L, 0, torch.zeros((100, 3)), form="gaussian")  # X does not pad to 256
    with pytest.raises(ValueError):
        gop.gram(X.to("meta"), X.to("meta"))  # neither CPU nor CUDA
    with pytest.raises(ValueError):
        chol.cholesky_tile(torch.eye(4, device="meta"))
    with pytest.raises(ValueError):
        chol.cholesky_tile(torch.zeros((3, 4)))  # not square


def test_library_path_follows_the_sources():
    path = _cuda.library_path()
    assert path.parent == ROOT / "gpr_tpu_torch" / "_build"
    assert path == _cuda.library_path()
    assert re.fullmatch(r"libgpr_kernels-[0-9a-f]{16}\.so", path.name)
    assert {p.name for p in _cuda.CSRC.glob("*.cu*")} >= {"gram_tile.cuh", "gram.cu",
                                                          "fullchol.cu", "syrk.cu"}


def test_panel_width_matches_the_kernel_source():
    src = (_cuda.CSRC / "fullchol.cu").read_text()
    assert f"constexpr int kPanel = {fullchol.PANEL};" in src
    tile = (_cuda.CSRC / "gram_tile.cuh").read_text()
    for code, form in enumerate(gop.FORMS):
        name = "k" + {"rq": "RQ"}.get(form, form.capitalize())
        assert f"{name} = {code}," in tile, form


def test_gp_is_a_module_with_buffers(rng):
    X = torch.tensor(rng.standard_normal((20, 2)))
    gp = tg.fit(tg.Gaussian(1.0), X, X[:, :1], sigma=0.1)
    names = dict(gp.named_buffers())
    assert {"X", "Y", "sigma", "alpha", "L", "kernel.sigma", "kernel.scale"} <= set(names)
    assert isinstance(gp, torch.nn.Module) and isinstance(gp.kernel, torch.nn.Module)
    np.testing.assert_allclose(gp.to(torch.device("cpu")).predict(X).numpy(),
                               gp.predict(X).numpy())


def test_every_kernel_names_its_source_and_the_tpu_kernel_it_replaces():
    symbol = re.compile(r'extern "C" [\w\s\*]*?\b(gpr_\w+)\(')
    for k in _cuda.KERNELS:
        src = ROOT / k.source
        assert src.parent == _cuda.CSRC and src.is_file(), k.name
        assert k.symbol in symbol.findall(src.read_text()), (k.name, k.source)
        path, line = k.replaces.rsplit(":", 1)
        assert path.startswith("gpr_tpu/ops/"), k.name
        lines = (ROOT / path).read_text().splitlines()  # read as text, never imported
        assert re.match(r"def \w+\(", lines[int(line) - 1]), (k.name, k.replaces)
    assert len({k.name for k in _cuda.KERNELS}) == len(_cuda.KERNELS)
    # every JAX module with a TPU kernel has a counterpart in the port
    pallas = {f"gpr_tpu/ops/{f.name}" for f in (ROOT / "gpr_tpu" / "ops").glob("*.py")
              if "pl.pallas_call" in f.read_text()}
    assert len(pallas) >= 9
    assert pallas <= {k.replaces.rsplit(":", 1)[0] for k in _cuda.KERNELS}
