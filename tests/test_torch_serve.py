"""The port's serving loop (gpr_tpu_torch.apps.serve) against gpr_tpu's, on
the CPU in float64 (the ``parity`` policy; ``device="cpu"``, where the
per-frame program runs eagerly: its CUDA graph is held to the eager program
in tests/test_torch_cuda.py and chip_smoke.py).

One model, learned once by JAX's learn app on tests/test_serve.py's
synthetic frames, serves the same frames through both packages'
``Server.handle_frame`` and ``watch``.  The mean features and the DVF agree
within 1e-10 relative (the port forms the truncated PCA bases once and sums
the per-frame products in other orders).  The credible interval agrees
within 1e-10 of 2 scale = 2, its value with no data: the variance
k(x, x) - k^T (K + s^2 I)^-1 k cancels to ~3e-4 of k(x, x) at these frames,
and a product with the loaded CoreMatrix (entries up to ~3e3) summed in
another order moves it by ~1e-13, which is ~2e-10 of the interval itself;
``watch`` writes the same ``dvf%05d.npy`` files, skips the same unreadable
frame and appends one trailing-comma latency a served frame.
"""

import glob
import json
import os
import shutil

import numpy as np
import pytest
import torch

from gpr_tpu.apps import learn as jlearn
from gpr_tpu.apps import serve as jserve
from gpr_tpu.pipeline import imageio as jio
from gpr_tpu_torch.apps import serve as tserve
from gpr_tpu_torch.utils import config

from test_torch_hmc import _one_torch_thread  # noqa: F401

RTOL = 1e-10
CI_PRIOR = 2.0  # the interval 2 sqrt(k(x, x)) of GaussianKernel(2, 1) with no data
CONFIG_MODEL = {"perform_ar": False, "n_inputModes": 3, "n_outputModes": 2, "ar_n": 1, "ar_p": 2,
                "kernel_string": "GaussianKernel(2, 1,)", "data_noise": 0.01}


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-300))


def us_frame(ph, rng=None):
    yy = np.mgrid[0:8, 0:8][0]
    img = 127 + 100 * np.sin(2 * np.pi * yy / 8 + ph)
    if rng is not None:
        img = img + rng.normal(0, 1, (8, 8))
    return np.clip(img, 0, 255)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """tests/test_serve.py's trained_model: 24 frames, learned by JAX."""
    root = tmp_path_factory.mktemp("serve")
    rng = np.random.default_rng(0)
    (root / "us").mkdir(), (root / "dvf").mkdir()
    for i in range(24):
        ph = 2 * np.pi * i / 8
        jio.write_image(jio.Image(us_frame(ph, rng), (1, 1), (0, 0)), str(root / "us" / f"u{i:05d}.vtk"))
        df = np.stack([np.full((2, 3, 4), np.sin(ph)), np.full((2, 3, 4), np.cos(ph)),
                       np.zeros((2, 3, 4))], axis=-1)
        jio.write_image(jio.Image(df, (1, 1, 1), (0, 0, 0), ncomponents=3), str(root / "dvf" / f"d{i:05d}.vtk"))
    cm, cl = str(root / "cm.json"), str(root / "cl.json")
    for path, cfg in ((cm, CONFIG_MODEL), (cl, {"use_precomputed": False, "n_trainImgs": 0, "start_trainInd": 0})):
        with open(path, "w") as f:
            json.dump(cfg, f)
    prefix = str(root / "gpr")
    assert jlearn.main([cm, cl, prefix, str(root / "us"), str(root / "dvf")]) == 0
    frames = [us_frame(2 * np.pi * i / 8 + 0.3, np.random.default_rng(100 + i)) for i in range(5)]
    return root, prefix, cm, frames


def _port_server(prefix, out_dir, **kw):
    with config.policy_scope("parity"):
        return tserve.Server(CONFIG_MODEL, prefix, str(out_dir), device="cpu", **kw)


@pytest.mark.parametrize("features_only", [False, True])
def test_handle_frame_matches_jax(model, tmp_path, features_only):
    root, prefix, _, frames = model
    js = jserve.Server(CONFIG_MODEL, prefix, str(tmp_path / "jax"), features_only=features_only)
    ts = _port_server(prefix, tmp_path / "port", features_only=features_only)
    assert ts.gp.X.dtype == torch.float64 and ts.device == torch.device("cpu")
    js.warmup(frames[0])
    ts.warmup(frames[0])
    for i, f in enumerate(frames):
        jm, jci, _ = js.handle_frame(f, i)
        tm, tci, dt = ts.handle_frame(f, i)
        _close(tm, jm)
        assert abs(tci - jci) <= RTOL * CI_PRIOR and tci > 0 and dt > 0
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    assert names == ([] if features_only else [f"dvf{i:05d}.npy" for i in range(len(frames))])
    for name in names:
        _close(np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name))
    assert ts.replays == 0  # no graph on the CPU
    packed = ts.run_eager(frames[1])
    assert packed.shape == (CONFIG_MODEL["n_outputModes"] + 1 + (0 if features_only else 72),)


def test_watch_matches_jax(model, tmp_path):
    """Both packages' watch over one directory: the same DVFs, the same
    unreadable frame skipped, one latency a served frame."""
    root, prefix, _, frames = model
    incoming = tmp_path / "incoming"
    incoming.mkdir()
    for i, f in enumerate(frames):
        jio.write_image(jio.Image(f, (1, 1), (0, 0)), str(incoming / f"f{i:05d}.vtk"))
    (incoming / "f00002b.vtk").write_bytes(b"not an image")  # skipped after one retry
    (incoming / "notes.txt").write_text("ignored")
    served = {}
    for name in ("jax", "port"):
        pre = str(tmp_path / name)
        for path in glob.glob(prefix + "-*"):  # the model and PCA files, each package its own copy
            shutil.copy(path, pre + path[len(prefix):])
        if name == "jax":
            server = jserve.Server(CONFIG_MODEL, pre, str(tmp_path / "out-jax"))
            served[name] = jserve.watch(server, str(incoming), poll=0.01, max_frames=10, idle_timeout=0.2)
        else:
            server = _port_server(pre, tmp_path / "out-port")
            served[name] = tserve.watch(server, str(incoming), poll=0.01, max_frames=10, idle_timeout=0.2)
    assert served == {"jax": len(frames), "port": len(frames)}
    names = sorted(os.listdir(tmp_path / "out-port"))
    assert names == sorted(os.listdir(tmp_path / "out-jax")) == [f"dvf{i:05d}.npy" for i in range(len(frames))]
    for n in names:
        _close(np.load(tmp_path / "out-port" / n), np.load(tmp_path / "out-jax" / n))
    text = (tmp_path / "port-latestInferenceTime.txt").read_text()
    assert text.endswith(",") and "\n" not in text
    lat = [float(v) for v in text.split(",")[:-1]]
    assert len(lat) == len(frames) and all(v > 0 for v in lat)
    # a second session appends to the same file
    server = _port_server(str(tmp_path / "port"), tmp_path / "out-port")
    assert tserve.watch(server, str(incoming), poll=0.01, max_frames=2, idle_timeout=0.2) == 2
    assert len((tmp_path / "port-latestInferenceTime.txt").read_text().split(",")[:-1]) == len(frames) + 2


def test_main_cli(model, tmp_path):
    root, prefix, cm, frames = model
    incoming = tmp_path / "in"
    incoming.mkdir()
    for i, f in enumerate(frames[:3]):
        jio.write_image(jio.Image(f, (1, 1), (0, 0)), str(incoming / f"f{i:05d}.vtk"))
    out = tmp_path / "out"
    with config.policy_scope("parity"):
        rc = tserve.main([cm, prefix, str(incoming), str(out), "--poll", "0.01", "--max-frames", "3",
                          "--features-only"], device="cpu")
    assert rc == 0 and os.listdir(out) == []
    assert tserve.main(["only", "three", "args"]) == -1


def test_server_defaults_to_the_card(model, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    _, prefix, _, _ = model
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.Server(CONFIG_MODEL, prefix, str(tmp_path / "o"))
