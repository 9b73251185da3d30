"""The port's study apps and dataset tools against gpr_tpu's, on the CPU.

* The copies (``apps/validate.py``, ``apps/tikz.py``, ``apps/analysis.py``,
  ``data/dicom.py``, ``data/prep.py``) run on the same inputs as gpr_tpu's
  and give identical outputs and identical files, byte for byte.
* ``data/prep.py::create_pairs`` is the port's mended one: under ``ar=True``
  it computes the grouping factor p, moves every p-th CT file and fills the
  AR folders, where gpr_tpu's raises before that code (prep.py:106).  It is
  held to the layout the reference's AR split gives, not to JAX.
* ``apps/drift.py`` and ``apps/experiments.py`` run a small study in both
  packages, the port in float64 (``parity`` policy, ``device="cpu"``):
  percentiles, per-frame statistics and the errbars arrays within rtol 1e-8
  (tests/test_torch_apps.py's bound for learn -> predict), the predicted
  DVFs and the tikz figure's coordinates as well.
* ``utils/profiling.py``: ``StageTimer.csv`` equals JAX's on the same
  stages; ``trace`` writes a Chrome trace; ``device_memory_stats`` is empty
  without a card.
"""

import csv
import json
import os
import re
import shutil

import numpy as np
import pytest
import torch
import yaml

from gpr_tpu.apps import analysis as janalysis
from gpr_tpu.apps import drift as jdrift
from gpr_tpu.apps import experiments as jexp
from gpr_tpu.apps import tikz as jtikz
from gpr_tpu.apps import validate as jvalidate
from gpr_tpu.data import dicom as jdicom
from gpr_tpu.data import prep as jprep
from gpr_tpu.pipeline import imageio as jio
from gpr_tpu.utils import profiling as jprof
from gpr_tpu_torch.apps import analysis as tanalysis
from gpr_tpu_torch.apps import drift as tdrift
from gpr_tpu_torch.apps import experiments as texp
from gpr_tpu_torch.apps import tikz as ttikz
from gpr_tpu_torch.apps import validate as tvalidate
from gpr_tpu_torch.data import dicom as tdicom
from gpr_tpu_torch.data import prep as tprep
from gpr_tpu_torch.utils import config
from gpr_tpu_torch.utils import profiling as tprof

from test_torch_hmc import _one_torch_thread  # noqa: F401

RTOL = 1e-8


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-300))


def _tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _same_trees(a, b):
    ta, tb = _tree(a), _tree(b)
    assert sorted(ta) == sorted(tb)
    for k in ta:
        assert ta[k] == tb[k], k


def _in_both(tmp_path, make):
    """Two identical trees, tmp/jax and tmp/port, made by make(root)."""
    roots = {name: tmp_path / name for name in ("jax", "port")}
    for r in roots.values():
        r.mkdir()
        make(r)
    return roots


# ---------------------------------------------------------------------------
# the copies
# ---------------------------------------------------------------------------

def _dvf_dirs(root, n=4, seed=0):
    rng = np.random.default_rng(seed)
    for name in ("gt", "pred"):
        (root / name).mkdir()
    for i in range(n):
        gt = rng.normal(0, 1, (3, 4, 5, 3))
        pred = gt + rng.normal(0, 0.1, gt.shape)
        pred[0, 0, 0] = gt[0, 0, 0]  # a zero-error voxel row
        jio.write_image(jio.Image(gt, (1, 1, 1), (0, 0, 0), ncomponents=3), str(root / "gt" / f"df{i:03d}.mha"))
        jio.write_image(jio.Image(pred, (1, 1, 1), (0, 0, 0), ncomponents=3), str(root / "pred" / f"p{i:03d}.mha"))
    mask = np.zeros((3, 4, 5))
    mask[1:, 1:, 1:] = 1
    jio.write_image(jio.Image(mask, (1, 1, 1), (0, 0, 0)), str(root / "mask.mha"))
    with open(root / "p-latestInferenceTime.txt", "w") as f:
        f.write("0.1,0.2,0.15,")
    with open(root / "p-latestCompTimePCA.txt", "w") as f:
        f.write("0.01,0.02,0.03,0.04,")


def test_validate_is_a_copy(tmp_path):
    roots = _in_both(tmp_path, _dvf_dirs)
    res = {}
    for name, mod in (("jax", jvalidate), ("port", tvalidate)):
        r = roots[name]
        res[name] = mod.dvf_error(str(r / "gt"), str(r / "pred"), str(r / "mask.mha"), diff_dir=str(r / "diff"))
        res[name + "-ct"] = mod.comp_time(str(r / "p"))
        assert mod.main(["dvf", str(r / "gt"), str(r / "pred")]) == 0
        assert mod.main(["comptime", str(r / "p")]) == 0
        assert mod.main(["bogus"]) == -1 and mod.main([]) == -1
    for key in ("", "-ct"):
        j, t = res["jax" + key], res["port" + key]
        assert sorted(j) == sorted(t)
        for k in j:
            if isinstance(j[k], dict):
                assert j[k] == t[k]
            else:
                np.testing.assert_array_equal(np.asarray(t[k]), np.asarray(j[k]))
    _same_trees(roots["jax"], roots["port"])


def test_tikz_is_a_copy(tmp_path):
    rng = np.random.default_rng(1)
    result = {"errbars": np.sort(rng.uniform(0, 2, (7, 6)), axis=0), "mean_per_frame": rng.uniform(0, 1, 6),
              "median_per_frame": rng.uniform(0, 1, 6)}
    ci = rng.uniform(0, 1, 6)
    assert ttikz.credible_interval_tikz(result["errbars"], result["median_per_frame"], ci) == \
        jtikz.credible_interval_tikz(result["errbars"], result["median_per_frame"], ci)

    def make(r):
        with open(r / "ci.csv", "w") as f:
            f.write("".join(f"{v}," for v in ci))

    roots = _in_both(tmp_path, make)
    for name, mod in (("jax", jtikz), ("port", ttikz)):
        r = roots[name]
        p1 = mod.export_validation_tikz(str(r), result, subdir="test", suffix="a", credible_csv=str(r / "ci.csv"))
        p2 = mod.export_validation_tikz(str(r), result, mask=True, sampling_rate_hz=2.0)
        assert os.path.basename(p1) == "credible_interval_test_a.tex"
        assert os.path.basename(p2) == "credible_interval_test__VOI.tex"
    _same_trees(roots["jax"], roots["port"])


def test_analysis_is_a_copy(tmp_path):
    def make(r):
        (r / "gpr").mkdir(), (r / "vtk").mkdir(), (r / "dvf").mkdir()
        np.savetxt(r / "gpr" / "gpr-inputCompactness.csv", [0.3, 0.6, 0.9, 1.0])
        np.savetxt(r / "gpr" / "gpr-outputCompactness.csv", [0.55, 0.8, 1.0])
        np.savetxt(r / "f.csv", np.random.default_rng(3).standard_normal((4, 12)), delimiter=",")
        for i in range(3):
            img = jio.Image(np.random.default_rng(10 + i).standard_normal((2, 3, 4)), (1, 1, 1), (0, 0, 0))
            jio.write_image(img, str(r / "vtk" / f"v{i}.vtk"))
            d = jio.Image(np.full((2, 2, 2, 3), 1.0 + i), (1, 1, 1), (0, 0, 0), ncomponents=3)
            jio.write_image(d, str(r / "dvf" / f"df{i}.vtk"))

    roots = _in_both(tmp_path, make)
    out = {}
    for name, mod in (("jax", janalysis), ("port", tanalysis)):
        r = roots[name]
        out[name] = (mod.mode_counts(str(r / "gpr"), 0.5), mod.convert_vtk_dir(str(r / "vtk"), str(r / "mha")),
                     mod.feature_trajectories(str(r / "f.csv")), mod.dvf_mean_magnitude(str(r / "dvf")).tolist())
        assert mod.main(["modes", str(r / "gpr"), "--thresh", "0.5"]) == 0
        assert mod.main(["bogus"]) == -1
    assert out["jax"] == out["port"]
    _same_trees(roots["jax"], roots["port"])


def test_dicom_is_a_copy(tmp_path):
    def make(r):
        for sub in ("data", "navi", "scans", "us"):
            (r / sub).mkdir()
        for i in range(1, 7):
            jdicom.write_minimal_dicom(str(r / "data" / f"raw{i:03d}.ima"), instance_number=i)
            jdicom.write_minimal_dicom(str(r / "navi" / f"raw{i:03d}.ima"), instance_number=i,
                                       spacing_between_slices=0.0, image_comments="Navigator")
        for i in range(1, 5):
            jdicom.write_minimal_dicom(str(r / "scans" / f"f{i:02d}.ima"), instance_number=i,
                                       protocol_name="zc_4dmri_prot", series_number=3,
                                       acquisition_number=(i + 1) // 2)
        pix = np.random.default_rng(4).integers(0, 255, (3, 12, 10), dtype=np.uint8)
        for i in range(3):
            jdicom.write_minimal_dicom(str(r / "us" / f"f{i}.dcm"), i + 1, pixel_data=pix[i])

    roots = _in_both(tmp_path, make)
    out = {}
    for name, mod, prep in (("jax", jdicom, jprep), ("port", tdicom, tprep)):
        r = roots[name]
        out[name] = ([os.path.relpath(p, r) for p in mod.preprocess_dicom_dir(str(r / "data"), str(r / "data_mod"),
                                                                               n_slices=3)],
                     [os.path.relpath(p, r) for p in mod.preprocess_dicom_dir(str(r / "navi"), str(r / "navi_mod"),
                                                                               is_navi=True)],
                     mod.create_filestructure(str(r / "scans"), str(r / "struct")),
                     mod.us_video_to_vtk(str(r / "us"), str(r / "us_vtk")),
                     mod.read_pixel_array(str(r / "us" / "f1.dcm")).tolist(),
                     len(prep.load_dicom_series(str(r / "data"), str(r / "data_mod2"), n_slices=2)))
        with pytest.raises(ValueError, match="slice positions"):
            mod.preprocess_dicom_dir(str(r / "data"), str(r / "bad"), n_slices=4)
        shutil.rmtree(r / "bad", ignore_errors=True)
    assert out["jax"] == out["port"]
    _same_trees(roots["jax"], roots["port"])
    assert tdicom.MiniDicom.read(str(roots["port"] / "navi_mod" / "navi00001.dcm")).get(
        tdicom.TAG_SPACING_BETWEEN_SLICES) == 1.0


def _pairs_tree(root, n, ar_pngs=0, offset_rows=0):
    pairs = root / "pairs"
    (pairs / "CT").mkdir(parents=True)
    (pairs / "US").mkdir()
    (pairs / "AR").mkdir()
    rows = [["ct", "us", "x", "ds"]]
    for i in range(n):
        (pairs / "CT" / f"deformationfield_{i:03d}.mha").write_text(f"ct{i}")
        (pairs / "US" / f"us_{i:05d}.png").write_text(f"us{i}")
        rows.append([str(i), str(i), "0", str(i)])
    for i in range(ar_pngs):
        (pairs / "AR" / f"ar_{i:03d}.png").write_text(f"ar{i}")
    with open(pairs / "pairs.csv", "w", newline="") as f:
        csv.writer(f).writerows(rows)
    return pairs


def test_prep_is_a_copy(tmp_path):
    def make(r):
        src = r / "dvf"
        src.mkdir()
        jio.write_image(jio.Image(np.zeros((6, 6, 6, 3)), (1, 1, 1), (0, 0, 0), ncomponents=3),
                        str(src / "a_master.mha"))
        d = np.zeros((6, 6, 6, 3))
        d[2:5, 1:4, 3:6] = 1.0
        jio.write_image(jio.Image(d, (1, 1, 1), (0, 0, 0), ncomponents=3), str(src / "b_field.mha"))
        (r / "us").mkdir(), (r / "blur").mkdir()
        img = np.zeros((9, 9))
        img[4, 4] = 255.0
        jio.write_image(jio.Image(img, (1, 1), (0, 0)), str(r / "blur" / "f.vtk"))
        for i in range(5):
            (r / "us" / f"u{i}.png").write_text(f"u{i}")
            (r / "dvf" / f"d{i}.vtk").write_text(f"d{i}")
        _pairs_tree(r / "moco", 10)

    roots = _in_both(tmp_path, make)
    out = {}
    for name, prep in (("jax", jprep), ("port", tprep)):
        r = roots[name]
        roi = prep.crop_dvf_roi(str(r / "dvf"), str(r / "dvf_crop"))
        prep.blur_us(str(r / "blur"), sigma=1.0)
        counts = prep.split_train_test({"us": str(r / "us"), "dvf": str(r / "dvf")}, 3,
                                       {"us": "png", "dvf": "vtk"})
        prep.create_pairs(str(r / "moco"), split=[4, 2, 3], offset=1, mode=2)
        out[name] = (roi, counts, prep.check_synchro(str(r / "us" / "train"), str(r / "dvf" / "train")))
    assert out["jax"] == out["port"]
    _same_trees(roots["jax"], roots["port"])


@pytest.mark.parametrize("p", [2, 3])
def test_create_pairs_ar_moves_every_pth_ct_and_fills_the_ar_folders(tmp_path, p):
    """split = [AR train, AR test, train, validation, test] = [2, 1, 2, 1, 1]
    sweeps over a pairs.csv of p rows a sweep (mode 1: the US file is named by
    the csv's dataset column)."""
    split = [2, 1, 2, 1, 1]
    n = p * sum(split[2:])
    pairs = _pairs_tree(tmp_path, n, ar_pngs=4)
    tprep.create_pairs(str(tmp_path), split=split, mode=1, ar=True)

    def names(sub):
        return sorted(os.listdir(pairs / sub))

    assert names("AR/train") == ["ar_000.png", "ar_001.png"]
    assert names("AR/test") == ["ar_002.png"]
    assert names("AR") == ["ar_003.png", "test", "train"]
    # every p-th row of the train (rows 0 .. 2p-1) and validation (2p .. 3p-1) sweeps
    assert names("CT/train") == [f"deformationfield_{i:03d}.mha" for i in (0, p)]
    assert names("CT/validation") == [f"deformationfield_{2 * p:03d}.mha"]
    assert names("CT/test") == []
    assert len(os.listdir(pairs / "CT")) == 3 + (n - 3)  # the other CT files stay
    assert names("US/train") == [f"us_{i:05d}.png" for i in range(2 * p)]
    assert names("US/validation") == [f"us_{i:05d}.png" for i in range(2 * p, 3 * p)]
    assert names("US/test") == [f"us_{i:05d}.png" for i in range(3 * p, 4 * p)]
    assert names("US/offset") == []
    # splitting again moves everything back first (create_pairs.py:8-15)
    tprep.create_pairs(str(tmp_path), split=split, mode=1, ar=True)
    assert names("CT/train") == [f"deformationfield_{i:03d}.mha" for i in (0, p)]
    assert names("AR/train") == ["ar_000.png", "ar_001.png"]


def test_create_pairs_ar_checks_the_split(tmp_path):
    _pairs_tree(tmp_path, 7, ar_pngs=1)
    with pytest.raises(ValueError, match="do not fit"):
        tprep.create_pairs(str(tmp_path), split=[1, 1, 2, 1, 1], mode=1, ar=True)
    with pytest.raises(ValueError, match="not correctly defined"):
        tprep.create_pairs(str(tmp_path), split=[2, 1, 1], mode=1, ar=True)
    with pytest.raises(ValueError, match="not correctly defined"):
        tprep.create_pairs(str(tmp_path), split=[1, 1, 2, 1, 1], mode=1)


# ---------------------------------------------------------------------------
# experiments and drift
# ---------------------------------------------------------------------------

def _study(root, n_train=24, n_test=6):
    """tests/test_experiments.py's experiment_tree at a smaller size, its YAML
    config in root/config.yaml."""
    rng = np.random.default_rng(0)
    for split, n, start in (("train", n_train, 0), ("test", n_test, n_train)):
        us, dvf = root / "us" / split, root / "reg3d" / split
        us.mkdir(parents=True)
        dvf.mkdir(parents=True)
        for i in range(n):
            ph = 2 * np.pi * (start + i) / 10.0
            yy = np.mgrid[0:10, 0:10][0]
            frame = np.clip(127 + 100 * np.sin(2 * np.pi * yy / 10 + ph) + rng.normal(0, 1, (10, 10)), 0, 255)
            jio.write_image(jio.Image(frame, (1, 1), (0, 0)), str(us / f"us{i:05d}.vtk"))
            df = np.stack([np.full((3, 4, 5), np.sin(ph)), np.full((3, 4, 5), 0.5 * np.cos(ph)),
                           np.full((3, 4, 5), 0.2 * np.sin(ph))], axis=-1) + rng.normal(0, 0.003, (3, 4, 5, 3))
            jio.write_image(jio.Image(df, (1, 1, 1), (0, 0, 0), ncomponents=3), str(dvf / f"df{i:05d}.vtk"))
    jio.write_image(jio.Image(np.zeros((3, 4, 5, 3)), (1, 1, 1), (0, 0, 0), ncomponents=3),
                    str(root / "master.vtk"))
    cfg = {
        "options": {"regression": True, "evaluation": True},
        "general": {"root_dir": str(root), "surrogate_dir": "us", "registration_dir": "reg3d",
                    "master_volume": "master.vtk"},
        "gpr_model": {"perform_ar": False, "n_inputModes": 4, "n_outputModes": 3, "ar_n": 1, "ar_p": 2,
                      "kernel_string": "GaussianKernel(2, 1,)", "data_noise": 0.01, "subdir": "test"},
        "gpr_learn": {"use_precomputed": False, "n_trainImgs": 0, "start_trainInd": 0},
        "gpr_predict": {"use_precomputed": False, "compute_groundtruth_features": False},
    }
    with open(root / "config.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    return cfg


DRIFT = {"n_train": 16, "starts": [0, 6]}


@pytest.fixture(scope="module")
def jax_study(tmp_path_factory):
    """The study run once by gpr_tpu: run_experiment, then drift.main."""
    root = tmp_path_factory.mktemp("study_jax")
    _study(root)
    assert jexp.run_experiment(str(root / "config.yaml")) == 0
    assert jdrift.main([str(root / "config.yaml"), str(DRIFT["n_train"]),
                        ",".join(map(str, DRIFT["starts"]))]) == 0
    return root


def _coords(tex):
    return np.array([float(v) for v in re.findall(r"\(([-\d.e+]+),", tex)]
                    + [float(v) for v in re.findall(r",([-\d.e+]+)\)", tex)])


def test_experiment_matches_jax(jax_study, tmp_path):
    root = tmp_path / "study"
    root.mkdir()
    _study(root)
    timer = tprof.StageTimer()
    with config.policy_scope("parity"):
        with open(root / "config.yaml") as f:
            cfg = yaml.safe_load(f)
        assert texp.run_experiment_config(cfg, str(root), device="cpu", timer=timer) == 0
    assert [name for name, _ in timer.stages] == ["learn", "predict", "evaluation"]
    with open(root / "evaluation.json") as f, open(jax_study / "evaluation.json") as g:
        ev, jev = json.load(f), json.load(g)
    assert sorted(ev) == sorted(jev) == ["50", "75", "90", "95", "99"]
    _close([ev[k] for k in sorted(ev)], [jev[k] for k in sorted(jev)])
    for name in ("errbars.npy", "errbars_mean.npy"):
        _close(np.load(root / name), np.load(jax_study / name))
    tex, jtex = ((r / "credible_interval_test_.tex").read_text() for r in (root, jax_study))
    assert re.sub(r"[-\d.e+]+", "#", tex) == re.sub(r"[-\d.e+]+", "#", jtex)
    _close(_coords(tex), _coords(jtex), rtol=1e-5)  # printed at 6 significant digits
    preds = sorted(os.listdir(root / "reg3d" / "test_pred"))
    assert preds == sorted(os.listdir(jax_study / "reg3d" / "test_pred")) == [f"dfPred{i:05d}.vtk" for i in range(6)]
    for p in preds:
        _close(jio.read_image(str(root / "reg3d" / "test_pred" / p)).data,
               jio.read_image(str(jax_study / "reg3d" / "test_pred" / p)).data)


def test_drift_matches_jax(jax_study, tmp_path):
    root = tmp_path / "study"
    root.mkdir()
    _study(root)
    with config.policy_scope("parity"):
        assert tdrift.main([str(root / "config.yaml"), str(DRIFT["n_train"]),
                            ",".join(map(str, DRIFT["starts"]))], device="cpu") == 0
    with open(root / "drift.json") as f, open(jax_study / "drift.json") as g:
        got, want = json.load(f), json.load(g)
    assert sorted(got) == sorted(want) == ["win0000", "win0006"]
    for tag in want:
        assert (got[tag]["start"], got[tag]["n_train"]) == (want[tag]["start"], want[tag]["n_train"])
        p, q = got[tag]["percentiles"], want[tag]["percentiles"]
        assert sorted(p) == sorted(q)
        _close([p[k] for k in sorted(p)], [q[k] for k in sorted(q)])
        _close(got[tag]["median_per_frame"], want[tag]["median_per_frame"])


def test_drift_config_takes_the_parsed_dict(tmp_path):
    root = tmp_path / "study"
    root.mkdir()
    cfg = _study(root, n_train=12, n_test=4)
    timer = tprof.StageTimer()
    with config.policy_scope("parity"):
        res = tdrift.run_drift_config(cfg, str(root), 10, [2], device="cpu", timer=timer)
    assert list(res) == ["win0002"] and res["win0002"]["percentiles"]["50"] < 0.1
    assert [n for n, _ in timer.stages] == ["win0002 learn", "win0002 predict", "win0002 validate"]


def test_experiment_preprocessing_split_and_external_stages(tmp_path):
    """The DICOM stage, the sweep split and a stub external stage through the
    port's main, in dir mode; a failing stage's code comes back."""
    root = tmp_path / "study"
    (root / "data").mkdir(parents=True)
    for i in range(1, 5):
        tdicom.write_minimal_dicom(str(root / "data" / f"raw{i:03d}.ima"), instance_number=i)
    (root / "us").mkdir()
    for i in range(5):
        (root / "us" / f"{i:05d}.png").write_text(str(i))
    marker = tmp_path / "ran.txt"
    stub = tmp_path / "stub.sh"
    stub.write_text(f"#!/bin/sh\necho yes > {marker}\n")
    stub.chmod(0o755)
    cfg = {"options": {"preprocessing": True, "stacking": True, "splitting_data": True},
           "exe": {"stacking": str(stub)},
           "general": {"root_dir": str(root), "n_slices": 2, "surrogate_type": 1, "n_training_sweeps": 1,
                       "surrogate_dir": "us", "registration_dir": "reg3d"}}
    (root / "reg3d").mkdir()
    cdir = tmp_path / "configs"
    cdir.mkdir()
    with open(cdir / "a.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    assert texp.main([str(cdir)], device="cpu") == 0
    assert marker.exists()
    assert sorted(os.listdir(root / "data_mod" / "sorted")) == ["slice01", "slice02"]
    assert sorted(os.listdir(root / "us" / "train")) == ["00000.png", "00001.png"]
    assert len(os.listdir(root / "us" / "test")) == 3
    stub.write_text("#!/bin/sh\nexit 3\n")
    assert texp.main([str(cdir / "a.yaml")], device="cpu") == 3
    assert texp.main([]) == -1 and tdrift.main(["x"]) == -1


def test_study_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    root = tmp_path / "study"
    root.mkdir()
    cfg = _study(root, n_train=12, n_test=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdrift.run_drift_config(cfg, str(root), 10, [0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        texp.run_experiment_config(cfg, str(root))


# ---------------------------------------------------------------------------
# utils/profiling.py
# ---------------------------------------------------------------------------

def test_stage_timer_csv_equals_jax(tmp_path):
    stages = [("parse", 0.125), ("pca", 1e-3), ("parse", 2.5), ("fit", 0.1 + 0.2)]
    t, j = tprof.StageTimer(), jprof.StageTimer()
    t.stages, j.stages = list(stages), list(stages)
    assert t.csv() == j.csv() == "0.125,0.001,2.5,0.30000000000000004,"
    assert t.totals() == j.totals() == {"parse": 2.625, "pca": 1e-3, "fit": 0.1 + 0.2}
    t.write(str(tmp_path / "t.txt"))
    j.write(str(tmp_path / "j.txt"))
    t.write(str(tmp_path / "t.txt"))
    j.write(str(tmp_path / "j.txt"))
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    timer = tprof.StageTimer()
    with pytest.raises(KeyError):
        with timer.stage("fails"):
            raise KeyError("x")
    assert [n for n, _ in timer.stages] == ["fails"] and timer.stages[0][1] >= 0


def test_trace_and_memory_stats(tmp_path):
    with tprof.trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    stats = tprof.device_memory_stats()
    if not torch.cuda.is_available():
        assert stats == {}
    else:
        assert all(set(v) == {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"} for v in stats.values())
